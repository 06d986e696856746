"""Bound of the mel front end (``csrc/mel.cu``, #1) on B clips of Lp padded
samples and T frames, as ``chip_smoke.py`` counts it: the samples, the
nonzero band weights and the output once (f32); a frame's window, an n/2
point complex FFT (5 n/2 log2(n/2)), the real split, the magnitudes and the
bands. f32 peak: the kernel runs in f32 outside the tensor cores."""

from __future__ import annotations

import math

import numpy as np

from benchmark.harness.peaks import F32_FLOPS, bound_s
from benchmark.reference.dsp import mel_basis


def bound(snd: dict, B: int, Lp: int, T: int) -> float:
    N, F = snd["Frame_Length"], snd["Frame_Length"] // 2 + 1
    nnz = int(np.count_nonzero(mel_basis(snd["Sample_Rate"], N, snd["Mel_Dim"],
                                         float(snd["Mel_F_Min"]), snd["Mel_F_Max"])))
    half = max(N // 2, 2)
    return bound_s(4 * (B * Lp + nnz + B * T * snd["Mel_Dim"]),
                   B * T * (N + 5 * half * math.log2(half) + 10 * half + 3 * F + 2 * nnz),
                   F32_FLOPS)
