"""Bound of the staged Griffin-Lim kernel (``csrc/griffin_lim.cu``, #4) on
one batch: the frames of each row's decoded length, ``Griffin_Lim_Iter``
iterations and the final inverse (n_iter + 0.5 forward-inverse pairs), the
staged transform's n_fft^2 operations a frame a pair (32 products of 128 x
128 at n_fft 1024, as ``chip_smoke.py`` counts them); each target magnitude
read once (f32), each output sample written once (f32), the bf16 transform
tables once. bf16 peak."""

from __future__ import annotations

from benchmark.harness.peaks import BF16_FLOPS, bound_s


def batch_bound_s(hp: dict, batch: dict) -> float:
    snd = hp["Sound"]
    n_fft, hop, n_iter = snd["Frame_Length"], snd["Frame_Shift"], snd["Griffin_Lim_Iter"]
    frames = sum(batch["frames"])
    n_bytes = (4 * frames * (n_fft // 2 + 1) + 4 * sum(max(f - 1, 1) for f in batch["frames"]) * hop
               + 2 * 2 * n_fft * (n_fft // 2 + 1))
    return bound_s(n_bytes, (n_iter + 0.5) * frames * n_fft * n_fft, BF16_FLOPS)
