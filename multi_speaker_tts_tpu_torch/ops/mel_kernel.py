"""Fused mel front-end: waveform -> normalized log-mel, a Hopper kernel.

Replaces ``multi_speaker_tts_tpu/ops/mel_kernel.py::melspectrogram_pallas``
(kernel body ``_mel_kernel``). Preemphasis and reflect padding stay plain
torch, as they stay XLA in the JAX package; the kernel
(``csrc/mel.cu``) reads overlapping frames straight from the padded
signal, multiplies them by the windowed DFT (f32 FMAs, no TF32),
takes the magnitude, applies the mel basis and the log/normalisation.

:func:`melspectrogram_plain` is the same function in plain torch: the CPU
path, and the card's yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.audio.mel_filterbank import mel_filterbank
from multi_speaker_tts_tpu_torch.ops import _build

KERNEL = _build.Kernel("mel_frontend", "mel.cu", {
    "mstts_mel_frontend": [
        _build.P, _build.P, _build.P, _build.P,  # y_pad, dft, basis_t, out
        _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,
        _build.I,  # B, T, Lp, n_fft, hop, F, M
        ctypes.c_float, ctypes.c_float,  # ref_level_db, min_level_db
        _build.P,  # stream
    ],
})
_AMP_FLOOR = 1e-5


@functools.lru_cache(maxsize=4)
def _operands(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
              f_max: float | None) -> tuple[np.ndarray, np.ndarray]:
    """Windowed rDFT as interleaved (n_fft, F, 2) [cos, -sin] (window
    folded in, computed in f64) and the mel basis transposed to (F, M)."""
    F = n_fft // 2 + 1
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(F, dtype=np.float64)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    win = dsp.hann_window(n_fft).astype(np.float64)[:, None]
    dft = np.stack([win * np.cos(ang), win * np.sin(ang)], axis=-1)
    basis_t = mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max).T
    return dft.astype(np.float32), np.ascontiguousarray(basis_t, np.float32)


@functools.lru_cache(maxsize=8)
def _device_operands(cfg, device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    dft, basis_t = _operands(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                             cfg.f_min, cfg.f_max)
    return (torch.from_numpy(dft).to(device),
            torch.from_numpy(basis_t).to(device))


def _pad_signal(wav: torch.Tensor, cfg) -> tuple[torch.Tensor, int]:
    """(B, L) -> preemphasised, reflect-padded (B, L + n_fft) and T."""
    if wav.ndim != 2 or wav.shape[-1] % cfg.hop != 0:
        raise ValueError(
            f"front-end takes (B, L) with L a multiple of hop={cfg.hop}, "
            f"got {tuple(wav.shape)}"
        )
    y = dsp.preemphasis(wav.float(), cfg.preemphasis)
    y = dsp.reflect_pad(y, cfg.n_fft // 2, cfg.n_fft // 2)
    return y.contiguous(), 1 + wav.shape[-1] // cfg.hop


def melspectrogram_plain(y_pad: torch.Tensor, T: int, cfg) -> torch.Tensor:
    """The kernel's arithmetic in plain torch (f32 matmuls)."""
    dft, basis_t = _device_operands(cfg, y_pad.device)
    frames = y_pad.unfold(-1, cfg.n_fft, cfg.hop)[:, :T, :]
    re = frames @ dft[..., 0]
    im = frames @ dft[..., 1]
    mel = torch.sqrt(re * re + im * im) @ basis_t
    db = 20.0 * torch.log10(torch.clamp(mel, min=_AMP_FLOOR)) - cfg.ref_level_db
    return torch.clamp((db - cfg.min_level_db) / (-cfg.min_level_db), 0.0, 1.0)


def melspectrogram_kernel(y_pad: torch.Tensor, T: int, cfg) -> torch.Tensor:
    """Launch ``csrc/mel.cu`` on a CUDA padded signal -> (B, T, n_mels)."""
    _build.require_cuda(y_pad, torch.float32, "y_pad")
    dft, basis_t = _device_operands(cfg, y_pad.device)
    B, Lp = y_pad.shape
    if Lp < (T - 1) * cfg.hop + cfg.n_fft:
        raise ValueError(f"padded signal of {Lp} samples holds < {T} frames")
    out = torch.empty((B, T, cfg.n_mels), dtype=torch.float32,
                      device=y_pad.device)
    KERNEL.call(
        "mstts_mel_frontend", y_pad.data_ptr(), dft.data_ptr(),
        basis_t.data_ptr(), out.data_ptr(), B, T, Lp, cfg.n_fft, cfg.hop,
        dft.shape[1], cfg.n_mels, cfg.ref_level_db, cfg.min_level_db,
        _build.stream_ptr(y_pad),
    )
    return out


def melspectrogram_fused(wav: torch.Tensor, cfg) -> torch.Tensor:
    """(B, L) waveform -> (B, 1 + L/hop, n_mels) normalized log-mel: the
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    y_pad, T = _pad_signal(wav, cfg)
    if y_pad.is_cuda:
        return melspectrogram_kernel(y_pad, T, cfg)
    return melspectrogram_plain(y_pad, T, cfg)
