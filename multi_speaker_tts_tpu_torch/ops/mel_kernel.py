"""Fused mel front-end: waveform -> normalized log-mel, a Hopper kernel.

Replaces ``multi_speaker_tts_tpu/ops/mel_kernel.py::melspectrogram_pallas``
(kernel body ``_mel_kernel``). Preemphasis and reflect padding stay plain
torch, as they stay XLA in the JAX package; the kernel
(``csrc/mel.cu``) reads overlapping frames straight from the padded
signal and runs one block a frame: the Hann window, the frame's real
transform in f32, the magnitudes, each mel band's nonzero bins
(:func:`mel_bands`) and the log/normalisation. The transform is an
in-block radix-2 FFT (twiddles from :func:`twiddles`) for an n_fft that is
a power of two and a direct DFT against a table of cos / sin(2 pi m / N)
(:func:`dft_table`) for any other; :func:`melspectrogram_kernel` picks the
route on the host and counts the DFT route's launches as
:data:`DFT_KERNEL`. It takes any n_fft that hop divides
(:func:`mel_shape_reason`), every frame the JAX rule sends to its kernel:
a power of two from 4 up takes the FFT route, any other n_fft the DFT
route. Where a route's frame, table and bins outgrow a block's shared
memory (:func:`smem_bytes`: the FFT past n_fft 16384 on an H100, the DFT
past 16603), the route runs in its global-memory mode
(:func:`plan`; counted as :data:`FFT_GLOBAL_KERNEL` /
:data:`DFT_GLOBAL_KERNEL`) on a scratch the wrapper allocates.

:func:`melspectrogram_plain` is the same function in plain torch, a
windowed-DFT matmul (f32, no TF32): the CPU path, and the card's
yardstick.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.audio.mel_filterbank import mel_filterbank
from multi_speaker_tts_tpu_torch.ops import _build

_ARGS = [
    _build.P, _build.P, _build.P, _build.P, _build.P,  # y_pad, window, table, bands, weights
    _build.P, _build.P, _build.I,  # out, scratch, global_mode
    _build.I, _build.I, _build.I, _build.I, _build.I, _build.I,  # B, T, Lp, n_fft, hop, M
    ctypes.c_float, ctypes.c_float,  # ref_level_db, min_level_db
    _build.P,  # stream
]
KERNEL = _build.Kernel("mel_frontend", "mel.cu", {"mstts_mel_frontend": _ARGS})
DFT_KERNEL = _build.Kernel("mel_frontend_dft", "mel.cu", {"mstts_mel_dft": _ARGS})
# The routes' global-memory modes (past a block's shared memory).
FFT_GLOBAL_KERNEL = _build.Kernel("mel_frontend_global", "mel.cu", {"mstts_mel_frontend": _ARGS})
DFT_GLOBAL_KERNEL = _build.Kernel("mel_frontend_dft_global", "mel.cu", {"mstts_mel_dft": _ARGS})
_AMP_FLOOR = 1e-5


@functools.lru_cache(maxsize=4)
def _operands_basis(sample_rate: int, n_fft: int, n_mels: int, f_min: float,
                    f_max: float | None) -> np.ndarray:
    """The mel basis transposed to (F, M), f32."""
    return np.ascontiguousarray(mel_filterbank(sample_rate, n_fft, n_mels, f_min, f_max).T,
                                np.float32)


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
    return dft.astype(np.float32), _operands_basis(sample_rate, n_fft, n_mels, f_min, f_max)


def mel_shape_reason(n_fft: int, hop: int) -> str | None:
    """Why ``csrc/mel.cu`` does not take this frame, or None if it does:
    hop dividing n_fft (the TPU kernel's k = n_fft // hop frames a hop),
    any n_fft (:func:`plan` picks the route and its mode)."""
    if n_fft < 1 or hop < 1 or n_fft % hop:
        return f"needs hop dividing n_fft, got n_fft = {n_fft}, hop = {hop}"
    return None


def is_pow2(n: int) -> bool:
    """Whether the FFT route takes this n_fft (else the DFT route): a power
    of two from 4 up (an n_fft / 2-point complex FFT of at least one
    butterfly)."""
    return n >= 4 and not n & (n - 1)


def _padded(p: int) -> int:
    return p + p // 16  # csrc/mel.cu's padded(): one element every 16


def smem_bytes(n_fft: int) -> int:
    """``mel_smem_bytes`` (csrc/mel.cu): a block's shared memory on the
    route of this n_fft (FFT: points and twiddles padded one in 16, the
    bins; DFT: the table, the windowed frame, the bins)."""
    if is_pow2(n_fft):
        nh = n_fft // 2
        return 2 * 8 * _padded(nh) + 4 * (nh + 1)
    return 12 * n_fft + 4 * (n_fft // 2 + 1)


def scratch_floats(n_fft: int) -> int:
    """f32 a frame of a global-memory mode's scratch: the FFT's padded
    points and its bins (to a multiple of 4), the DFT's bins."""
    if is_pow2(n_fft):
        nh = n_fft // 2
        return 2 * _padded(nh) + _build.round_up(nh + 1, 4)
    return n_fft // 2 + 1


def plan(n_fft: int, card: tuple[int, int] = _build.H100) -> tuple[str, bool]:
    """The route ("fft" or "dft") of this n_fft and whether it runs in its
    global-memory mode on ``card`` (SMs, opt-in bytes a block): when its
    block would not fit the card's shared memory."""
    return ("fft" if is_pow2(n_fft) else "dft"), smem_bytes(n_fft) > card[1]


def dft_table(n_fft: int) -> np.ndarray:
    """(cos, -sin)(2 pi m / n_fft) for m < n_fft as (n_fft, 2) f32, computed
    in f64: the DFT route's table, read at index (n k) mod n_fft."""
    ang = -2.0 * np.pi * np.arange(n_fft, dtype=np.float64) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1).astype(np.float32)


def twiddles(n_fft: int) -> np.ndarray:
    """exp(-2 pi i k / n_fft) for k < n_fft / 2 as (n_fft / 2, 2) f32 [re, im],
    computed in f64: the FFT's twiddles and the real transform's split (the
    first half of :func:`dft_table`)."""
    return dft_table(n_fft)[:n_fft // 2]


def mel_bands(basis: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each band's nonzero bins of an (M, F) mel basis: (M, 3) int32 rows
    [lo, hi, offset], the band's first nonzero bin, one past its last (0, 0
    for an all-zero band) and where its values basis[m, lo:hi] start in the
    packed f32 weights, the second result. Only exact zeros are skipped:
    the bins between lo and hi are kept as they are."""
    bands, weights, offset = [], [], 0
    for row in basis:
        nz = np.flatnonzero(row)
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 0)
        bands.append((lo, hi, offset))
        weights.append(row[lo:hi])
        offset += hi - lo
    return (np.asarray(bands, np.int32).reshape(-1, 3),
            np.concatenate(weights).astype(np.float32))


@functools.lru_cache(maxsize=8)
def _fft_operands(cfg, device: torch.device) -> tuple[torch.Tensor, ...]:
    """The kernel's constant operands: window, the route's table (the FFT's
    twiddles or the DFT's), bands, weights."""
    bands, weights = mel_bands(mel_filterbank(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                              cfg.f_min, cfg.f_max))
    table = twiddles(cfg.n_fft) if is_pow2(cfg.n_fft) else dft_table(cfg.n_fft)
    return tuple(torch.from_numpy(a).to(device) for a in (
        dsp.hann_window(cfg.n_fft), table, bands, weights))


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


# Past this n_fft the plain version's DFT table (n_fft x (n_fft / 2 + 1) x 2
# f32: 268 MB at 8192, 1.1 GB at 16384) gives way to an f32 rfft.
PLAIN_DFT_MAX = 8192


def melspectrogram_plain(y_pad: torch.Tensor, T: int, cfg) -> torch.Tensor:
    """The kernel's function in plain torch, f32: the windowed-DFT matmul
    (the TPU kernel's formulation) up to n_fft :data:`PLAIN_DFT_MAX`, an
    rfft of the windowed frames past it."""
    frames = y_pad.unfold(-1, cfg.n_fft, cfg.hop)[:, :T, :]
    if cfg.n_fft > PLAIN_DFT_MAX:
        basis_t = torch.from_numpy(_operands_basis(cfg.sample_rate, cfg.n_fft, cfg.n_mels,
                                                   cfg.f_min, cfg.f_max)).to(y_pad.device)
        win = torch.from_numpy(dsp.hann_window(cfg.n_fft)).to(y_pad.device)
        mag = torch.fft.rfft(frames * win).abs()
    else:
        dft, basis_t = _device_operands(cfg, y_pad.device)
        re = frames @ dft[..., 0]
        im = frames @ dft[..., 1]
        mag = torch.sqrt(re * re + im * im)
    mel = mag @ basis_t
    db = 20.0 * torch.log10(torch.clamp(mel, min=_AMP_FLOOR)) - cfg.ref_level_db
    return torch.clamp((db - cfg.min_level_db) / (-cfg.min_level_db), 0.0, 1.0)


def melspectrogram_kernel(y_pad: torch.Tensor, T: int, cfg) -> torch.Tensor:
    """Launch ``csrc/mel.cu`` on a CUDA padded signal -> (B, T, n_mels): the
    FFT route for an n_fft that is a power of two, else the DFT route."""
    _build.require_cuda(y_pad, torch.float32, "y_pad")
    reason = mel_shape_reason(cfg.n_fft, cfg.hop)
    if reason is not None:
        raise ValueError(f"mel kernel {reason}")
    B, Lp = y_pad.shape
    if T < 1 or Lp < (T - 1) * cfg.hop + cfg.n_fft:
        raise ValueError(f"padded signal of {Lp} samples holds < {T} frames")
    window, table, bands, weights = _fft_operands(cfg, y_pad.device)
    out = torch.empty((B, T, cfg.n_mels), dtype=torch.float32, device=y_pad.device)
    route, global_mode = plan(cfg.n_fft, _build.card_limits(y_pad.device))
    scratch = (torch.empty(B * T * scratch_floats(cfg.n_fft), dtype=torch.float32,
                           device=y_pad.device) if global_mode else None)
    kernel = {("fft", False): KERNEL, ("dft", False): DFT_KERNEL,
              ("fft", True): FFT_GLOBAL_KERNEL, ("dft", True): DFT_GLOBAL_KERNEL}[
                  route, global_mode]
    kernel.call(
        "mstts_mel_frontend" if route == "fft" else "mstts_mel_dft", y_pad.data_ptr(),
        window.data_ptr(), table.data_ptr(), bands.data_ptr(), weights.data_ptr(),
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), int(global_mode),
        B, T, Lp, cfg.n_fft, cfg.hop, cfg.n_mels, cfg.ref_level_db, cfg.min_level_db,
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
