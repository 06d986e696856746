"""GEMM-form STFT / ISTFT / Griffin-Lim (port of ``ops/stft_matmul.py``).

The rDFT of a frame is a matmul against windowed cos/sin matrices and
framing / overlap-add are k = n_fft/hop shifted views, as in the JAX
module. :func:`griffin_lim_matmul` is the plain f32 reference iteration
(zero initial phase, reflect-padded re-framing, optional warm start), the
path the JAX package takes off the TPU. :func:`griffin_lim_auto` is the
vocoder's device dispatch, by the JAX package's rule (:func:`gl_route`):
an eligible CUDA tensor goes to the staged kernel
(:mod:`.griffin_lim_staged`, n_fft = 1024) or the dense kernel
(:mod:`.griffin_lim_kernel`, other sizes or ``GL_DENSE_KERNEL`` set)
wherever the JAX package's own cap for that kernel
(:func:`reference_gl_max_batch`) takes min(B, 8) rows, in batch chunks
that keep the kernel's working set inside the card's L2; any other tensor
takes :func:`griffin_lim_matmul` (the GEMM route; on the CPU that is what
the JAX package runs too).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch.audio.dsp import log_dispatch, reflect_pad


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward rDFT as two real matrices Wr, Wi: (n_fft, n_fft//2+1)."""
    F = n_fft // 2 + 1
    n = np.arange(n_fft)[:, None]
    k = np.arange(F)[None, :]
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _idft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Inverse rDFT as two real matrices Vr, Vi: (n_fft//2+1, n_fft), with
    hermitian weights 2 except DC and Nyquist, and the 1/N scaling."""
    F = n_fft // 2 + 1
    k = np.arange(F)[:, None]
    n = np.arange(n_fft)[None, :]
    ang = 2.0 * np.pi * k * n / n_fft
    w = np.full((F, 1), 2.0)
    w[0] = 1.0
    if n_fft % 2 == 0:
        w[-1] = 1.0
    Vr = (w * np.cos(ang) / n_fft).astype(np.float32)
    Vi = (-w * np.sin(ang) / n_fft).astype(np.float32)
    return Vr, Vi


def _hann(n_fft: int) -> np.ndarray:
    n = np.arange(n_fft, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / n_fft)).astype(np.float32)


def _tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device)


def frame_strided(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered framing via k = n_fft/hop shifted views: (..., L) ->
    (..., T, n_fft) with T = 1 + L/hop. Requires hop | n_fft and hop | L."""
    if n_fft % hop or wav.shape[-1] % hop:
        raise ValueError("strided framing requires hop | n_fft and hop | L")
    k = n_fft // hop
    T = 1 + wav.shape[-1] // hop
    padded = reflect_pad(wav, n_fft // 2, n_fft // 2 + hop)
    rows = padded.reshape(*wav.shape[:-1], -1, hop)
    return torch.cat([rows[..., i:i + T, :] for i in range(k)], dim=-1)


@functools.lru_cache(maxsize=16)
def _wsum(n_fft: int, hop: int, T: int) -> np.ndarray:
    """Window-square OLA normalizer over the (T + k - 1) * hop samples."""
    k = n_fft // hop
    wsq = (_hann(n_fft).astype(np.float64) ** 2).reshape(k, hop)
    acc = np.zeros((T + k - 1, hop), np.float32)  # f32 sums, as the JAX module
    for i in range(k):
        acc[i:i + T] += wsq[i]
    return acc.reshape(-1)


def overlap_add(frames: torch.Tensor, n_fft: int, hop: int,
                length: int) -> torch.Tensor:
    """Windowed overlap-add via k shifted adds: (..., T, n_fft) ->
    (..., length), window-square normalized, centered crop."""
    k = n_fft // hop
    T = frames.shape[-2]
    parts = (frames * _tensor(_hann(n_fft), frames)).reshape(
        *frames.shape[:-1], k, hop)
    acc = frames.new_zeros((*frames.shape[:-2], T + k - 1, hop))
    for i in range(k):
        acc[..., i:i + T, :] += parts[..., i, :]
    out = acc.reshape(*frames.shape[:-2], -1)
    out = out / torch.clamp(_tensor(_wsum(n_fft, hop, T), out), min=1e-11)
    start = n_fft // 2
    return out[..., start:start + length]


def griffin_lim_matmul(magnitude: torch.Tensor, n_fft: int, hop: int,
                       n_iter: int, length: int, momentum: float = 0.0,
                       init_head: torch.Tensor | None = None,
                       init_head_gate=None) -> torch.Tensor:
    """Griffin-Lim with every transform an f32 matmul: (..., T, F) ->
    (..., length). Zero initial phase; ``momentum`` > 0 is the accelerated
    variant of Perraudin et al. 2013.

    ``init_head`` (..., L) warm-starts the iteration: the first L samples
    of the initial waveform are the caller's (the previous streaming
    window's converged audio over the overlap) instead of the zero-phase
    inverse; ``init_head_gate`` (0 / 1, a bool, float or tensor) blends it
    in, so the first window can keep the zero-phase start."""
    mag = magnitude.float()
    T = mag.shape[-2]
    win = _tensor(_hann(n_fft), mag)
    Wr, Wi = (_tensor(m, mag) for m in _dft_matrices(n_fft))
    Vr, Vi = (_tensor(m, mag) for m in _idft_matrices(n_fft))

    def istft_from(re, im):
        return overlap_add(re @ Vr + im @ Vi, n_fft, hop, length)

    def stft_of(y):
        frames = frame_strided(y, n_fft, hop)[..., :T, :] * win
        return frames @ Wr, frames @ Wi

    y = istft_from(mag, torch.zeros_like(mag))
    if init_head is not None:
        L = init_head.shape[-1]
        head = init_head.float()
        if init_head_gate is not None:
            g = torch.as_tensor(init_head_gate, dtype=torch.float32, device=y.device)
            head = g * head + (1.0 - g) * y[..., :L]
        y = torch.cat([head, y[..., L:]], dim=-1)
    if momentum > 0.0:
        beta = momentum / (1.0 + momentum)
        pre, pim = torch.zeros_like(mag), torch.zeros_like(mag)
        for _ in range(n_iter):
            re, im = stft_of(y)
            ere, eim = re - beta * pre, im - beta * pim
            scale = mag / torch.clamp(torch.sqrt(ere * ere + eim * eim + 1e-12), min=1e-11)
            y, pre, pim = istft_from(ere * scale, eim * scale), re, im
        return y
    for _ in range(n_iter):
        re, im = stft_of(y)
        scale = mag / torch.clamp(torch.sqrt(re * re + im * im + 1e-12), min=1e-11)
        y = istft_from(re * scale, im * scale)
    return y


# Bytes of one kernel call's working set: inside the H100's 50 MB L2.
GL_L2_BUDGET_BYTES = 40 << 20
# Where not one row fits that budget beside the dense kernel's matrices (from
# n_fft 3328; at 3072 past T 136), they stream from device memory at any chunk: its
# calls are then sized by the scratch they take on the card instead.
GL_SCRATCH_BUDGET_BYTES = 1 << 30


def reference_gl_max_batch(T: int, n_fft: int, hop: int, momentum: float = 0.0,
                           staged: bool = False) -> int:
    """The JAX package's cap on the rows of one Griffin-Lim kernel call
    (``stft_matmul._pallas_gl_max_batch``, a model of a TPU's 16 MB
    scoped-VMEM stack calibrated on a v5e), copied: its dispatch launches a
    kernel only where this is at least min(B, 8), and so does
    :func:`gl_route`. It says nothing of the H100: the port chunks by
    :func:`gl_max_batch`."""
    Fp = ((n_fft // 2 + 127) // 128) * 128 + 128
    scale = (T * Fp) / (1000.0 * 640.0)
    if staged:
        base_mb = (14.35 if momentum > 0.0 else 12.2) * scale
    else:
        base_mb = 14.92 * scale
        if momentum > 0.0:
            base_mb *= 1.6
    return int((16.0 - 0.5 - base_mb) / 0.0306)


def gl_route(ndim: int, n_fft: int, hop: int, T: int, length: int, on_card: bool,
             B: int, momentum: float) -> str:
    """The JAX package's Griffin-Lim dispatch (``stft_matmul.griffin_lim_auto``)
    as a pure function of a call over B rows: ``"staged"`` or ``"dense"``
    for a tensor on the card that a kernel takes (batched 3-D magnitudes,
    hop | n_fft with an even n_fft / hop, a 128-multiple hop, the default
    length hop * (T - 1)) and whose kernel's cap
    (:func:`reference_gl_max_batch`) is at least min(B, 8) rows: at
    n_fft = 1024 the staged kernel unless ``GL_DENSE_KERNEL`` is set (or
    its cap is no higher than the dense one's), the dense kernel otherwise
    (at any n_fft); ``"gemm"``
    (:func:`griffin_lim_matmul`) for everything else, e.g. at n_fft 1024 /
    hop 256 two rows or more from T 1266 and every B from T 1268, at
    4096 / 512 three rows or more from T 304 and every B from T 305."""
    eligible = (
        on_card
        and ndim == 3
        and n_fft % hop == 0
        and (n_fft // hop) % 2 == 0
        and hop % 128 == 0
        and length == hop * (T - 1)
    )
    if not eligible:
        return "gemm"
    kind, cap = "dense", reference_gl_max_batch(T, n_fft, hop, momentum)
    if n_fft == 1024 and not os.environ.get("GL_DENSE_KERNEL"):
        staged_cap = reference_gl_max_batch(T, n_fft, hop, momentum, staged=True)
        if staged_cap > cap:
            kind, cap = "staged", staged_cap
    return kind if cap >= min(B, 8) else "gemm"


def gl_max_batch(T: int, n_fft: int = 1024, momentum: float = 0.0,
                 kernel: str = "staged") -> int:
    """Rows per kernel call, so that the call's working set stays within
    :data:`GL_L2_BUDGET_BYTES`. Per frame of a row:
    - staged: the f32 u planes 8 x 128 and the bf16 z operands 8 x 128
      that its two phases exchange, bf16 target magnitudes 640; under
      momentum two bf16 previous projections of 640. Its bf16 forward
      leaves (5 x 2 x 128 x 128, 320 KB) come off the budget first;
    - dense: f32 re / im of Fp = n_fft/2 bins, the f32 Nyquist term, f32
      frames of n_fft, f32 magnitudes of Fp + 1; under momentum three f32
      carries (re, im, Nyquist). Its bf16 DFT matrices (8 n_fft Fp bytes,
      4 MB at n_fft 1024)
      come off the budget first. Where not one row fits beside them (from
      n_fft 3328; at 3072 past T 136), every call streams them from device memory
      whatever its rows, and the rows a call are those whose working set
      fits :data:`GL_SCRATCH_BUDGET_BYTES` instead: one call for any batch
      the reference's cap admits."""
    if kernel == "staged":
        per_frame = 8 * 128 * 4 + 8 * 128 * 2 + 640 * 2
        if momentum > 0.0:
            per_frame += 2 * 640 * 2
        budget = GL_L2_BUDGET_BYTES - 5 * 2 * 128 * 128 * 2
    else:
        Fp = n_fft // 2
        per_frame = 2 * Fp * 4 + 4 + n_fft * 4 + (Fp + 1) * 4
        if momentum > 0.0:
            per_frame += 2 * Fp * 4 + 4
        budget = GL_L2_BUDGET_BYTES - 2 * 2 * n_fft * Fp * 2
        if budget < T * per_frame:
            budget = GL_SCRATCH_BUDGET_BYTES
    return max(1, budget // (T * per_frame))


def griffin_lim_auto(magnitude: torch.Tensor, n_fft: int, hop: int,
                     n_iter: int, length: int,
                     momentum: float = 0.0) -> torch.Tensor:
    """The vocoder: (..., T, F) -> (..., length), routed by :func:`gl_route`.
    A kernel route runs in chunks of :func:`gl_max_batch` rows; the GEMM
    route on the card prints one ``[dispatch]`` line, as the JAX package
    does on a TPU. Each call counts its rows x frames as
    ``vocode.row_frames`` (:mod:`..telemetry`)."""
    T = magnitude.shape[-2]
    telemetry.count("vocode.row_frames", magnitude.numel() // magnitude.shape[-1])
    route = gl_route(magnitude.ndim, n_fft, hop, T, length, magnitude.is_cuda,
                     magnitude.shape[0], momentum)
    if route == "gemm":
        if magnitude.is_cuda:
            log_dispatch("griffin_lim", "gemm", f"T={T}, n_fft={n_fft}, hop={hop}, "
                                                f"ndim={magnitude.ndim}")
        return griffin_lim_matmul(magnitude, n_fft, hop, n_iter, length, momentum)
    if route == "staged":
        from multi_speaker_tts_tpu_torch.ops.griffin_lim_staged import griffin_lim_staged as fn
    else:
        from multi_speaker_tts_tpu_torch.ops.griffin_lim_kernel import griffin_lim_dense as fn
    B = magnitude.shape[0]
    chunk = gl_max_batch(T, n_fft, momentum, route)
    log_dispatch("griffin_lim", route, f"T={T}, n_fft={n_fft}, {min(chunk, B)} rows a call")
    return torch.cat([
        fn(magnitude[i:i + chunk], n_fft, hop, n_iter, momentum=momentum)
        for i in range(0, B, chunk)
    ])
