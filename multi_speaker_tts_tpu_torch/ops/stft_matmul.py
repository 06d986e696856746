"""GEMM-form STFT / ISTFT / Griffin-Lim (port of ``ops/stft_matmul.py``).

The rDFT of a frame is a matmul against windowed cos/sin matrices and
framing / overlap-add are k = n_fft/hop shifted views, as in the JAX
module. :func:`griffin_lim_matmul` is the plain f32 reference iteration
(zero initial phase, reflect-padded re-framing), the path the JAX package
takes off the TPU. :func:`griffin_lim_auto` is the vocoder's device
dispatch: CUDA tensors go to the staged Griffin-Lim kernel
(:mod:`.griffin_lim_staged`) in batch chunks that keep its working set
inside the card's L2; CPU tensors take :func:`griffin_lim_matmul`, as the
JAX package does on the CPU.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.audio.dsp import reflect_pad


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
                       n_iter: int, length: int,
                       momentum: float = 0.0) -> torch.Tensor:
    """Griffin-Lim with every transform an f32 matmul: (..., T, F) ->
    (..., length). Zero initial phase; ``momentum`` > 0 is the accelerated
    variant of Perraudin et al. 2013."""
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


# Bytes of one staged-kernel call's working set: inside the H100's 50 MB L2.
GL_L2_BUDGET_BYTES = 40 << 20


def gl_max_batch(T: int) -> int:
    """Rows per staged-kernel call: its per-iteration working set (f32
    re/im spectra 2 x 640, f32 frames 1024, bf16 magnitudes 640 per frame)
    stays within :data:`GL_L2_BUDGET_BYTES`."""
    per_row = T * (2 * 640 * 4 + 1024 * 4 + 640 * 2)
    return max(1, GL_L2_BUDGET_BYTES // per_row)


def griffin_lim_auto(magnitude: torch.Tensor, n_fft: int, hop: int,
                     n_iter: int, length: int,
                     momentum: float = 0.0) -> torch.Tensor:
    """The vocoder: (B, T, F) -> (B, length). CUDA: the staged kernel in
    chunks of :func:`gl_max_batch` rows (it raises on what it does not
    take: n_fft != 1024, momentum, a length other than hop * (T - 1)).
    CPU: :func:`griffin_lim_matmul`."""
    if not magnitude.is_cuda:
        return griffin_lim_matmul(magnitude, n_fft, hop, n_iter, length, momentum)
    from multi_speaker_tts_tpu_torch.ops.griffin_lim_staged import griffin_lim_staged

    B, T, _ = magnitude.shape
    if length != hop * (T - 1):
        raise NotImplementedError("the staged kernel returns hop * (T - 1) samples")
    chunk = gl_max_batch(T)
    return torch.cat([
        griffin_lim_staged(magnitude[i:i + chunk], n_fft, hop, n_iter,
                           momentum=momentum)
        for i in range(0, B, chunk)
    ])
