"""Dense Griffin-Lim on a Hopper kernel, for any n_fft the route sends.

Replaces ``multi_speaker_tts_tpu/ops/griffin_lim_kernel.py::griffin_lim_pallas``
(kernel body ``_gl_kernel``): the vocoder for n_fft != 1024, or for any
size under ``GL_DENSE_KERNEL``. Same fixed-point map as that kernel (not as
:func:`..stft_matmul.griffin_lim_matmul`, whose re-framing reflect-pads the
cropped signal):

- the analysis window folded into the forward DFT matrices, the synthesis
  window and 1/N into the inverse ones, bins 0 .. n_fft/2 - 1 only; the
  Nyquist bin is real and rides outside the products as a rank-1 f32 term
  (:func:`_gl_operands`); the matrices in the compute dtype;
- zero-phase start re = mag, im = 0, Nyquist = its magnitude;
- overlap-add over the uncropped signal rows, round_up(T + k - 1, 8) of
  them, times the inverse window-square sum (:func:`_wsum_rows`);
- frame t re-framed from rows t .. t + k - 1 (the TPU kernel's circular
  rolls never wrap a nonzero row, so they are plain shifts here);
- projection ``mag / max(sqrt(|X|^2 + 1e-12), 1e-11)``; ``momentum`` > 0
  extrapolates X - beta P against the previous unprojected spectrum P
  (beta = m / (1 + m)) before it, with three f32 carries;
- n_iter + 1 inverses, then a centred crop of k/2 rows.

The TPU kernel keeps the spectra and the matrices in VMEM for all
iterations; ``csrc/griffin_lim_dense.cu`` keeps the spectra and frames in
device memory (L2-resident at serving sizes), reads the bf16 matrices
through L2 and runs two tiled launches an iteration (see the source).
:func:`griffin_lim_dense_plain` is the same iteration in plain torch.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops.numerics import rounded
from multi_speaker_tts_tpu_torch.ops.stft_matmul import _dft_matrices, _hann, _idft_matrices

LANE = 128
# The kernel holds a 16-frame tile of [re | im] (or of the frames) in shared
# memory as bf16: n_fft 2048 is the widest that fits.
DENSE_MAX_N_FFT = 2048
KERNEL = _build.Kernel("griffin_lim_dense", "griffin_lim_dense.cu", {
    "mstts_gl_dense": [_build.P] * 15 + [_build.I] * 5 + [_build.F, _build.P],
})


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _gl_operands(n_fft: int, hop: int):
    """f32 copy of the JAX module's ``_gl_operands(n_fft, hop, "float32")``:
    windowed DFT / IDFT matrices for bins 0 .. n_fft/2 - 1, lane-padded to
    Fp, and the Nyquist bin's analysis / synthesis vectors in (rows8, hop)
    layout: (Wr, Wi, Vr, Vi, wny, vny, Fp). The compute-dtype rounding
    happens on the torch side (numpy has no bf16)."""
    F = n_fft // 2 + 1
    Fm = F - 1
    Fp = _round_up(Fm, LANE)
    win = _hann(n_fft).astype(np.float64)
    Wr, Wi = _dft_matrices(n_fft)
    Vr, Vi = _idft_matrices(n_fft)
    Wr_p = np.zeros((n_fft, Fp), np.float64)
    Wi_p = np.zeros((n_fft, Fp), np.float64)
    Wr_p[:, :Fm] = win[:, None] * Wr[:, :Fm]
    Wi_p[:, :Fm] = win[:, None] * Wi[:, :Fm]
    Vr_p = np.zeros((Fp, n_fft), np.float64)
    Vi_p = np.zeros((Fp, n_fft), np.float64)
    Vr_p[:Fm] = Vr[:Fm] * win[None, :]
    Vi_p[:Fm] = Vi[:Fm] * win[None, :]
    k = n_fft // hop
    sign = (-1.0) ** np.arange(n_fft)  # cos(pi n), exact
    rows8 = _round_up(k, 8)
    wny = np.zeros((rows8, hop), np.float64)
    vny = np.zeros((rows8, hop), np.float64)
    wny[:k] = (win * sign).reshape(k, hop)
    vny[:k] = (sign * win / n_fft).reshape(k, hop)
    return (*(m.astype(np.float32) for m in (Wr_p, Wi_p, Vr_p, Vi_p, wny, vny)), Fp)


def _wsum_rows(n_fft: int, hop: int, T: int, rows_pad: int) -> np.ndarray:
    """Inverse window-square OLA normalizer in (rows_pad, hop) layout."""
    k = n_fft // hop
    wsq = (_hann(n_fft).astype(np.float64) ** 2).reshape(k, hop)
    acc = np.zeros((rows_pad, hop), np.float64)
    for i in range(k):
        acc[i:i + T] += wsq[i]
    return (1.0 / np.maximum(acc, 1e-11)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _operands(n_fft: int, hop: int, device: torch.device, compute_dtype: torch.dtype):
    """Device tensors: the matrices rounded to the compute dtype (held f32,
    for the plain version), the Nyquist vectors (k, hop) f32, and the
    kernel's bf16 [Wr | Wi] (n_fft, 2 Fp) and [Vr; Vi] (2 Fp, n_fft)."""
    Wr, Wi, Vr, Vi, wny, vny, Fp = _gl_operands(n_fft, hop)
    k = n_fft // hop
    t = {name: rounded(torch.from_numpy(a).to(device), compute_dtype)
         for name, a in (("Wr", Wr), ("Wi", Wi), ("Vr", Vr), ("Vi", Vi))}
    t["wny"] = torch.from_numpy(wny[:k]).to(device)
    t["vny"] = torch.from_numpy(vny[:k]).to(device)
    t["wcat"] = torch.cat([t["Wr"], t["Wi"]], dim=1).to(torch.bfloat16).contiguous()
    t["vcat"] = torch.cat([t["Vr"], t["Vi"]], dim=0).to(torch.bfloat16).contiguous()
    return t, Fp


@functools.lru_cache(maxsize=16)
def _wsum_tensor(n_fft: int, hop: int, T: int, device: torch.device) -> torch.Tensor:
    rows_pad = _round_up(T + n_fft // hop - 1, 8)
    return torch.from_numpy(_wsum_rows(n_fft, hop, T, rows_pad)).to(device)


def split_magnitude(magnitude: torch.Tensor, n_fft: int):
    """(B, T, n_fft/2 + 1) -> bins 0 .. n_fft/2 - 1 zero-padded to Fp
    (B, T, Fp) and the Nyquist bin (B, T, 1), f32."""
    mag = magnitude.float()
    F = n_fft // 2 + 1
    Fp = _round_up(F - 1, LANE)
    mag_p = torch.nn.functional.pad(mag[..., :F - 1], (0, Fp - (F - 1))).contiguous()
    return mag_p, mag[..., F - 1:].contiguous()


def griffin_lim_dense_plain(mag_p: torch.Tensor, mag_ny: torch.Tensor, n_fft: int,
                            hop: int, n_iter: int, compute_dtype=torch.bfloat16,
                            momentum: float = 0.0) -> torch.Tensor:
    """``_gl_kernel``'s iteration: (B, T, Fp) + (B, T, 1) -> (B, hop (T - 1))."""
    B, T, _ = mag_p.shape
    k = n_fft // hop
    rows_pad = _round_up(T + k - 1, 8)
    ops, _ = _operands(n_fft, hop, mag_p.device, compute_dtype)
    wsum = _wsum_tensor(n_fft, hop, T, mag_p.device)
    vny, wny = ops["vny"].reshape(-1), ops["wny"].reshape(-1)

    def istft_rows(re, im, rny):
        frames = (rounded(re, compute_dtype) @ ops["Vr"] + rounded(im, compute_dtype) @ ops["Vi"]
                  + rny * vny)
        rows = frames.new_zeros((B, rows_pad, hop))
        for i in range(k):
            rows[:, i:i + T] += frames[..., i * hop:(i + 1) * hop]
        return rows * wsum

    def stft_of(rows):
        x = torch.cat([rows[:, i:i + T] for i in range(k)], dim=-1)  # (B, T, n_fft)
        xc = rounded(x, compute_dtype)
        return xc @ ops["Wr"], xc @ ops["Wi"], (x * wny).sum(dim=-1, keepdim=True)

    def project(x, m):
        return x * (m / torch.clamp(torch.sqrt(x * x + 1e-12), min=1e-11))

    mag_p, mag_ny = mag_p.float(), mag_ny.float()
    re, im, rny = mag_p, torch.zeros_like(mag_p), mag_ny
    beta = momentum / (1.0 + momentum)
    pre, pim, prny = torch.zeros_like(mag_p), torch.zeros_like(mag_p), torch.zeros_like(mag_ny)
    for _ in range(n_iter):
        re2, im2, rny2 = stft_of(istft_rows(re, im, rny))
        if momentum > 0.0:
            (re2, im2, rny2), (pre, pim, prny) = (
                (re2 - beta * pre, im2 - beta * pim, rny2 - beta * prny), (re2, im2, rny2))
        scale = mag_p / torch.clamp(torch.sqrt(re2 * re2 + im2 * im2 + 1e-12), min=1e-11)
        re, im, rny = re2 * scale, im2 * scale, project(rny2, mag_ny)
    rows = istft_rows(re, im, rny)
    return rows[:, k // 2:k // 2 + T - 1].reshape(B, (T - 1) * hop)


def griffin_lim_dense_kernel(mag_p: torch.Tensor, mag_ny: torch.Tensor, n_fft: int,
                             hop: int, n_iter: int, momentum: float = 0.0) -> torch.Tensor:
    """Launch ``csrc/griffin_lim_dense.cu`` on CUDA f32 magnitudes (bf16
    products)."""
    _build.require_cuda(mag_p, torch.float32, "mag_p")
    _build.require_cuda(mag_ny, torch.float32, "mag_ny")
    B, T, Fp = mag_p.shape
    if hop % 128 or n_fft > DENSE_MAX_N_FFT or Fp != n_fft // 2 or T < 2:
        raise ValueError(f"the dense Griffin-Lim kernel takes a 128-multiple hop, n_fft <= "
                         f"{DENSE_MAX_N_FFT} and T >= 2 (got n_fft={n_fft}, hop={hop}, T={T})")
    dev = mag_p.device
    ops, _ = _operands(n_fft, hop, dev, torch.bfloat16)
    wsum = _wsum_tensor(n_fft, hop, T, dev)
    re, im, rny = mag_p.clone(), torch.zeros_like(mag_p), mag_ny.reshape(B, T).clone()
    pre = pim = prny = None
    if momentum > 0.0:
        pre, pim, prny = torch.zeros_like(mag_p), torch.zeros_like(mag_p), torch.zeros_like(rny)
    frames = torch.empty((B, T, n_fft), dtype=torch.float32, device=dev)
    out = torch.empty((B, (T - 1) * hop), dtype=torch.float32, device=dev)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    KERNEL.call(
        "mstts_gl_dense", mag_p.data_ptr(), mag_ny.data_ptr(), ops["wcat"].data_ptr(),
        ops["vcat"].data_ptr(), ops["wny"].data_ptr(), ops["vny"].data_ptr(), wsum.data_ptr(),
        re.data_ptr(), im.data_ptr(), rny.data_ptr(), ptr(pre), ptr(pim), ptr(prny),
        frames.data_ptr(), out.data_ptr(), B, T, n_fft, hop, n_iter,
        momentum / (1.0 + momentum), _build.stream_ptr(mag_p),
    )
    return out


def griffin_lim_dense(magnitude: torch.Tensor, n_fft: int, hop: int, n_iter: int,
                      compute_dtype=torch.bfloat16, momentum: float = 0.0) -> torch.Tensor:
    """Batched dense Griffin-Lim: (B, T, n_fft/2 + 1) -> (B, hop (T - 1)).
    The kernel for a CUDA tensor (bf16 products; it raises for a hop that
    is not a 128-multiple or n_fft > 2048), the plain version for a CPU
    tensor."""
    if n_fft % hop or (n_fft // hop) % 2:
        raise ValueError(f"the centred crop needs an even n_fft/hop ratio "
                         f"(got n_fft={n_fft}, hop={hop})")
    if magnitude.shape[-1] != n_fft // 2 + 1:
        raise ValueError(f"magnitude has {magnitude.shape[-1]} bins, n_fft={n_fft} "
                         f"needs {n_fft // 2 + 1}")
    mag_p, mag_ny = split_magnitude(magnitude, n_fft)
    if mag_p.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the dense Griffin-Lim kernel computes in bf16 only")
        return griffin_lim_dense_kernel(mag_p, mag_ny, n_fft, hop, n_iter, momentum)
    return griffin_lim_dense_plain(mag_p, mag_ny, n_fft, hop, n_iter, compute_dtype, momentum)
