"""Staged (8-leaf) Griffin-Lim at n_fft = 1024 on a Hopper kernel.

Replaces ``multi_speaker_tts_tpu/ops/griffin_lim_staged.py::griffin_lim_staged``
(kernel body ``_gl_staged_kernel``). Same fixed-point map: with n = 128 j + m
and k = 8 t + c the 1024-point DFT of a frame is an exact 8-point butterfly
across its eight 128-sample blocks followed by per-class (128 x 128) leaf
products; only classes 0-4 are stored (the others are conjugate mirrors),
zero-phase initialisation, window-square OLA normalisation over the
uncropped signal rows, ``mag * rsqrt(|X|^2 + 1e-12)`` projection and a
centred crop. In the bf16 compute mode the leaf products take bf16
operands with f32 accumulation and the target magnitudes are stored bf16.
With ``momentum`` > 0 (the accelerated iteration, the TPU kernel's branch
``body_m``) each projection first extrapolates the fresh spectrum against
the previous one, beta = m / (1 + m); the previous spectra are stored in
the compute dtype (bf16 in production) and read back as f32. That mode is
counted as :data:`MOM_KERNEL`.

The TPU kernel keeps the (T, 640) spectra of an utterance resident in VMEM
for all iterations. An SM has 227 KB of shared memory, so the Hopper
design (``csrc/griffin_lim.cu``) is one cooperative launch a call whose
blocks own (16-frame tile, class group) and (tile, 32-position slice)
units; each iteration is two phases separated by a grid barrier: forward
leaf products + projection + inverse leaf products per class (the
projected spectra stay in shared memory), then inverse butterfly +
overlap-add + re-framing + forward butterfly per slice. Each block keeps
its class group's forward leaves resident in shared memory (the inverse
leaves are the same bf16 values transposed, times a power of two); only
the f32 u planes and the bf16 z operands go through device memory. It
takes hop 128, 256 or 512 (:func:`staged_shape_reason`).

:func:`griffin_lim_staged_plain` is the same iteration in plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops.numerics import rounded
from multi_speaker_tts_tpu_torch.ops.stft_matmul import _hann

_FUNCTIONS = {
    "mstts_gl_staged": [_build.P] * 11 + [_build.I] * 4 + [_build.F, _build.P],
    "mstts_gl_staged_blocks": [_build.I] * 3 + [_build.P],
}
KERNEL = _build.Kernel("griffin_lim_staged", "griffin_lim.cu", _FUNCTIONS)
MOM_KERNEL = _build.Kernel("griffin_lim_staged_momentum", "griffin_lim.cu", _FUNCTIONS)

N_FFT = 1024
S = 8  # leaves
L = 128  # leaf length
KEPT = (0, 1, 2, 3, 4)  # stored classes; 5..7 are conjugate mirrors
G = len(KEPT) * L  # 640 stored spectral lanes
R2 = float(np.sqrt(2.0) / 2.0)


@functools.lru_cache(maxsize=1)
def _staged_operands_f64():
    """Leaf matrices per kept class, window blocks and the lane -> bin map.

    Forward leaf c: M_c[m, t] = exp(-2 pi i m (8t + c) / N), the DFT
    matrix's columns k = 8t + c. Inverse leaf: conj(M_c).T / 128, with the
    mirrored classes' 2x pre-folded; the combine's 1/8 sits in the
    synthesis window, so the whole inverse carries 1/N."""
    m = np.arange(L, dtype=np.float64)[:, None]
    fwd, inv = [], []
    for c in KEPT:
        k = (8 * np.arange(L, dtype=np.float64) + c)[None, :]
        ang = -2.0 * np.pi * m * k / N_FFT
        Mr, Mi = np.cos(ang), np.sin(ang)
        fwd.append((Mr, Mi))
        two = 2.0 if c in (1, 2, 3) else 1.0
        inv.append((two * Mr.T / L, -two * Mi.T / L))
    win = _hann(N_FFT).astype(np.float64)
    win_blocks = win.reshape(S, L).astype(np.float32)
    syn_blocks = (win.reshape(S, L) / S).astype(np.float32)
    perm = np.zeros((G,), np.int64)
    for g, c in enumerate(KEPT):
        k = 8 * np.arange(L) + c
        perm[g * L:(g + 1) * L] = np.where(k <= N_FFT // 2, k, N_FFT - k)
    return fwd, inv, win_blocks, syn_blocks, perm


@functools.lru_cache(maxsize=8)
def _operands(device: torch.device, compute_dtype: torch.dtype):
    """Device tensors: leaf matrices rounded to the compute dtype (held
    f32), windows, permutation, and the kernel's leaf operands: only the
    bf16 forward leaves (class, [Mr, Mi], 128, 128), 320 KB. The inverse
    leaf of class c is (two / 128) conj(M_c)^T with two = 2 for c in 1..3,
    a power of two times the transpose, so its bf16 rounding is the
    forward leaf's, transposed and scaled exactly."""
    fwd, inv, win_blocks, syn_blocks, perm = _staged_operands_f64()

    def t(a):
        return rounded(torch.from_numpy(a).to(device), compute_dtype)

    fwd_t = [(t(a), t(b)) for a, b in fwd]
    return {
        "fwd": fwd_t,
        "inv": [(t(a), t(b)) for a, b in inv],
        "win": torch.from_numpy(win_blocks).to(device),
        "syn": torch.from_numpy(syn_blocks).to(device),
        "perm": torch.from_numpy(perm).to(device),
        "leaves": torch.stack([torch.stack(p) for p in fwd_t]).to(torch.bfloat16).contiguous(),
    }


@functools.lru_cache(maxsize=16)
def _wsum_rows(hop: int, T: int, device: torch.device) -> torch.Tensor:
    """Inverse window-square OLA normalizer over (T + k - 1, hop) rows."""
    k = N_FFT // hop
    wsq = (_hann(N_FFT).astype(np.float64) ** 2).reshape(k, hop)
    acc = np.zeros((T + k - 1, hop), np.float64)
    for i in range(k):
        acc[i:i + T] += wsq[i]
    return torch.from_numpy((1.0 / np.maximum(acc, 1e-11)).astype(np.float32)).to(device)


def _combine_forward(b):
    """8 real blocks -> z_c (re, im) for c in KEPT by the exact 8-point
    butterfly; z_0 and z_4 are real (im None)."""
    s = [b[j] + b[j + 4] for j in range(4)]
    d = [b[j] - b[j + 4] for j in range(4)]
    u0, u1 = s[0] + s[2], s[1] + s[3]
    v0, v1 = s[0] - s[2], s[1] - s[3]
    p = (d[1] - d[3]) * R2
    q = (d[1] + d[3]) * R2
    return [
        (u0 + u1, None),
        (d[0] + p, -q - d[2]),
        (v0, -v1),
        (d[0] - p, -q + d[2]),
        (u0 - u1, None),
    ]


def _combine_inverse(us):
    """u_c for c in KEPT -> 8 real frame blocks (scale-free butterfly)."""
    u0, u4 = us[0][0], us[4][0]
    Ur1, Ui1 = us[1]
    Ur2, Ui2 = us[2]
    Ur3, Ui3 = us[3]
    P, Q = u0 + u4, u0 - u4
    E = [P + Ur2, Q - Ui2, P - Ur2, Q + Ui2]
    g1, h1 = (Ur1 - Ui1) * R2, (Ur1 + Ui1) * R2
    g3, h3 = (Ur3 - Ui3) * R2, (Ur3 + Ui3) * R2
    O = [Ur1 + Ur3, g1 - h3, Ui3 - Ui1, g3 - h1]
    return [E[0] + O[0], E[1] + O[1], E[2] + O[2], E[3] + O[3],
            E[0] - O[0], E[1] - O[1], E[2] - O[2], E[3] - O[3]]


def griffin_lim_staged_plain(mag_staged: torch.Tensor, hop: int, n_iter: int,
                             compute_dtype=torch.bfloat16,
                             momentum: float = 0.0) -> torch.Tensor:
    """(B, T, 640) magnitudes in staged order -> (B, hop * (T - 1))."""
    B, T, _ = mag_staged.shape
    k = N_FFT // hop
    per_row = hop // L
    ops = _operands(mag_staged.device, compute_dtype)
    wsum = _wsum_rows(hop, T, mag_staged.device)

    def istft_rows(re, im):
        us = []
        for g, c in enumerate(KEPT):
            IMr, IMi = ops["inv"][g]
            Yr = rounded(re[..., g * L:(g + 1) * L], compute_dtype)
            Yi = rounded(im[..., g * L:(g + 1) * L], compute_dtype)
            ur = Yr @ IMr - Yi @ IMi
            us.append((ur, None if c in (0, 4) else Yr @ IMi + Yi @ IMr))
        blocks = _combine_inverse(us)
        frames = torch.cat([blocks[j] * ops["syn"][j] for j in range(S)], dim=-1)
        rows = frames.new_zeros((B, T + k - 1, hop))
        for i in range(k):
            rows[:, i:i + T] += frames[..., i * hop:(i + 1) * hop]
        return rows * wsum

    def stft_of(rows):
        blocks = []
        for i in range(k):
            rows_i = rows[:, i:i + T]
            for p in range(per_row):
                blocks.append(rows_i[..., p * L:(p + 1) * L] * ops["win"][i * per_row + p])
        res, ims = [], []
        for (Mr, Mi), (zr, zi) in zip(ops["fwd"], _combine_forward(blocks)):
            zrc = rounded(zr, compute_dtype)
            yr, yi = zrc @ Mr, zrc @ Mi
            if zi is not None:
                zic = rounded(zi, compute_dtype)
                yr, yi = yr - zic @ Mi, yi + zic @ Mr
            res.append(yr)
            ims.append(yi)
        return torch.cat(res, dim=-1), torch.cat(ims, dim=-1)

    mag = mag_staged.float()
    re, im = mag, torch.zeros_like(mag)
    beta = momentum / (1.0 + momentum)
    pre = pim = torch.zeros_like(mag)
    for _ in range(n_iter):
        re2, im2 = stft_of(istft_rows(re, im))
        if momentum > 0.0:
            # Previous projections stored like the magnitudes, read as f32.
            re2, im2, pre, pim = (re2 - beta * pre, im2 - beta * pim,
                                  rounded(re2, mag_staged.dtype), rounded(im2, mag_staged.dtype))
        scale = mag * torch.rsqrt(re2 * re2 + im2 * im2 + 1e-12)
        re, im = re2 * scale, im2 * scale
    rows = istft_rows(re, im)
    return rows[:, k // 2:k // 2 + T - 1].reshape(B, (T - 1) * hop)


KERNEL_HOPS = (128, 256, 512)  # n_fft / hop = 8, 4, 2: the kernel's template instances


def staged_shape_reason(shape, hop: int) -> str | None:
    """Why ``csrc/griffin_lim.cu`` does not take (B, T, lanes) staged
    magnitudes at this hop, or None if it does."""
    B, T, lanes = shape
    if lanes != G or T < 2 or B < 1:
        return f"needs staged magnitudes (B >= 1, T >= 2, {G}), got {tuple(shape)}"
    if hop not in KERNEL_HOPS:
        return f"needs hop in {KERNEL_HOPS}, got {hop}"
    return None


def kernel_blocks(B: int, T: int, hop: int) -> int:
    """The kernel's grid at these shapes on the current card: 4 blocks per
    16-frame tile slot, at most one block an SM."""
    blocks = ctypes.c_int(0)
    lib = KERNEL.lib()
    err = lib.mstts_gl_staged_blocks(B, T, hop, ctypes.addressof(blocks))
    if err != 0:
        raise RuntimeError(f"mstts_gl_staged_blocks failed: {lib.mstts_error_string(err).decode()}")
    return blocks.value


def griffin_lim_staged_kernel(mag_staged: torch.Tensor, hop: int, n_iter: int,
                              momentum: float = 0.0) -> torch.Tensor:
    """Launch ``csrc/griffin_lim.cu`` on CUDA bf16 staged magnitudes; with
    ``momentum`` > 0 its momentum mode, with two bf16 previous-projection
    buffers."""
    _build.require_cuda(mag_staged, torch.bfloat16, "mag_staged")
    reason = staged_shape_reason(mag_staged.shape, hop)
    if reason is not None:
        raise ValueError(f"staged Griffin-Lim kernel {reason}")
    B, T, _ = mag_staged.shape
    dev = mag_staged.device
    ops = _operands(dev, torch.bfloat16)
    wsum = _wsum_rows(hop, T, dev)
    mag = mag_staged if mag_staged.data_ptr() % 4 == 0 else mag_staged.clone()  # pairs
    u = torch.empty((B, T, S, L), dtype=torch.float32, device=dev)
    z = torch.empty((B, T, S, L), dtype=torch.bfloat16, device=dev)
    out = torch.empty((B, (T - 1) * hop), dtype=torch.float32, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    pre = pim = None
    if momentum > 0.0:
        pre = torch.zeros_like(mag)
        pim = torch.zeros_like(mag)
    (MOM_KERNEL if momentum > 0.0 else KERNEL).call(
        "mstts_gl_staged", mag.data_ptr(), ops["leaves"].data_ptr(),
        ops["win"].data_ptr(), ops["syn"].data_ptr(), wsum.data_ptr(),
        u.data_ptr(), z.data_ptr(), out.data_ptr(),
        0 if pre is None else pre.data_ptr(), 0 if pim is None else pim.data_ptr(),
        bar.data_ptr(), B, T, hop, n_iter, momentum / (1.0 + momentum),
        _build.stream_ptr(mag_staged),
    )
    return out


def staged_magnitudes(magnitude: torch.Tensor, compute_dtype) -> torch.Tensor:
    """(B, T, 513) -> (B, T, 640) in staged lane order, stored in the
    compute dtype (bf16 in production)."""
    perm = _operands(magnitude.device, compute_dtype)["perm"]
    return magnitude.to(compute_dtype).index_select(-1, perm).contiguous()


def griffin_lim_staged(magnitude: torch.Tensor, n_fft: int, hop: int,
                       n_iter: int, compute_dtype=torch.bfloat16,
                       momentum: float = 0.0) -> torch.Tensor:
    """Batched staged Griffin-Lim: (B, T, 513) -> (B, hop * (T - 1)). The
    kernel for a CUDA tensor (bf16 compute), the plain version for a CPU
    tensor; ``momentum`` > 0 runs the accelerated iteration."""
    if n_fft != N_FFT or n_fft % hop or hop % L or (n_fft // hop) % 2:
        raise NotImplementedError(
            f"staged Griffin-Lim needs n_fft=1024 and a 128-multiple hop "
            f"with an even n_fft/hop (got n_fft={n_fft}, hop={hop})")
    mag_staged = staged_magnitudes(magnitude, compute_dtype)
    if mag_staged.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the Griffin-Lim kernel computes in bf16 only")
        return griffin_lim_staged_kernel(mag_staged, hop, n_iter, momentum)
    return griffin_lim_staged_plain(mag_staged, hop, n_iter, compute_dtype, momentum)
