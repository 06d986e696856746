"""The bidirectional recurrences on Hopper kernels: the text encoder's
BiLSTM and the CBHG head's BiGRU.

BiLSTM: replaces ``multi_speaker_tts_tpu/ops/birnn_pallas.py::_bilstm_fwd_impl``
(kernel body ``_bilstm_fwd_kernel``, reached through ``bilstm_pallas``).
As in the JAX package, the input projections x . W_ih + b of both
directions are hoisted out as two whole-sequence matmuls (stored in the
compute dtype); the kernel (``csrc/bilstm.cu``) runs only the recurrence,
the forward direction at natural time s and the backward one at T-1-s in
the same step, f32 carries, outputs in the compute dtype.

:func:`bilstm_recurrence_plain` is the same recurrence in plain torch.

BiGRU: replaces ``birnn_pallas.py::_bigru_fwd_impl`` (kernel body
``_bigru_fwd_kernel``, reached through ``bigru_pallas``). The input gates
x . W_ih + b_ih of both directions are hoisted the same way; the kernel
(``csrc/bigru.cu``) runs gh = bf16(h) . W_hh + b_hh and the r, z, n cell
with an f32 carry, one block per (direction, batch row) with that
direction's W_hh resident in shared memory, so it needs no grid barrier.
:func:`bigru_recurrence_plain` is the same recurrence in plain torch.
"""

from __future__ import annotations

import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops import gru as gru_ops
from multi_speaker_tts_tpu_torch.ops.gru import GRUParams
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams, input_gates, recurrence

KERNEL = _build.Kernel("bilstm", "bilstm.cu", {
    "mstts_bilstm_fwd": [_build.P] * 7 + [_build.I] * 3 + [_build.P],
})
GRU_KERNEL = _build.Kernel("bigru", "bigru.cu", {
    "mstts_bigru_fwd": [_build.P] * 8 + [_build.I] * 3 + [_build.P],
})


def bilstm_hoist(fwd: LSTMParams, bwd: LSTMParams, x: torch.Tensor,
                 compute_dtype=torch.bfloat16):
    """Input gates of both directions, time-major (T, B, 4H), stored in the
    compute dtype (bias folded in)."""
    return tuple(
        input_gates(p, x, compute_dtype).transpose(0, 1).to(compute_dtype).contiguous()
        for p in (fwd, bwd)
    )


def bilstm_recurrence_plain(gxf, gxb, w_hh_f, w_hh_b, compute_dtype=torch.bfloat16):
    """(T, B, 4H) gates per direction -> (ysf, ysb) (T, B, H) in the
    compute dtype, both in natural time."""
    ysf, _, _ = recurrence(gxf, w_hh_f, compute_dtype)
    ysb, _, _ = recurrence(gxb, w_hh_b, compute_dtype, reverse=True)
    return ysf.to(compute_dtype), ysb.to(compute_dtype)


def _transposed_bf16(w_hh: torch.Tensor) -> torch.Tensor:
    return w_hh.t().contiguous().to(torch.bfloat16)


def bilstm_recurrence_kernel(gxf, gxb, w_hh_f, w_hh_b):
    """Launch ``csrc/bilstm.cu`` on CUDA bf16 hoisted gates."""
    for name, g in (("gxf", gxf), ("gxb", gxb)):
        _build.require_cuda(g, torch.bfloat16, name)
    T, B, H4 = gxf.shape
    H = H4 // 4
    if gxb.shape != gxf.shape or H % 8:
        raise ValueError(f"BiLSTM kernel needs equal gates, H % 8 == 0: {H}")
    whf = _build.packed(_transposed_bf16, w_hh_f)
    whb = _build.packed(_transposed_bf16, w_hh_b)
    ysf = torch.empty((T, B, H), dtype=torch.bfloat16, device=gxf.device)
    ysb = torch.empty_like(ysf)
    bar = torch.zeros(1, dtype=torch.int32, device=gxf.device)
    KERNEL.call(
        "mstts_bilstm_fwd", gxf.data_ptr(), gxb.data_ptr(), whf.data_ptr(),
        whb.data_ptr(), ysf.data_ptr(), ysb.data_ptr(), bar.data_ptr(),
        T, B, H, _build.stream_ptr(gxf),
    )
    return ysf, ysb


def bilstm_recurrence(gxf, gxb, w_hh_f, w_hh_b, compute_dtype=torch.bfloat16):
    """The kernel for CUDA tensors (bf16 compute only), the plain version
    for CPU tensors."""
    if gxf.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the BiLSTM kernel computes in bf16 only")
        return bilstm_recurrence_kernel(gxf, gxb, w_hh_f, w_hh_b)
    return bilstm_recurrence_plain(gxf, gxb, w_hh_f, w_hh_b, compute_dtype)


def bilstm(fwd: LSTMParams, bwd: LSTMParams, x: torch.Tensor,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H) f32, both directions concatenated."""
    gxf, gxb = bilstm_hoist(fwd, bwd, x, compute_dtype)
    ysf, ysb = bilstm_recurrence(gxf, gxb, fwd.w_hh, bwd.w_hh, compute_dtype)
    return torch.cat([ysf, ysb], dim=-1).float().transpose(0, 1)


def bigru_hoist(fwd: GRUParams, bwd: GRUParams, x: torch.Tensor,
                compute_dtype=torch.bfloat16):
    """Input gates of both directions, time-major (T, B, 3H), stored in the
    compute dtype (b_ih folded in; b_hh stays with the recurrence)."""
    return tuple(
        gru_ops.input_gates(p, x, compute_dtype).transpose(0, 1).to(compute_dtype).contiguous()
        for p in (fwd, bwd)
    )


def bigru_recurrence_plain(gxf, gxb, fwd: GRUParams, bwd: GRUParams,
                           compute_dtype=torch.bfloat16):
    """(T, B, 3H) input gates per direction -> (ysf, ysb) (T, B, H) in the
    compute dtype, both in natural time."""
    ysf = gru_ops.recurrence(fwd, gxf, compute_dtype)
    ysb = gru_ops.recurrence(bwd, gxb, compute_dtype, reverse=True)
    return ysf.to(compute_dtype), ysb.to(compute_dtype)


def _gru_layout(w_hh: torch.Tensor, b_hh: torch.Tensor):
    """W_hh (H, 3H) as bf16 rows and the f32 recurrent bias."""
    return w_hh.contiguous().to(torch.bfloat16), b_hh.float().contiguous()


def bigru_recurrence_kernel(gxf, gxb, fwd: GRUParams, bwd: GRUParams):
    """Launch ``csrc/bigru.cu`` on CUDA bf16 hoisted input gates."""
    for name, g in (("gxf", gxf), ("gxb", gxb)):
        _build.require_cuda(g, torch.bfloat16, name)
    T, B, H3 = gxf.shape
    H = H3 // 3
    if gxb.shape != gxf.shape or fwd.w_hh.shape != (H, H3) or bwd.w_hh.shape != (H, H3):
        raise ValueError(f"BiGRU kernel needs equal (T, B, 3H) gates and (H, 3H) weights: {H}")
    # One direction's W_hh must fit one block's shared memory, one thread
    # per gate column.
    if H % 8 or H3 > 1024 or 2 * H * H3 + 20 * H > 227 * 1024:
        raise ValueError(f"BiGRU kernel needs H % 8 == 0 and H <= 192: {H}")
    whf, bhf = _build.packed(_gru_layout, fwd.w_hh, fwd.b_hh)
    whb, bhb = _build.packed(_gru_layout, bwd.w_hh, bwd.b_hh)
    ysf = torch.empty((T, B, H), dtype=torch.bfloat16, device=gxf.device)
    ysb = torch.empty_like(ysf)
    GRU_KERNEL.call(
        "mstts_bigru_fwd", gxf.data_ptr(), gxb.data_ptr(), whf.data_ptr(),
        whb.data_ptr(), bhf.data_ptr(), bhb.data_ptr(), ysf.data_ptr(),
        ysb.data_ptr(), T, B, H, _build.stream_ptr(gxf),
    )
    return ysf, ysb


def bigru_recurrence(gxf, gxb, fwd: GRUParams, bwd: GRUParams,
                     compute_dtype=torch.bfloat16):
    """The kernel for CUDA tensors (bf16 compute only), the plain version
    for CPU tensors."""
    if gxf.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the BiGRU kernel computes in bf16 only")
        return bigru_recurrence_kernel(gxf, gxb, fwd, bwd)
    return bigru_recurrence_plain(gxf, gxb, fwd, bwd, compute_dtype)


def bigru(fwd: GRUParams, bwd: GRUParams, x: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H) f32, both directions concatenated."""
    gxf, gxb = bigru_hoist(fwd, bwd, x, compute_dtype)
    ysf, ysb = bigru_recurrence(gxf, gxb, fwd, bwd, compute_dtype)
    return torch.cat([ysf, ysb], dim=-1).float().transpose(0, 1)
