"""The bidirectional recurrences on Hopper kernels, with their backwards:
the text encoder's BiLSTM and the CBHG head's BiGRU.

BiLSTM: replaces ``multi_speaker_tts_tpu/ops/birnn_pallas.py::_bilstm_fwd_impl``
(kernel body ``_bilstm_fwd_kernel``, reached through ``bilstm_pallas``).
As in the JAX package, the input projections x . W_ih + b of both
directions are hoisted out as two whole-sequence matmuls (stored in the
compute dtype); the kernel (``csrc/bilstm.cu``) runs only the recurrence,
the forward direction at natural time s and the backward one at T-1-s in
the same step, f32 carries, outputs in the compute dtype, in row groups of
up to 32 (:func:`..lstm_kernel.fwd_row_groups`, one launch and count a
group; from 904 units a direction at 32 rows on an H100, the wide layout,
which streams the W_hh tiles that do not fit). Its residual mode
(counted as :data:`RES_KERNEL`) also stores each direction's
pre-activation gates and c_{t-1}. The backward
(``birnn_pallas.py::_bilstm_vjp_bwd``, kernel body ``_bilstm_bwd_kernel``)
is ``csrc/bilstm_bwd.cu``: both directions' reverse recurrences in one
launch a row group (:func:`..lstm_kernel.bwd_rows`: 512 rows at H 256; past
16 units a block its wide build), emitting dGf and dGb. Where the kernels
take no launch and ``birnn_pallas.supported`` refuses too (an H that is not
a multiple of 8), :func:`bilstm` runs the plain version (``bilstm_fused``).

BiGRU: replaces ``birnn_pallas.py::_bigru_fwd_impl`` (kernel body
``_bigru_fwd_kernel``, reached through ``bigru_pallas``). The input gates
x . W_ih + b_ih of both directions are hoisted the same way; the kernel
(``csrc/bigru.cu``) runs gh = bf16(h) . W_hh + b_hh on tensor cores and the
r, z, n cell with an f32 carry, one block per (direction, group of up to 8
batch rows) with that direction's W_hh resident in registers, so it needs
no grid barrier. It takes H % 16 == 0 and 16 <= H <= 192. Its residual
mode (:data:`GRU_RES_KERNEL`) stores gh and h_{t-1}. The backward
(``birnn_pallas.py::_bigru_vjp_bwd``, kernel body ``_bigru_bwd_kernel``) is
``csrc/bigru_bwd.cu``, emitting dGx and dGh per direction: the same grid,
dh^T = W_hh . bf16(dGh)^T on tensor cores with W_hh resident, the
residuals staged ahead by cp.async. Past H 192 one direction's W_hh no
longer fits one SM, and both go to ``csrc/bigru_wide.cu``
(:func:`bigru_route`; :data:`WIDE_GRU_KERNEL`, :data:`WIDE_GRU_RES_KERNEL`,
:data:`WIDE_GRU_BWD_KERNEL`): persistent cooperative launches in which a
block owns U units of a direction and their W_hh slice, h_{t-1} or dGh
passing through L2 under a grid barrier, in row groups sized by shared
memory (:func:`wide_rows`); where the slice does not hold 32 rows (from
H 1,200 forward, 1,264 backward on an H100) the n-tiles that do not fit
are read from L2 every step (:func:`wide_layout`), up to H 4,880
(:func:`bigru_shape_reason`, :func:`bigru_bwd_shape_reason`).

Under autograd the layers run through :class:`_BiLSTM` and :class:`_BiGRU`
(ports of ``_bilstm_custom`` and ``_bigru_custom``): the hoist, the
recurrence in its residual mode, and in the backward the reverse kernel
plus whole-sequence products for dW_ih, dW_hh, the biases and dx. The
``*_plain`` functions are the same recurrences in plain torch: the CPU
path and the card's yardstick. A compute dtype the kernels do not take
(an f32 checkpoint) goes, in :func:`bilstm` and :func:`bigru`, to the
reference's own route: ``bilstm_fused`` / ``bigru_fused`` in plain torch,
on the tensors' device, under autograd where a gradient is needed.
"""

from __future__ import annotations

import functools

import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops import gru as gru_ops
from multi_speaker_tts_tpu_torch.ops.gru import GRUParams
from multi_speaker_tts_tpu_torch.ops.lstm import (
    LSTMParams,
    bilstm_fused,
    input_gates,
    recurrence,
    recurrence_bwd,
)
from multi_speaker_tts_tpu_torch.ops.lstm_kernel import (
    bwd_row_groups,
    bwd_rows,
    fwd_row_groups,
    fwd_rows,
)
from multi_speaker_tts_tpu_torch.ops.numerics import needs_grad, rounded, seq_gemm

_BILSTM = {"mstts_bilstm_fwd": [_build.P] * 11 + [_build.I] * 5 + [_build.P]}
KERNEL = _build.Kernel("bilstm", "bilstm.cu", _BILSTM)
RES_KERNEL = _build.Kernel("bilstm_residuals", "bilstm.cu", _BILSTM)
BWD_KERNEL = _build.Kernel("bilstm_bwd", "bilstm_bwd.cu", {
    "mstts_bilstm_bwd": [_build.P] * 11 + [_build.I] * 5 + [_build.P],
})
_BIGRU = {"mstts_bigru_fwd": [_build.P] * 12 + [_build.I] * 3 + [_build.P]}
GRU_KERNEL = _build.Kernel("bigru", "bigru.cu", _BIGRU)
GRU_RES_KERNEL = _build.Kernel("bigru_residuals", "bigru.cu", _BIGRU)
GRU_BWD_KERNEL = _build.Kernel("bigru_bwd", "bigru_bwd.cu", {
    "mstts_bigru_bwd": [_build.P] * 14 + [_build.I] * 3 + [_build.P],
})
# The route past H = 192 (csrc/bigru_wide.cu): units split across blocks.
_WIDE = {"mstts_bigru_wide_fwd": [_build.P] * 13 + [_build.I] * 5 + [_build.P],
         "mstts_bigru_wide_bwd": [_build.P] * 15 + [_build.I] * 5 + [_build.P],
         "mstts_bigru_wide_layout": [_build.I] * 3 + [_build.P]}
WIDE_GRU_KERNEL = _build.Kernel("bigru_wide", "bigru_wide.cu", _WIDE)
WIDE_GRU_RES_KERNEL = _build.Kernel("bigru_wide_residuals", "bigru_wide.cu", _WIDE)
WIDE_GRU_BWD_KERNEL = _build.Kernel("bigru_wide_bwd", "bigru_wide.cu", _WIDE)


def _bf16_empty(device, *shapes):
    return tuple(torch.empty(s, dtype=torch.bfloat16, device=device) for s in shapes)


# -- BiLSTM -----------------------------------------------------------------


def bilstm_hoist(fwd: LSTMParams, bwd: LSTMParams, x: torch.Tensor,
                 compute_dtype=torch.bfloat16):
    """Input gates of both directions, time-major (T, B, 4H), stored in the
    compute dtype (bias folded in)."""
    return tuple(
        input_gates(p, x, compute_dtype).transpose(0, 1).to(compute_dtype).contiguous()
        for p in (fwd, bwd)
    )


def bilstm_recurrence_plain(gxf, gxb, w_hh_f, w_hh_b, compute_dtype=torch.bfloat16,
                            save_residuals: bool = False):
    """(T, B, 4H) gates per direction -> (ysf, ysb) (T, B, H) in the
    compute dtype, both in natural time[, then gf, cf, gb, cb: each
    direction's pre-activation gates and c_{t-1}, compute dtype]."""
    outs = []
    for gx, w, reverse in ((gxf, w_hh_f, False), (gxb, w_hh_b, True)):
        out = recurrence(gx, w, compute_dtype, reverse, save_residuals)
        outs.append((out[0], *out[3:]))
    ys = tuple(o[0].to(compute_dtype) for o in outs)
    res = tuple(r.to(compute_dtype) for o in outs for r in o[1:])
    return (*ys, *res)


def _transposed_bf16(w_hh: torch.Tensor) -> torch.Tensor:
    return w_hh.t().contiguous().to(torch.bfloat16)


def _bf16(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous().to(torch.bfloat16)


def bilstm_recurrence_kernel(gxf, gxb, w_hh_f, w_hh_b, save_residuals: bool = False):
    """Launch ``csrc/bilstm.cu`` on CUDA bf16 hoisted gates."""
    for name, g in (("gxf", gxf), ("gxb", gxb)):
        _build.require_cuda(g, torch.bfloat16, name)
    T, B, H4 = gxf.shape
    H = H4 // 4
    if gxb.shape != gxf.shape or H % 8:
        raise ValueError(f"BiLSTM kernel needs equal gates, H % 8 == 0: {H}")
    groups = fwd_row_groups(2, 0, H, B, _build.card_limits(gxf.device))
    whf = _build.packed(_transposed_bf16, w_hh_f)
    whb = _build.packed(_transposed_bf16, w_hh_b)
    ysf, ysb = _bf16_empty(gxf.device, (T, B, H), (T, B, H))
    res = ()
    if save_residuals:
        res = _bf16_empty(gxf.device, (T, B, H4), (T, B, H), (T, B, H4), (T, B, H))
    res_ptrs = [r.data_ptr() for r in res] or [None] * 4
    (RES_KERNEL if save_residuals else KERNEL).call_groups(
        "mstts_bilstm_fwd",
        (gxf.data_ptr(), gxb.data_ptr(), whf.data_ptr(), whb.data_ptr(), ysf.data_ptr(),
         ysb.data_ptr(), *res_ptrs),
        groups, (T, B, H), _build.stream_ptr(gxf), gxf.device)
    return (ysf, ysb, *res)


def bilstm_recurrence(gxf, gxb, w_hh_f, w_hh_b, compute_dtype=torch.bfloat16,
                      save_residuals: bool = False):
    """The kernel for CUDA tensors (bf16 compute only), the plain version
    for CPU tensors."""
    if gxf.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the BiLSTM kernel computes in bf16 only")
        return bilstm_recurrence_kernel(gxf, gxb, w_hh_f, w_hh_b, save_residuals)
    return bilstm_recurrence_plain(gxf, gxb, w_hh_f, w_hh_b, compute_dtype, save_residuals)


def bilstm_bwd_plain(gf, cf, gb, cb, w_hh_f, w_hh_b, dyf, dyb,
                     compute_dtype=torch.bfloat16):
    """Both directions' reverse passes, step by step as the TPU kernel runs
    them: (dGf, dGb) (T, B, 4H) in the compute dtype. The forward direction
    walks time in reverse, the backward direction natural time."""
    return (recurrence_bwd(w_hh_f, gf, cf, None, dyf, compute_dtype),
            recurrence_bwd(w_hh_b, gb, cb, None, dyb, compute_dtype, natural_time=True))


def bilstm_bwd_kernel(gf, cf, gb, cb, w_hh_f, w_hh_b, dyf, dyb):
    """Launch ``csrc/bilstm_bwd.cu`` on CUDA bf16 residuals and f32 output
    cotangents (T, B, H) per direction."""
    T, B, H4 = gf.shape
    H = H4 // 4
    for name, t, dtype, shape in (("gf", gf, torch.bfloat16, (T, B, H4)),
                                  ("gb", gb, torch.bfloat16, (T, B, H4)),
                                  ("cf", cf, torch.bfloat16, (T, B, H)),
                                  ("cb", cb, torch.bfloat16, (T, B, H)),
                                  ("dyf", dyf, torch.float32, (T, B, H)),
                                  ("dyb", dyb, torch.float32, (T, B, H))):
        _build.require_cuda(t, dtype, name)
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if H % 8 or w_hh_f.shape != (H, H4) or w_hh_b.shape != (H, H4):
        raise ValueError(f"BiLSTM backward kernel needs (H, 4H) weights, H % 8 == 0: {H}")
    groups = bwd_row_groups(2, H, B, _build.card_limits(gf.device))
    whf, whb = _build.packed(_bf16, w_hh_f), _build.packed(_bf16, w_hh_b)
    dGf, dGb = torch.empty_like(gf), torch.empty_like(gb)
    BWD_KERNEL.call_groups(
        "mstts_bilstm_bwd",
        (gf.data_ptr(), cf.data_ptr(), gb.data_ptr(), cb.data_ptr(), whf.data_ptr(),
         whb.data_ptr(), dyf.data_ptr(), dyb.data_ptr(), dGf.data_ptr(), dGb.data_ptr()),
        groups, (T, B, H), _build.stream_ptr(gf), gf.device)
    return dGf, dGb


def bilstm_bwd(gf, cf, gb, cb, w_hh_f, w_hh_b, dyf, dyb, compute_dtype=torch.bfloat16):
    """The backward kernel for CUDA tensors (bf16 compute only), the plain
    version for CPU tensors."""
    if gf.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the BiLSTM backward kernel computes in bf16 only")
        return bilstm_bwd_kernel(gf, cf, gb, cb, w_hh_f, w_hh_b, dyf, dyb)
    return bilstm_bwd_plain(gf, cf, gb, cb, w_hh_f, w_hh_b, dyf, dyb, compute_dtype)


def _shifted(ys: torch.Tensor, reverse: bool) -> torch.Tensor:
    """h_{prev} per step in natural time: ys[t-1] for a forward direction,
    ys[t+1] for a backward one (it consumed time descending); zero at the
    first step either way."""
    zero = torch.zeros_like(ys[:1])
    return torch.cat([ys[1:], zero]) if reverse else torch.cat([zero, ys[:-1]])


def _split_cotangent(dy_out: torch.Tensor):
    """(B, T, 2H) output cotangent -> contiguous f32 (T, B, H) per direction."""
    dy = dy_out.transpose(0, 1).float()
    H = dy.shape[-1] // 2
    return dy[..., :H].contiguous(), dy[..., H:].contiguous()


class _BiLSTM(torch.autograd.Function):
    """Hoist + BiLSTM recurrence with the reverse kernel as its backward
    (``_bilstm_custom``)."""

    @staticmethod
    def forward(ctx, compute_dtype, x, *weights):
        fwd, bwd = LSTMParams(*weights[:3]), LSTMParams(*weights[3:])
        gxf, gxb = bilstm_hoist(fwd, bwd, x, compute_dtype)
        ysf, ysb, *res = bilstm_recurrence(gxf, gxb, fwd.w_hh, bwd.w_hh, compute_dtype,
                                           save_residuals=True)
        ctx.save_for_backward(x, *weights, ysf, ysb, *res)
        ctx.compute_dtype = compute_dtype
        return torch.cat([ysf, ysb], dim=-1).float().transpose(0, 1)

    @staticmethod
    def backward(ctx, dy_out):
        cd = ctx.compute_dtype
        x, *rest = ctx.saved_tensors
        fwd, bwd = LSTMParams(*rest[:3]), LSTMParams(*rest[3:6])
        ysf, ysb, gf, cf, gb, cb = rest[6:]
        dGf, dGb = bilstm_bwd(gf, cf, gb, cb, fwd.w_hh, bwd.w_hh,
                              *_split_cotangent(dy_out), cd)
        x_tm = rounded(x.transpose(0, 1), cd)
        grads = []
        for dG, ys, reverse in ((dGf, ysf, False), (dGb, ysb, True)):
            grads += [seq_gemm(x_tm, dG), seq_gemm(_shifted(ys, reverse), dG),
                      dG.float().sum(dim=(0, 1))]
        dx = dGf.float() @ rounded(fwd.w_ih, cd).t() + dGb.float() @ rounded(bwd.w_ih, cd).t()
        return (None, dx.transpose(0, 1).to(x.dtype), *grads)


def bilstm_refusal(H: int, B: int, grad: bool,
                   card: tuple[int, int] = _build.H100) -> str | None:
    """Why the BiLSTM kernels take no launch at H a direction over B rows on
    ``card`` (the backward too where a gradient is needed), or None."""
    if fwd_rows(2, 0, H, B, card) < 1:
        return f"the BiLSTM kernel takes no launch at H={H}"
    if grad and bwd_rows(2, H, B, card) < 1:
        return f"the BiLSTM backward kernel takes no launch at H={H}"
    return None


def bilstm(fwd: LSTMParams, bwd: LSTMParams, x: torch.Tensor,
           compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H) f32, both directions concatenated. Under
    autograd through :class:`_BiLSTM`, otherwise the inference kernel.
    Where ``bilstm_pallas`` runs its XLA route and the port's kernels do
    not take the layer either (``_build.plain_route``: an f32 compute
    dtype; on the card a width not a multiple of 8 or past the kernels'
    launches), :func:`..lstm.bilstm_fused` runs on the tensors' device."""
    grad = needs_grad(x, *fwd, *bwd)
    H = fwd.hidden_size
    if _build.plain_route("bilstm", x, compute_dtype,
                          lambda: bilstm_refusal(H, x.shape[0], grad, _build.card_limits(x.device)),
                          _build.reference_widths_ok(H)):
        return bilstm_fused(fwd, bwd, x, compute_dtype)
    if grad:
        return _BiLSTM.apply(compute_dtype, x, *fwd, *bwd)
    gxf, gxb = bilstm_hoist(fwd, bwd, x, compute_dtype)
    ysf, ysb = bilstm_recurrence(gxf, gxb, fwd.w_hh, bwd.w_hh, compute_dtype)
    return torch.cat([ysf, ysb], dim=-1).float().transpose(0, 1)


# -- BiGRU ------------------------------------------------------------------


def bigru_hoist(fwd: GRUParams, bwd: GRUParams, x: torch.Tensor,
                compute_dtype=torch.bfloat16):
    """Input gates of both directions, time-major (T, B, 3H), stored in the
    compute dtype (b_ih folded in; b_hh stays with the recurrence)."""
    return tuple(
        gru_ops.input_gates(p, x, compute_dtype).transpose(0, 1).to(compute_dtype).contiguous()
        for p in (fwd, bwd)
    )


def bigru_recurrence_plain(gxf, gxb, fwd: GRUParams, bwd: GRUParams,
                           compute_dtype=torch.bfloat16, save_residuals: bool = False):
    """(T, B, 3H) input gates per direction -> (ysf, ysb) (T, B, H) in the
    compute dtype, both in natural time[, then ghf, hpf, ghb, hpb: each
    direction's recurrent gates and h_{t-1}, compute dtype]."""
    outs = []
    for gx, p, reverse in ((gxf, fwd, False), (gxb, bwd, True)):
        out = gru_ops.recurrence(p, gx, compute_dtype, reverse, save_residuals)
        outs.append(out if save_residuals else (out,))
    ys = tuple(o[0].to(compute_dtype) for o in outs)
    res = tuple(r.to(compute_dtype) for o in outs for r in o[1:])
    return (*ys, *res)


def _f32(b: torch.Tensor) -> torch.Tensor:
    return b.float().contiguous()


# The narrow kernels' widest H: one direction's W_hh in one block.
NARROW_MAX_H = 192
_WIDE_WARPS = 8  # csrc/bigru_wide.cu's kWarps
_WIDE_FULL_ROWS = 32  # its kFullRows: rows the resident layout must hold


def wide_smem_bytes(bwd: bool, U: int, H: int, B: int, NR: int | None = None) -> int:
    """``wide_smem_bytes`` (csrc/bigru_wide.cu): a block's shared memory on
    the wide route, U units of H over B rows with NR rows of its W_hh slice
    resident (forward: of 3U columns of depth H; backward: of U rows of
    depth 3H; None: all of them), the warps' partial tiles, and per row the
    carries and the step's own inputs."""
    NP = _build.round_up(U if bwd else 3 * U, 8)
    BP = _build.round_up(B, 32)
    w = 2 * (NP if NR is None else NR) * _build.k32_stride(3 * H if bwd else H)
    if bwd:
        return w + 4 * (_WIDE_WARPS * BP * NP + 10 * B * U)
    return w + 4 * (_WIDE_WARPS * BP * NP + 4 * B * U + 3 * U)


def wide_layout(bwd: bool, H: int, rows: int, card: tuple[int, int] = _build.H100) -> dict:
    """``wide_layout`` (csrc/bigru_wide.cu) for a launch over ``rows`` rows
    on ``card``: the whole W_hh slice resident (``stream`` False) wherever
    it holds a launch of 32 rows (up to H 1,184 forward, 1,248 backward on
    an H100), else the streamed build with the ``ntr`` n-tiles of 8 (of
    ``nt``) that fit beside the rest resident and the others read from L2
    every step; ``bytes`` a block, ``fits``."""
    n_sm, max_smem = card
    U, nblk = _build.recurrence_grid(2, H, n_sm)
    nt = _build.round_up(U if bwd else 3 * U, 8) // 8
    lay = {"U": U, "nblk": nblk, "nt": nt}
    if wide_smem_bytes(bwd, U, H, _WIDE_FULL_ROWS) <= max_smem:
        nbytes = wide_smem_bytes(bwd, U, H, rows)
        return dict(lay, stream=False, ntr=nt, bytes=nbytes, fits=nbytes <= max_smem)
    base = wide_smem_bytes(bwd, U, H, rows, 0)
    tile = 2 * 8 * _build.k32_stride(3 * H if bwd else H)
    ntr = min(nt, max(0, (max_smem - base) // tile))
    nbytes = base + ntr * tile
    return dict(lay, stream=True, ntr=ntr, bytes=nbytes, fits=nbytes <= max_smem)


@functools.lru_cache(maxsize=1024)
def wide_rows(bwd: bool, H: int, B: int, card: tuple[int, int] = _build.H100) -> int:
    """Rows a launch of the wide route takes: as many of the B as a block's
    shared memory holds on ``card`` (:func:`wide_layout`); 0 if not one."""
    rows = B
    while rows > 0 and not wide_layout(bwd, H, rows, card)["fits"]:
        rows -= 1
    return rows


@functools.lru_cache(maxsize=None)
def wide_max_h(card: tuple[int, int] = _build.H100) -> int:
    """The widest H (a multiple of 16) whose forward and backward take one
    row a launch on ``card`` (4,880 on an H100: past it the warps' partial
    tiles alone outgrow a block)."""
    H = NARROW_MAX_H
    while all(wide_rows(bwd, H + 16, 1, card) for bwd in (False, True)):
        H += 16
    return H


def bigru_route(H: int) -> str:
    """"narrow" (csrc/bigru.cu, csrc/bigru_bwd.cu: W_hh in one block) up to
    H 192, "wide" (csrc/bigru_wide.cu: units split across blocks) above."""
    return "narrow" if H <= NARROW_MAX_H else "wide"


def wide_row_groups(bwd: bool, H: int, B: int, card: tuple[int, int]) -> list:
    """The launches of one wide-route call: groups of :func:`wide_rows`."""
    rows = wide_rows(bwd, H, B, card)
    return [slice(b, min(b + rows, B)) for b in range(0, B, rows)]


def bigru_shape_reason(gx_shape, w_hh_shapes,
                       card: tuple[int, int] = _build.H100) -> str | None:
    """Why neither BiGRU forward route takes these shapes, or None if one
    does: (T, B, 3H) gates, equal for both directions, and (H, 3H) weights
    with H % 16 == 0 (16-deep MMA k-steps); up to H 192 the narrow kernel
    (one direction's W_hh in a block), above it the wide route up to what
    one row's launch fits on ``card`` (:func:`wide_max_h`: 4,880 on an
    H100, the W_hh slice partly streamed from H 1,200). The JAX gate
    (``birnn_pallas.supported``) takes H % 128 == 0."""
    T, B, H3 = gx_shape
    H = H3 // 3
    if T < 1 or B < 1 or H3 % 3 or any(tuple(s) != (H, H3) for s in w_hh_shapes):
        return f"needs (T, B, 3H) gates and (H, 3H) weights, got {tuple(gx_shape)}"
    hmax = wide_max_h(card)
    if H % 16 or not 16 <= H <= hmax:
        return f"needs H % 16 == 0 and 16 <= H <= {hmax} on this card, got H = {H}"
    return None


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """The kernel copies 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def bigru_recurrence_kernel(gxf, gxb, fwd: GRUParams, bwd: GRUParams,
                            save_residuals: bool = False):
    """Launch ``csrc/bigru.cu`` on CUDA bf16 hoisted input gates."""
    for name, g in (("gxf", gxf), ("gxb", gxb)):
        _build.require_cuda(g, torch.bfloat16, name)
    T, B, H3 = gxf.shape
    H = H3 // 3
    reason = (f"needs equal gates, got {tuple(gxf.shape)} and {tuple(gxb.shape)}"
              if gxb.shape != gxf.shape
              else bigru_shape_reason(gxf.shape, (fwd.w_hh.shape, bwd.w_hh.shape),
                                      _build.card_limits(gxf.device)))
    if reason is not None:
        raise ValueError(f"BiGRU kernel {reason}")
    gxf, gxb = _aligned(gxf), _aligned(gxb)
    whf, whb = (_build.packed(_transposed_bf16, w) for w in (fwd.w_hh, bwd.w_hh))
    bhf, bhb = (_build.packed(_f32, b) for b in (fwd.b_hh, bwd.b_hh))
    ysf, ysb = _bf16_empty(gxf.device, (T, B, H), (T, B, H))
    res = ()
    if save_residuals:
        res = _bf16_empty(gxf.device, (T, B, H3), (T, B, H), (T, B, H3), (T, B, H))
    res_ptrs = [r.data_ptr() for r in res] or [None] * 4
    args = (gxf.data_ptr(), gxb.data_ptr(), whf.data_ptr(), whb.data_ptr(), bhf.data_ptr(),
            bhb.data_ptr(), ysf.data_ptr(), ysb.data_ptr(), *res_ptrs)
    if bigru_route(H) == "narrow":
        (GRU_RES_KERNEL if save_residuals else GRU_KERNEL).call(
            "mstts_bigru_fwd", *args, T, B, H, _build.stream_ptr(gxf))
    else:
        (WIDE_GRU_RES_KERNEL if save_residuals else WIDE_GRU_KERNEL).call_groups(
            "mstts_bigru_wide_fwd", args,
            wide_row_groups(False, H, B, _build.card_limits(gxf.device)), (T, B, H),
            _build.stream_ptr(gxf), gxf.device)
    return (ysf, ysb, *res)


def bigru_recurrence(gxf, gxb, fwd: GRUParams, bwd: GRUParams,
                     compute_dtype=torch.bfloat16, save_residuals: bool = False):
    """The kernel for CUDA tensors (bf16 compute only), the plain version
    for CPU tensors."""
    if gxf.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the BiGRU kernel computes in bf16 only")
        return bigru_recurrence_kernel(gxf, gxb, fwd, bwd, save_residuals)
    return bigru_recurrence_plain(gxf, gxb, fwd, bwd, compute_dtype, save_residuals)


def bigru_bwd_plain(gxf, ghf, hpf, gxb, ghb, hpb, w_hh_f, w_hh_b, dyf, dyb,
                    compute_dtype=torch.bfloat16):
    """Both directions' reverse passes, step by step as the TPU kernel runs
    them: (dGxf, dGhf, dGxb, dGhb) (T, B, 3H) in the compute dtype."""
    return (*gru_ops.recurrence_bwd(w_hh_f, gxf, ghf, hpf, dyf, compute_dtype),
            *gru_ops.recurrence_bwd(w_hh_b, gxb, ghb, hpb, dyb, compute_dtype,
                                    natural_time=True))


def bigru_bwd_shape_reason(gx_shape, w_hh_shapes,
                           card: tuple[int, int] = _build.H100) -> str | None:
    """Why neither BiGRU backward route (``csrc/bigru_bwd.cu`` up to H 192,
    ``csrc/bigru_wide.cu`` above) takes these shapes, or None if one does:
    those of the residual-mode forward (:func:`bigru_shape_reason`), whose
    residuals are its only input, on the same route."""
    return bigru_shape_reason(gx_shape, w_hh_shapes, card)


def bigru_bwd_kernel(gxf, ghf, hpf, gxb, ghb, hpb, w_hh_f, w_hh_b, dyf, dyb):
    """Launch ``csrc/bigru_bwd.cu`` on CUDA bf16 residuals and f32 output
    cotangents (T, B, H) per direction. The kernel reads W_hh (H, 3H) in
    bf16 as the layer stores it: row u holds unit u's 3H k values, the A
    operand's row-major layout (:func:`_bf16`, no other packing)."""
    T, B, H3 = gxf.shape
    H = H3 // 3
    for name, t, dtype, shape in (("gxf", gxf, torch.bfloat16, (T, B, H3)),
                                  ("ghf", ghf, torch.bfloat16, (T, B, H3)),
                                  ("gxb", gxb, torch.bfloat16, (T, B, H3)),
                                  ("ghb", ghb, torch.bfloat16, (T, B, H3)),
                                  ("hpf", hpf, torch.bfloat16, (T, B, H)),
                                  ("hpb", hpb, torch.bfloat16, (T, B, H)),
                                  ("dyf", dyf, torch.float32, (T, B, H)),
                                  ("dyb", dyb, torch.float32, (T, B, H))):
        _build.require_cuda(t, dtype, name)
        if t.shape != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    card = _build.card_limits(gxf.device)
    reason = bigru_bwd_shape_reason(gxf.shape, (w_hh_f.shape, w_hh_b.shape), card)
    if reason is not None:
        raise ValueError(f"BiGRU backward kernel {reason}")
    gxf, ghf, hpf, gxb, ghb, hpb, dyf, dyb = (
        _aligned(t) for t in (gxf, ghf, hpf, gxb, ghb, hpb, dyf, dyb))
    wf, wb = (_build.packed(_bf16, w) for w in (w_hh_f, w_hh_b))
    outs = _bf16_empty(gxf.device, *[(T, B, H3)] * 4)
    args = (gxf.data_ptr(), ghf.data_ptr(), hpf.data_ptr(), gxb.data_ptr(), ghb.data_ptr(),
            hpb.data_ptr(), wf.data_ptr(), wb.data_ptr(), dyf.data_ptr(), dyb.data_ptr(),
            *(o.data_ptr() for o in outs))
    if bigru_route(H) == "narrow":
        GRU_BWD_KERNEL.call("mstts_bigru_bwd", *args, T, B, H, _build.stream_ptr(gxf))
    else:
        WIDE_GRU_BWD_KERNEL.call_groups("mstts_bigru_wide_bwd", args,
                                        wide_row_groups(True, H, B, card), (T, B, H),
                                        _build.stream_ptr(gxf), gxf.device)
    return outs


def bigru_bwd(gxf, ghf, hpf, gxb, ghb, hpb, w_hh_f, w_hh_b, dyf, dyb,
              compute_dtype=torch.bfloat16):
    """The backward kernel for CUDA tensors (bf16 compute only), the plain
    version for CPU tensors."""
    if gxf.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the BiGRU backward kernel computes in bf16 only")
        return bigru_bwd_kernel(gxf, ghf, hpf, gxb, ghb, hpb, w_hh_f, w_hh_b, dyf, dyb)
    return bigru_bwd_plain(gxf, ghf, hpf, gxb, ghb, hpb, w_hh_f, w_hh_b, dyf, dyb,
                           compute_dtype)


class _BiGRU(torch.autograd.Function):
    """Hoist + BiGRU recurrence with the reverse kernel as its backward
    (``_bigru_custom``), separate db_ih and db_hh."""

    @staticmethod
    def forward(ctx, compute_dtype, x, *weights):
        fwd, bwd = GRUParams(*weights[:4]), GRUParams(*weights[4:])
        gxf, gxb = bigru_hoist(fwd, bwd, x, compute_dtype)
        ysf, ysb, ghf, hpf, ghb, hpb = bigru_recurrence(gxf, gxb, fwd, bwd, compute_dtype,
                                                        save_residuals=True)
        ctx.save_for_backward(x, *weights, gxf, ghf, hpf, gxb, ghb, hpb)
        ctx.compute_dtype = compute_dtype
        return torch.cat([ysf, ysb], dim=-1).float().transpose(0, 1)

    @staticmethod
    def backward(ctx, dy_out):
        cd = ctx.compute_dtype
        x, *rest = ctx.saved_tensors
        fwd, bwd = GRUParams(*rest[:4]), GRUParams(*rest[4:8])
        gxf, ghf, hpf, gxb, ghb, hpb = rest[8:]
        dGxf, dGhf, dGxb, dGhb = bigru_bwd(gxf, ghf, hpf, gxb, ghb, hpb, fwd.w_hh, bwd.w_hh,
                                           *_split_cotangent(dy_out), cd)
        x_tm = rounded(x.transpose(0, 1), cd)
        grads = []
        for dGx, dGh, hp in ((dGxf, dGhf, hpf), (dGxb, dGhb, hpb)):
            grads += [seq_gemm(x_tm, dGx), seq_gemm(hp, dGh),
                      dGx.float().sum(dim=(0, 1)), dGh.float().sum(dim=(0, 1))]
        dx = dGxf.float() @ rounded(fwd.w_ih, cd).t() + dGxb.float() @ rounded(bwd.w_ih, cd).t()
        return (None, dx.transpose(0, 1).to(x.dtype), *grads)


def bigru(fwd: GRUParams, bwd: GRUParams, x: torch.Tensor,
          compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H) f32, both directions concatenated. Under
    autograd through :class:`_BiGRU`, otherwise the inference kernel.
    Where ``bigru_pallas`` runs its XLA route and the port's kernels do not
    take the layer either (``_build.plain_route``: an f32 compute dtype; on
    the card a width the kernels refuse, :func:`bigru_shape_reason`, that
    is not a multiple of 128), :func:`..gru.bigru_fused` runs on the
    tensors' device."""
    H = fwd.w_hh.shape[0]

    def refusal():
        why = bigru_shape_reason((x.shape[1], x.shape[0], 3 * H),
                                 (fwd.w_hh.shape, bwd.w_hh.shape), _build.card_limits(x.device))
        return why and f"BiGRU kernel {why}"

    if _build.plain_route("bigru", x, compute_dtype, refusal, _build.reference_widths_ok(H)):
        return gru_ops.bigru_fused(fwd, bwd, x, compute_dtype)
    if needs_grad(x, *fwd, *bwd):
        return _BiGRU.apply(compute_dtype, x, *fwd, *bwd)
    gxf, gxb = bigru_hoist(fwd, bwd, x, compute_dtype)
    ysf, ysb = bigru_recurrence(gxf, gxb, fwd, bwd, compute_dtype)
    return torch.cat([ysf, ysb], dim=-1).float().transpose(0, 1)
