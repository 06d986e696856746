"""GE2E LSTM stack on persistent Hopper kernels (one launch per layer and
pass), with its backward.

Forward: replaces ``multi_speaker_tts_tpu/ops/lstm_pallas.py::lstm_seq_layer_fwd``
(kernel body ``_fwd_kernel``) and the stack loop ``lstm_stack_seq_pallas``.
The kernel (``csrc/lstm.cu``) computes the input projection inside the
launch as the TPU kernel does, but ahead of the time loop: x . W_ih + b for
every step on tensor cores into an f32 scratch, then per step
h_{t-1} . W_hh on tensor cores; bf16 operands and f32 accumulation, f32
cell state, outputs stored bf16. Its
residual mode (``save_residuals=True``, counted as :data:`RES_KERNEL`)
also stores the pre-activation gates and c_{t-1} in bf16. A launch takes
up to 32 rows; the wrapper plans the groups (:func:`fwd_row_groups`), one
entry call and one count a group. Where a block's full layout (W_ih and
W_hh resident) does not hold 32 rows, the launch takes the wide one
(:func:`fwd_layout`): W_ih from L2 in phase 0, and the W_hh tiles that do
not fit streamed from L2 each step.

Backward: replaces ``lstm_pallas.py::lstm_seq_layer_bwd`` (kernel body
``_bwd_kernel``). The kernel (``csrc/lstm_bwd.cu``) runs the reverse
recurrence from the residuals and emits dG (T, B, 4H) bf16; the stack's
``torch.autograd.Function`` (:class:`_LSTMStack`, the port of
``_stack_custom`` / ``_stack_fwd`` / ``_stack_bwd``) turns dG into dW_ih,
dW_hh, db and the lower layer's output cotangent with whole-sequence
matrix products, as the JAX package does outside its kernels. A launch
takes a group of the batch's rows: the wrapper plans as many rows a group
as a block's shared memory holds (:func:`bwd_rows`: 352 rows at H 768 on
an H100, so GE2E's 640-row batch takes two), the kernel refuses a group
that does not fit, and each launch counts. Where one row does not fit
beside the resident W_hh rows, or a block owns more than 16 units, the
launch takes the wide layout (:func:`bwd_layout`: the W_hh tiles past
those that fit read from L2).

:func:`lstm_seq_layer_plain` and :func:`lstm_seq_layer_bwd_plain` are the
same layer in plain torch: the CPU path (in any compute dtype) and the
card's yardstick.
"""

from __future__ import annotations

import functools

import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops.lstm import (
    LSTMParams,
    cell,
    input_gates,
    lstm_stack,
    recurrence,
    recurrence_bwd,
)
from multi_speaker_tts_tpu_torch.ops.numerics import needs_grad, rounded, seq_gemm

_FWD = {"mstts_lstm_layer_fwd": [_build.P] * 10 + [_build.I] * 6 + [_build.P],
        "mstts_lstm_fwd_layout": [_build.I] * 5 + [_build.P]}
KERNEL = _build.Kernel("ge2e_lstm", "lstm.cu", _FWD)
RES_KERNEL = _build.Kernel("ge2e_lstm_residuals", "lstm.cu", _FWD)
BWD_KERNEL = _build.Kernel("ge2e_lstm_bwd", "lstm_bwd.cu", {
    "mstts_lstm_layer_bwd": [_build.P] * 7 + [_build.I] * 5 + [_build.P],
    "mstts_lstm_bwd_layout": [_build.I] * 4 + [_build.P],
})


def lstm_seq_layer_plain(p: LSTMParams, x_tm: torch.Tensor,
                         compute_dtype=torch.bfloat16, save_residuals: bool = False):
    """One layer over time-major (T, B, D): (ys (T, B, H) in the compute
    dtype, h_T (B, H) f32, c_T (B, H) f32[, gates (T, B, 4H), c_prev
    (T, B, H) in the compute dtype])."""
    out = recurrence(input_gates(p, x_tm, compute_dtype), p.w_hh, compute_dtype,
                     save_residuals=save_residuals)
    ys, h, c = out[:3]
    res = tuple(r.to(compute_dtype) for r in out[3:])
    return (ys.to(compute_dtype), h, c, *res)


def _kernel_layout(w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor):
    """[W_ih; W_hh]^T as (4H, D + H) bf16 rows and the f32 bias."""
    return (torch.cat([w_ih, w_hh], dim=0).t().contiguous().to(torch.bfloat16),
            b.float().contiguous())


def _bf16(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous().to(torch.bfloat16)


# csrc/lstm_persistent.cuh's constants: warps a block (the full layout's
# partial-tile slots), the wide layout's slots, rows a launch.
_FWD_WARPS, _FWD_WIDE_SLOTS, FWD_MAX_ROWS = 8, 4, 32


def _ldmatrix_stride(k: int) -> int:
    return _build.round_up(k, 16) + 8


def fwd_base_bytes(U: int, H: int, B: int, slots: int = _FWD_WARPS) -> int:
    """``lstm_base_bytes`` (csrc/lstm_persistent.cuh): a block's shared
    memory for U units of H over B rows, the weights aside: h_{t-1}, the
    partial tiles of ``slots`` slots, the input half, c and the residual
    tile."""
    NP, BP = _build.round_up(4 * U, 8), _build.round_up(B, 16)
    return (2 * BP * _ldmatrix_stride(H) + 4 * (slots * BP * NP + B * NP + B * U)
            + 2 * (B * 4 * U + B * U))


def fwd_smem_bytes(U: int, D: int, H: int, B: int) -> int:
    """``lstm_smem_bytes``: the full layout, the base and the block's W_ih
    and W_hh columns."""
    NP = _build.round_up(4 * U, 8)
    return (fwd_base_bytes(U, H, B)
            + 2 * NP * ((_build.k32_stride(D) if D > 0 else 0) + _ldmatrix_stride(H)))


def fwd_layout(ndir: int, D: int, H: int, B: int, rows: int,
               card: tuple[int, int] = _build.H100) -> dict:
    """``lstm_layout`` (csrc/lstm_persistent.cuh): a launch over ``rows`` of
    a batch of B on ``card`` (SMs, opt-in bytes). The full layout wherever
    it holds min(B, 32) rows (every production width), else the wide one:
    W_ih from L2, half the partial tiles, and of W_hh's n-tiles of 8 gate
    columns the ``ntr`` that fit beside the base resident, the rest
    streamed each step."""
    n_sm, max_smem = card
    U, nblk = _build.recurrence_grid(ndir, H, n_sm)
    NT = _build.round_up(4 * U, 8) // 8
    wide = fwd_smem_bytes(U, D, H, min(B, FWD_MAX_ROWS)) > max_smem
    if not wide:
        ntr, nbytes = NT, fwd_smem_bytes(U, D, H, rows)
    else:
        base = fwd_base_bytes(U, H, rows, _FWD_WIDE_SLOTS)
        tile = 2 * 8 * _ldmatrix_stride(H)
        ntr = min(NT, (max_smem - base) // tile) if base <= max_smem else 0
        nbytes = base + ntr * tile
    return {"U": U, "nblk": nblk, "wide": wide, "ntr": ntr, "bytes": nbytes,
            "fits": nbytes <= max_smem and rows <= FWD_MAX_ROWS}


@functools.lru_cache(maxsize=1024)
def fwd_rows(ndir: int, D: int, H: int, B: int, card: tuple[int, int] = _build.H100) -> int:
    """Rows a launch of the forward takes: the most, up to 32, whose layout
    fits on ``card``; 0 if not one (or D, H not multiples of 8)."""
    if D % 8 or H % 8:
        return 0
    rows = min(B, FWD_MAX_ROWS)
    while rows > 0 and not fwd_layout(ndir, D, H, B, rows, card)["fits"]:
        rows -= 1
    return rows


def _groups(rows: int, B: int) -> list:
    return [slice(b, min(b + rows, B)) for b in range(0, B, rows)]


def fwd_row_groups(ndir: int, D: int, H: int, B: int,
                   card: tuple[int, int] = _build.H100) -> list:
    """The launches of one forward call: consecutive groups of
    :func:`fwd_rows` rows (the last takes the rest). Raises where the
    kernel takes no launch."""
    rows = fwd_rows(ndir, D, H, B, card)
    if rows < 1:
        raise ValueError(f"LSTM kernel needs D, H multiples of 8 and one row's launch in a "
                         f"block's shared memory: D={D}, H={H}, {ndir} direction(s)")
    return _groups(rows, B)


def lstm_seq_layer_kernel(p: LSTMParams, x_tm: torch.Tensor, save_residuals: bool = False):
    """Launch ``csrc/lstm.cu`` on a CUDA bf16 (T, B, D) input."""
    _build.require_cuda(x_tm, torch.bfloat16, "x_tm")
    T, B, D = x_tm.shape
    H = p.hidden_size
    if p.w_ih.shape != (D, 4 * H) or D % 8 or H % 8:
        raise ValueError(f"LSTM kernel needs D, H multiples of 8: D={D}, H={H}")
    groups = fwd_row_groups(1, D, H, B, _build.card_limits(x_tm.device))
    w, b = _build.packed(_kernel_layout, p.w_ih, p.w_hh, p.b)
    dev = x_tm.device
    xg = torch.empty((T, B, 4 * H), dtype=torch.float32, device=dev)  # the kernel's phase 0
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    h_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    c_T = torch.empty_like(h_T)
    res = ()
    if save_residuals:
        res = (torch.empty((T, B, 4 * H), dtype=torch.bfloat16, device=dev),
               torch.empty((T, B, H), dtype=torch.bfloat16, device=dev))
    res_ptrs = [r.data_ptr() for r in res] or [None, None]
    (RES_KERNEL if save_residuals else KERNEL).call_groups(
        "mstts_lstm_layer_fwd",
        (x_tm.data_ptr(), w.data_ptr(), b.data_ptr(), xg.data_ptr(), ys.data_ptr(),
         h_T.data_ptr(), c_T.data_ptr(), *res_ptrs),
        groups, (T, B, D, H), _build.stream_ptr(x_tm), dev)
    return (ys, h_T, c_T, *res)


def lstm_seq_layer_fwd(p: LSTMParams, x_tm: torch.Tensor,
                       compute_dtype=torch.bfloat16, save_residuals: bool = False):
    """The kernel for a CUDA tensor (bf16 compute only), the plain version
    for a CPU tensor."""
    if x_tm.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the LSTM kernel computes in bf16 only")
        return lstm_seq_layer_kernel(p, x_tm.to(torch.bfloat16).contiguous(), save_residuals)
    return lstm_seq_layer_plain(p, x_tm, compute_dtype, save_residuals)


def lstm_seq_layer_bwd_plain(w_hh: torch.Tensor, gates: torch.Tensor, c_prev: torch.Tensor,
                             d_hT: torch.Tensor | None, d_ys: torch.Tensor | None,
                             compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The reverse pass of one layer, step by step as the TPU kernel runs
    it: dG (T, B, 4H) in the compute dtype."""
    return recurrence_bwd(w_hh, gates, c_prev, d_hT, d_ys, compute_dtype)


# csrc/lstm_bwd.cuh's constants: warps a block, n-tiles of 8 units a block
# in the production build and in the wide one.
_BWD_WARPS, _BWD_MAX_NT, _BWD_WIDE_NT = 8, 2, 8


def bwd_base_bytes(U: int, B: int) -> int:
    """``lstm_bwd_base_bytes`` (csrc/lstm_bwd.cuh): a block's shared memory
    for U units over B rows, W_hh aside: the warps' partial tiles, the
    carries, the residuals and the dG tile."""
    NP, BP = _build.round_up(U, 8), _build.round_up(B, 32)
    return 4 * (_BWD_WARPS * BP * NP + 8 * B * U) + 2 * B * 4 * U


def bwd_smem_bytes(U: int, H: int, B: int) -> int:
    """``lstm_bwd_smem_bytes``: the full layout, the base and the block's
    resident W_hh rows."""
    return 2 * _build.round_up(U, 8) * _build.k32_stride(4 * H) + bwd_base_bytes(U, B)


def bwd_layout(ndir: int, H: int, B: int, rows: int,
               card: tuple[int, int] = _build.H100) -> dict:
    """``lstm_bwd_layout`` (csrc/lstm_bwd.cuh): a launch over ``rows`` of a
    batch of B on ``card``. The full layout and the production build
    wherever it holds min(B, 32) rows within 16 units a block, else the
    wide build (up to 64 units a block): of W_hh's n-tiles of 8 rows the
    ``ntr`` that fit beside the base resident, the rest read from L2."""
    n_sm, max_smem = card
    U, nblk = _build.recurrence_grid(ndir, H, n_sm)
    NT = -(-U // 8)
    wide = NT > _BWD_MAX_NT or bwd_smem_bytes(U, H, min(B, 32)) > max_smem
    if not wide:
        ntr, nbytes = NT, bwd_smem_bytes(U, H, rows)
    else:
        base, tile = bwd_base_bytes(U, rows), 2 * 8 * _build.k32_stride(4 * H)
        ntr = min(NT, (max_smem - base) // tile) if base <= max_smem else 0
        nbytes = base + ntr * tile
    return {"U": U, "nblk": nblk, "wide": wide, "ntr": ntr, "bytes": nbytes,
            "fits": nbytes <= max_smem and NT <= (_BWD_WIDE_NT if wide else _BWD_MAX_NT)}


@functools.lru_cache(maxsize=1024)
def bwd_rows(ndir: int, H: int, B: int, card: tuple[int, int] = _build.H100) -> int:
    """Rows a launch of the reverse recurrence takes: as many of the B as
    its layout (:func:`bwd_layout`) fits on ``card`` (SMs, opt-in bytes);
    0 if not one."""
    rows = B
    while rows > 0 and not bwd_layout(ndir, H, B, rows, card)["fits"]:
        rows -= 1
    return rows


def bwd_row_groups(ndir: int, H: int, B: int, card: tuple[int, int] = _build.H100) -> list:
    """The launches of one call: consecutive groups of :func:`bwd_rows` rows
    (the last takes the rest). Raises where the kernel takes no launch."""
    rows = bwd_rows(ndir, H, B, card)
    if rows < 1:
        raise ValueError(f"LSTM backward kernel needs at most {8 * _BWD_WIDE_NT} units a "
                         f"block and one row in a block's shared memory: H={H}, "
                         f"{ndir} direction(s)")
    return _groups(rows, B)


def lstm_seq_layer_bwd_kernel(w_hh: torch.Tensor, gates: torch.Tensor, c_prev: torch.Tensor,
                              d_hT: torch.Tensor | None, d_ys: torch.Tensor | None):
    """Launch ``csrc/lstm_bwd.cu`` on CUDA bf16 residuals and f32
    cotangents (either may be None: zero)."""
    _build.require_cuda(gates, torch.bfloat16, "gates")
    _build.require_cuda(c_prev, torch.bfloat16, "c_prev")
    T, B, H4 = gates.shape
    H = H4 // 4
    if w_hh.shape != (H, H4) or c_prev.shape != (T, B, H) or H % 8:
        raise ValueError(f"LSTM backward kernel needs (T, B, 4H) gates, H % 8 == 0: H={H}")
    for name, t, shape in (("d_hT", d_hT, (B, H)), ("d_ys", d_ys, (T, B, H))):
        if t is not None:
            _build.require_cuda(t, torch.float32, name)
            if t.shape != shape:
                raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    groups = bwd_row_groups(1, H, B, _build.card_limits(gates.device))
    w = _build.packed(_bf16, w_hh)
    dG = torch.empty_like(gates)
    BWD_KERNEL.call_groups(
        "mstts_lstm_layer_bwd",
        (gates.data_ptr(), c_prev.data_ptr(), w.data_ptr(),
         None if d_hT is None else d_hT.data_ptr(), None if d_ys is None else d_ys.data_ptr(),
         dG.data_ptr()),
        groups, (T, B, H), _build.stream_ptr(gates), gates.device)
    return dG


def lstm_seq_layer_bwd(w_hh, gates, c_prev, d_hT, d_ys, compute_dtype=torch.bfloat16):
    """The backward kernel for CUDA tensors (bf16 compute only), the plain
    version for CPU tensors."""
    if gates.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the LSTM backward kernel computes in bf16 only")
        return lstm_seq_layer_bwd_kernel(w_hh, gates, c_prev, d_hT, d_ys)
    return lstm_seq_layer_bwd_plain(w_hh, gates, c_prev, d_hT, d_ys, compute_dtype)


def _rebuild_h(gates: torch.Tensor, c_prev: torch.Tensor) -> torch.Tensor:
    """The layer's outputs h_t (f32) from its residuals."""
    return cell(gates.float(), c_prev.float())[0]


class _LSTMStack(torch.autograd.Function):
    """The stack with the reverse kernels as its backward (``_stack_custom``).

    Saves each layer's input (the compute-dtype sequence it read) and its
    residuals. The backward walks the layers top down: the last layer gets
    the h_T cotangent, the others a zero one at their own width; the last
    layer's h sequence is rebuilt from its residuals (the others' is the
    next layer's saved input); dW_ih = x^T dG, dW_hh = h_prev^T dG,
    db = sum dG and the lower layer's output cotangent dG . W_ih^T are
    whole-sequence products with f32 sums."""

    @staticmethod
    def forward(ctx, compute_dtype, x, *weights):
        layers = [LSTMParams(*weights[i:i + 3]) for i in range(0, len(weights), 3)]
        ys = x.transpose(0, 1).to(compute_dtype).contiguous()
        inputs, residuals = [], []
        h_T = None
        for p in layers:
            inputs.append(ys)
            ys, h_T, _, gates, c_prev = lstm_seq_layer_fwd(p, ys, compute_dtype,
                                                           save_residuals=True)
            residuals += [gates, c_prev]
        ctx.save_for_backward(*weights, *inputs, *residuals)
        ctx.compute_dtype, ctx.n_layers, ctx.x_dtype = compute_dtype, len(layers), x.dtype
        ctx.set_materialize_grads(False)
        return ys.transpose(0, 1).float(), h_T

    @staticmethod
    def backward(ctx, d_ys_out, d_hT):
        cd, n = ctx.compute_dtype, ctx.n_layers
        saved = ctx.saved_tensors
        layers = [LSTMParams(*saved[3 * i:3 * i + 3]) for i in range(n)]
        inputs = saved[3 * n:4 * n]
        residuals = saved[4 * n:]
        d_ys = None if d_ys_out is None else d_ys_out.transpose(0, 1).float().contiguous()
        grads = [None] * (3 * n)
        for li in range(n - 1, -1, -1):
            p = layers[li]
            gates, c_prev = residuals[2 * li], residuals[2 * li + 1]
            last = li == n - 1
            dh = d_hT.float().contiguous() if last and d_hT is not None else None
            dG = lstm_seq_layer_bwd(p.w_hh, gates, c_prev, dh, d_ys, cd)
            h_seq = _rebuild_h(gates, c_prev).to(cd) if last else inputs[li + 1]
            h_prev = torch.cat([torch.zeros_like(h_seq[:1]), h_seq[:-1]])
            grads[3 * li:3 * li + 3] = (seq_gemm(inputs[li], dG), seq_gemm(h_prev, dG),
                                        dG.float().sum(dim=(0, 1)))
            d_ys = (dG.float() @ rounded(p.w_ih, cd).t()).contiguous()
        return (None, d_ys.transpose(0, 1).to(ctx.x_dtype), *grads)


def stack_refusal(layers, B: int, grad: bool, card: tuple[int, int] = _build.H100):
    """Why the kernels take no launch for this stack over B rows on
    ``card`` (forward, and the backward where a gradient is needed), or
    None."""
    for p in layers:
        D, H = p.w_ih.shape[0], p.hidden_size
        if fwd_rows(1, D, H, B, card) < 1:
            return f"the LSTM kernel takes no launch at D={D}, H={H}"
        if grad and bwd_rows(1, H, B, card) < 1:
            return f"the LSTM backward kernel takes no launch at H={H}"
    return None


def lstm_stack_seq(layers, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """Stacked layers, layer by layer over (B, T, D): (last layer's outputs
    (B, T, H) f32, its final hidden state (B, H) f32). Under autograd (a
    weight or ``x`` needs a gradient) the residual mode and the backward
    kernels run through :class:`_LSTMStack`; otherwise the inference
    kernel, which stores no residuals. Where the JAX package runs its XLA
    wavefront instead of its kernels, as ``lstm_stack_seq_pallas`` does
    (``_build.plain_route``), and the port's kernels do not take the stack
    either, the plain stack :func:`..lstm.lstm_stack` runs on the tensors'
    device, under autograd where a gradient is needed: a compute dtype
    other than bf16 (an f32 checkpoint), or on the card a width that is
    not a multiple of 8 or past the kernels' launches."""
    weights = [t for p in layers for t in p]
    grad = needs_grad(x, *weights)
    if _build.plain_route("ge2e_lstm", x, compute_dtype,
                          lambda: stack_refusal(layers, x.shape[0], grad,
                                                _build.card_limits(x.device)),
                          _build.reference_widths_ok(*(p.hidden_size for p in layers))):
        return lstm_stack(layers, x, compute_dtype)
    if grad:
        return _LSTMStack.apply(compute_dtype, x, *weights)
    ys = x.transpose(0, 1).to(compute_dtype).contiguous()
    h_T = None
    for p in layers:
        ys, h_T, _ = lstm_seq_layer_fwd(p, ys, compute_dtype)
    return ys.transpose(0, 1).float(), h_T
