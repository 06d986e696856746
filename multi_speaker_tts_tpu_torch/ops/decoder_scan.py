"""Tacotron decoder frame loops (port of ``multi_speaker_tts_tpu.ops.decoder_scan``):
the autoregressive decode and the teacher-forced scan.

One decoder frame (:func:`decoder_cell_step`): attention LSTM over
[prenet(prev), context] with fused [W_ih; W_hh] gates, location-sensitive
attention (SAME 31-tap conv over [w_prev, cum_prev], f32 energies, -1e9
mask), context, decoder LSTM stack, then the frame / stop projections. The
loop here is a Python loop: the default decode and the weight-only int8
reference (:func:`quantize_fused`, the int8 arm of :func:`_gates`).

The AR loops (:func:`decoder_ar_early_exit`, :func:`decoder_ar_scan`) run
K steps at a time through a chunk body, whatever the route: ``(keys,
memory, mask, carry, prev, t0, stopped, lengths, K, stop_threshold,
rows=None) -> (carry, prev, stopped, lengths, frames (K, B, mel*r), stops
(K, B), aligns (K, B, S))``, ``rows`` the batch rows the state holds (None
for every row). :func:`plain_body` makes the plain loop's;
:func:`..decode_kernel.kernel_body` the K-step kernel's of the ``*_pallas``
serving modes; ``models/tacotron.py`` ``Decoder._ar_setup`` picks one.

The plain body's prenet runs through the caller's ``prenet_fn(frame, t,
rows)`` (t = global step; ``models.layers.prenet_step``), as the JAX module
takes ``prenet_apply_fn``: its always-on dropout draws its keep masks per
step for the whole batch, so tests can feed the JAX package's own draws and
production draws from a ``torch.Generator``.

The teacher-forced scan of training (:func:`decoder_tf_scan`) runs the same
cell over prenet-ed teacher frames as a ``torch.autograd.Function`` with the
JAX package's hand-written backward (``decoder_tf_scan``'s custom VJP). Its
forward runs without a graph and keeps per step the gates, h and c of each
layer and the context in the compute dtype; its backward is a reverse loop
over small state that emits each layer's gate gradients dG_t (the cell's
VJP in f32, one ``dG @ [W_ih; W_hh]^T`` product a layer, the attention
block's VJP written out on the recomputed block) and forms every weight
gradient after the loop as one GEMM over T x B rows, and the memory
gradient as one contraction. :func:`decoder_tf_scan_ref`, the same loop
under autograd, is the tests' oracle.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams, cell
from multi_speaker_tts_tpu_torch.ops.numerics import needs_grad, rounded, seq_gemm


class AttentionParams(NamedTuple):
    wq: torch.Tensor  # (H, A) query projection
    conv_kernel: torch.Tensor  # (K, 2, C) location conv
    wloc: torch.Tensor  # (C, A) location projection
    v: torch.Tensor  # (A, 1) energy projection


class DecoderParams(NamedTuple):
    lstm: tuple  # LSTMParams per layer; layer 0 is the attention RNN
    attention: AttentionParams
    frame_proj: tuple  # (kernel (X, mel*r), bias)
    stop_proj: tuple  # (kernel (X, 1), bias)


class DecoderCarry(NamedTuple):
    h: tuple  # per-layer hidden states (B, H), f32
    c: tuple  # per-layer cell states (B, H), f32
    weights: torch.Tensor  # (B, S) previous attention weights
    cum_weights: torch.Tensor  # (B, S) cumulative attention weights
    context: torch.Tensor  # (B, D_mem) previous context


def initial_carry(batch: int, memory: torch.Tensor, n_layers: int,
                  hidden: int) -> DecoderCarry:
    """Zero states; attention pinned to the first memory position."""
    S = memory.shape[1]
    w0 = memory.new_zeros((batch, S), dtype=torch.float32)
    w0[:, 0] = 1.0
    zeros = lambda: memory.new_zeros((batch, hidden), dtype=torch.float32)  # noqa: E731
    return DecoderCarry(
        h=tuple(zeros() for _ in range(n_layers)),
        c=tuple(zeros() for _ in range(n_layers)),
        weights=w0,
        cum_weights=w0.clone(),
        context=memory.new_zeros((batch, memory.shape[-1]), dtype=torch.float32),
    )


def fused_weights(lstm: tuple, compute_dtype) -> tuple:
    """Per-layer [W_ih; W_hh] (D+H, 4H), rounded to the compute dtype once."""
    return tuple(
        rounded(torch.cat([q.w_ih, q.w_hh], dim=0), compute_dtype) for q in lstm
    )


def quantize_w(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-output-channel int8: (int8 (D, N), scale f32 (N,)) with
    column c = round(W[:, c] / s_c), s_c = max|W[:, c]| / 127 (at least
    1e-12), rounding half to even."""
    w = w.float()
    scale = torch.clamp(w.abs().amax(dim=0) / 127.0, min=1e-12)
    return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale


def _quantize_cat(w_ih: torch.Tensor, w_hh: torch.Tensor):
    return quantize_w(torch.cat([w_ih, w_hh], dim=0))


def quantize_fused(p: DecoderParams) -> tuple:
    """Per-layer [W_ih; W_hh] as (int8 weights (D+H, 4H), f32 scale (4H,))
    for the weight-only int8 decode; quantized once per weight state."""
    return tuple(_build.packed(_quantize_cat, q.w_ih, q.w_hh) for q in p.lstm)


def quantize_rows(xh: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row activation quantization: (integer-valued
    f32 in [-127, 127], amax (B, 1)) with amax = max(max|x|, 1e-8) / 127."""
    amax = torch.clamp(xh.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(xh / amax), -127, 127), amax


def int8_product(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """xq (B, K) integer-valued @ wq (K, N) int8 -> (B, N) f32, exact as an
    s32 accumulation: sums reach 2816 * 127^2 > 2^24, so an f32 matmul would
    round. int32 on the CPU; f64 on the card (no integer matmul there)."""
    if xq.is_cuda:
        return (xq.double() @ wq.double()).float()
    return (xq.to(torch.int32) @ wq.to(torch.int32)).float()


def _gates(w_cat, b: torch.Tensor, x: torch.Tensor, h: torch.Tensor,
           compute_dtype) -> torch.Tensor:
    """Pre-activation gates (B, 4H) f32 from one [x, h] @ W product.
    ``w_cat`` is the (D+H, 4H) compute-dtype matrix or a
    :func:`quantize_fused` (int8, scale) pair; the quantized arm quantizes
    the activation row and dequantizes the exact integer sum with the
    product of the two scales."""
    xh = torch.cat([x, h], dim=-1)
    if isinstance(w_cat, tuple):
        wq, wscale = w_cat
        xq, amax = quantize_rows(xh.float())
        return int8_product(xq, wq) * (amax * wscale[None, :]) + b
    return rounded(xh, compute_dtype) @ w_cat + b


def _conv_windows(x: torch.Tensor, K: int, left: int) -> torch.Tensor:
    """(B, S, Cin) -> (B, S, Cin K) windows of a 1-D correlation padded
    ``left`` on the left and K - 1 - left on the right (index c K + d)."""
    B, S, Cin = x.shape
    xp = F.pad(x, (0, 0, left, K - 1 - left))
    return xp.unfold(1, K, 1).reshape(B, S, Cin * K)


def location_conv(loc_in: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 1-D cross-correlation (B, S, Cin) x (K, Cin, C) -> (B, S, C), as
    one f32 matmul over the unfolded windows."""
    K, Cin, C = kernel.shape
    return _conv_windows(loc_in, K, (K - 1) // 2) @ kernel.permute(1, 0, 2).reshape(Cin * K, C)


def attention_block(h0, w_prev, cum_prev, keys, ap: AttentionParams, mask,
                    keep: list | None = None):
    """One location-sensitive attention step -> (weights, cumulative). With
    a ``keep`` list, the step's conv windows, conv output and tanh features
    are appended to it (for the scan's backward)."""
    K, Cin, C = ap.conv_kernel.shape
    win = _conv_windows(torch.stack([w_prev, cum_prev], dim=-1), K, (K - 1) // 2)
    conv = win @ ap.conv_kernel.permute(1, 0, 2).reshape(Cin * K, C)
    z = torch.tanh((h0.float() @ ap.wq)[:, None, :] + keys + conv @ ap.wloc)
    energies = (z @ ap.v)[..., 0]
    energies = torch.where(mask > 0, energies, torch.full_like(energies, -1e9))
    w = torch.softmax(energies, dim=-1)
    if keep is not None:
        keep.append((win, conv, z))
    return w, cum_prev + w


def decoder_cell_step(p: DecoderParams, fused: tuple, carry: DecoderCarry,
                      pre_t, keys, memory, mask, compute_dtype, saved: dict | None = None):
    """One decoder frame -> (carry', x_t = [h_last, context], w_t). With a
    ``saved`` dict, each layer's pre-activation gates go to its ``gates``
    list and the attention step's intermediates to its ``attention`` list."""
    hs, cs = list(carry.h), list(carry.c)
    attn_in = torch.cat([pre_t, carry.context], dim=-1)
    g = _gates(fused[0], p.lstm[0].b, attn_in, hs[0], compute_dtype)
    hs[0], cs[0] = cell(g, cs[0])
    gates = [g]
    keep = None if saved is None else saved["attention"]
    w, cum = attention_block(hs[0], carry.weights, carry.cum_weights, keys,
                             p.attention, mask, keep=keep)
    context = torch.bmm(w[:, None, :], memory.float())[:, 0]
    x = torch.cat([hs[0], context], dim=-1)
    for i in range(1, len(p.lstm)):
        g = _gates(fused[i], p.lstm[i].b, x, hs[i], compute_dtype)
        hs[i], cs[i] = cell(g, cs[i])
        gates.append(g)
        x = torch.cat([hs[i], context], dim=-1)
    if saved is not None:
        saved["gates"].append(gates)
    return DecoderCarry(tuple(hs), tuple(cs), w, cum, context), x, w


def decoder_tf_scan_ref(p: DecoderParams, pre_seq, keys, memory, mask,
                        compute_dtype=torch.float32):
    """Teacher-forced scan over prenet-ed frames (T, B, P) -> (xs (T, B,
    H + D_mem) = [h_last, context] per step, attention weights (T, B, S)):
    a Python loop of :func:`decoder_cell_step` from the zero carry under
    autograd. The oracle of :func:`decoder_tf_scan` in the tests."""
    B = memory.shape[0]
    carry = initial_carry(B, memory, len(p.lstm), p.lstm[0].hidden_size)
    fused = fused_weights(p.lstm, compute_dtype)
    xs, ws = [], []
    for t in range(pre_seq.shape[0]):
        carry, x, w = decoder_cell_step(p, fused, carry, pre_seq[t], keys, memory, mask,
                                        compute_dtype)
        xs.append(x)
        ws.append(w)
    return torch.stack(xs), torch.stack(ws)


def _cell_bwd(g: torch.Tensor, c_prev: torch.Tensor, dh: torch.Tensor, dc: torch.Tensor):
    """VJP of :func:`..ops.lstm.cell` from f32 gates g (B, 4H) and c_prev
    for the cotangents (dh, dc) of (h, c) -> (dg, dc_prev), c recomputed:
    :func:`..ops.lstm.cell_bwd`'s arithmetic in fewer operations (one
    sigmoid over all gates, the gates' derivatives as one product)."""
    H = g.shape[1] // 4
    s = torch.sigmoid(g)
    i, f, o = s[:, :H], s[:, H:2 * H], s[:, 3 * H:]
    gg = torch.tanh(g[:, 2 * H:3 * H])
    tc = torch.tanh(f * c_prev + i * gg)
    dc = dc + dh * o * (1.0 - tc * tc)
    sd = s * (1.0 - s)
    deriv = torch.cat([sd[:, :2 * H], 1.0 - gg * gg, sd[:, 3 * H:]], dim=1)
    return torch.cat([dc * gg, dc * c_prev, dc * i, dh * tc], dim=1) * deriv, dc * f


class _TFScan(torch.autograd.Function):
    """The teacher-forced scan with the JAX package's hand-written backward.
    Inputs: (keep, n_layers, compute_dtype, mask, pre_seq, keys, memory, then
    w_ih, w_hh, b of each layer, then wq, conv_kernel, wloc, v); ``keep``
    False (no gradient wanted) runs the forward and keeps nothing.

    The forward keeps, stacked over steps: each layer's gates, h and c and
    the context in the compute dtype (the JAX residuals), the attention
    weights, and the attention step's conv windows, conv output and tanh
    features in f32. The backward's reverse loop carries (dh, dc) a layer,
    the context's, weights' and cumulative weights' cotangents, and emits
    per step the gate gradients (f32) and the attention block's
    intermediate cotangents; every weight gradient, the keys' and the
    memory's are then one product or sum over all steps."""

    @staticmethod
    def forward(ctx, keep, n, cd, mask, pre_seq, keys, memory, *ws):
        lstm = tuple(LSTMParams(*ws[3 * i:3 * i + 3]) for i in range(n))
        p = DecoderParams(lstm, AttentionParams(*ws[3 * n:]), None, None)
        B = memory.shape[0]
        carry = initial_carry(B, memory, n, lstm[0].hidden_size)
        fused = fused_weights(lstm, cd)
        saved = {"gates": [], "attention": []} if keep else None
        xs, w_seq, h_seq, c_seq, ctx_seq = [], [], [], [], []
        for t in range(pre_seq.shape[0]):
            carry, x, w = decoder_cell_step(p, fused, carry, pre_seq[t], keys, memory, mask,
                                            cd, saved)
            xs.append(x)
            w_seq.append(w)
            if keep:
                h_seq.append(carry.h)
                c_seq.append(carry.c)
                ctx_seq.append(carry.context)
        xs, w_seq = torch.stack(xs), torch.stack(w_seq)
        if not keep:
            return xs, w_seq
        stack = lambda seq: [torch.stack(s) for s in zip(*seq)]  # noqa: E731
        res = [torch.stack(ctx_seq).to(cd)]
        for seq in (saved["gates"], h_seq, c_seq):
            res += [x.to(cd) for x in stack(seq)]
        ctx.n, ctx.cd = n, cd
        ctx.save_for_backward(mask, pre_seq, keys, memory, w_seq, *stack(saved["attention"]),
                              *res, *ws)
        return xs, w_seq

    @staticmethod
    def backward(ctx, d_xs, d_ws):
        n, cd = ctx.n, ctx.cd
        (mask, pre_seq, keys, memory, w_seq, win_seq, conv_seq, z_seq, ctx_seq,
         *rest) = ctx.saved_tensors
        g_seq, h_seq, c_seq, ws = rest[:n], rest[n:2 * n], rest[2 * n:3 * n], rest[3 * n:]
        lstm = tuple(LSTMParams(*ws[3 * i:3 * i + 3]) for i in range(n))
        ap = AttentionParams(*ws[3 * n:])
        T, B, P = pre_seq.shape
        H = lstm[0].hidden_size
        S, D = memory.shape[1:]
        K, Cin, C = ap.conv_kernel.shape
        lo = (K - 1) // 2
        mem = memory.float()
        valid = mask > 0
        v = ap.v[:, 0]
        wloc_t = ap.wloc.t()
        wq_t = ap.wq.t()
        # The conv input's gradient: the correlation with the flipped,
        # transposed kernel, padded K - 1 - lo on the left.
        kflip = ap.conv_kernel.flip(0).permute(2, 0, 1).reshape(C * K, Cin)
        zero = memory.new_zeros((B, H), dtype=cd)
        # The state each step read: the step before's, the zero state first.
        shift = lambda seq, init: torch.cat([init[None], seq[:-1]])  # noqa: E731
        h_prev = [shift(h_seq[i], zero) for i in range(n)]
        c_prev = [shift(c_seq[i], zero).float() for i in range(n)]
        ctx_prev = shift(ctx_seq, memory.new_zeros((B, D), dtype=cd))
        g_f32 = [g.float() for g in g_seq]
        fused_t = [w.t() for w in fused_weights(lstm, cd)]
        dh = [memory.new_zeros((B, H)) for _ in range(n)]
        dc = [memory.new_zeros((B, H)) for _ in range(n)]
        dctx_c, dw_c, dcum_c = (memory.new_zeros(shape) for shape in ((B, D), (B, S), (B, S)))
        dG = [[None] * T for _ in range(n)]
        dpre, dctx_seq, de_seq, du_seq, dq_seq, dconv_seq = ([None] * T for _ in range(6))
        for t in range(T - 1, -1, -1):
            dh[n - 1] = dh[n - 1] + d_xs[t, :, :H]
            dctx = d_xs[t, :, H:] + dctx_c
            for i in range(n - 1, 0, -1):
                dG[i][t], dc[i] = _cell_bwd(g_f32[i][t], c_prev[i][t], dh[i], dc[i])
                dcat = rounded(dG[i][t], cd) @ fused_t[i]  # [d h_{i-1} | d ctx | d h_i prev]
                dh[i - 1] = dh[i - 1] + dcat[:, :H]
                dctx = dctx + dcat[:, H:H + D]
                dh[i] = dcat[:, H + D:]
            # The attention block from its kept intermediates: softmax, the
            # -1e9 mask, tanh, the three products and the location conv.
            dw = d_ws[t] + dw_c + dcum_c + torch.bmm(mem, dctx[:, :, None])[..., 0]
            w = w_seq[t]
            de = torch.where(valid, w * (dw - (dw * w).sum(-1, keepdim=True)), 0.0)
            z = z_seq[t]
            du = (de[..., None] * v) * (1.0 - z * z)  # (B, S, A)
            dq = du.sum(1)
            dconv = du @ wloc_t
            dloc = _conv_windows(dconv, K, K - 1 - lo) @ kflip
            dh[0] = dh[0] + dq @ wq_t
            dw_c, dcum_c = dloc[..., 0], dcum_c + dloc[..., 1]
            de_seq[t], du_seq[t], dq_seq[t], dconv_seq[t] = de, du, dq, dconv
            dG[0][t], dc[0] = _cell_bwd(g_f32[0][t], c_prev[0][t], dh[0], dc[0])
            dcat = rounded(dG[0][t], cd) @ fused_t[0]  # [d pre | d ctx prev | d h0 prev]
            dpre[t] = dcat[:, :P]
            dctx_c = dcat[:, P:P + D]
            dh[0] = dcat[:, P + D:]
            dctx_seq[t] = dctx
        # Deferred weight gradients: one [x_in, h_prev]^T @ dG GEMM a layer
        # (dG in the compute dtype, the biases' sums in f32), and the
        # attention weights' sums over all steps.
        grads = []
        for i in range(n):
            dg = torch.stack(dG[i])
            xin = (torch.cat([pre_seq.to(cd), ctx_prev], dim=-1) if i == 0
                   else torch.cat([h_seq[i - 1], ctx_seq], dim=-1))
            dcat = seq_gemm(torch.cat([xin, h_prev[i]], dim=-1), dg.to(cd))
            din = xin.shape[-1]
            grads += [dcat[:din], dcat[din:], dg.sum((0, 1))]
        du_seq = torch.stack(du_seq)
        dk = seq_gemm(win_seq, torch.stack(dconv_seq)).reshape(Cin, K, C).permute(1, 0, 2)
        dap = [seq_gemm(h_seq[0], torch.stack(dq_seq)), dk, seq_gemm(conv_seq, du_seq),
               torch.einsum("tbsa,tbs->a", z_seq, torch.stack(de_seq))[:, None]]
        dctx_seq = torch.stack(dctx_seq)
        dmemory = torch.einsum("tbs,tbd->bsd", w_seq.to(cd).float(), dctx_seq.to(cd).float())
        return (None, None, None, None, torch.stack(dpre), du_seq.sum(0), dmemory, *grads, *dap)


def decoder_tf_scan(p: DecoderParams, pre_seq, keys, memory, mask,
                    compute_dtype=torch.float32):
    """Teacher-forced scan over prenet-ed frames (T, B, P) -> (xs (T, B,
    H + D_mem), attention weights (T, B, S)): the numerics of
    :func:`decoder_tf_scan_ref`, differentiated by the hand-written backward
    of :class:`_TFScan`."""
    ws = [w for q in p.lstm for w in q] + list(p.attention)
    return _TFScan.apply(needs_grad(pre_seq, keys, memory, *ws), len(p.lstm), compute_dtype,
                         mask, pre_seq, keys, memory, *ws)


def _project(p: DecoderParams, x: torch.Tensor):
    frames = x @ p.frame_proj[0] + p.frame_proj[1]
    stop = (x @ p.stop_proj[0] + p.stop_proj[1])[..., 0]
    return frames, stop


def take_rows(x, pos: torch.Tensor):
    """The rows at ``pos`` of a tensor, or of each tensor of a tuple (a
    :class:`DecoderCarry` as well)."""
    if isinstance(x, tuple):
        taken = (take_rows(v, pos) for v in x)
        return DecoderCarry(*taken) if isinstance(x, DecoderCarry) else tuple(taken)
    return x.index_select(0, pos)


def one_row_as_two(run, device):
    """A chunk over a state of one row, run as over two equal rows, of
    which the first is kept: a product of one row takes BLAS's
    matrix-vector path, whose sums run in another order than a batch's, so
    alone the row would decode other last bits than beside other rows.
    ``run(two)`` runs the chunk on its batch-row inputs indexed by ``two``
    (row 0 twice) and returns (*state, frames (K, 2, ...), stops, aligns)."""
    two = torch.zeros(2, dtype=torch.long, device=device)
    *state, f_k, s_k, w_k = run(two)
    return (*(take_rows(x, two[:1]) for x in state), *(x[:, :1] for x in (f_k, s_k, w_k)))


def decoder_ar_segment(p: DecoderParams, fused: tuple, prenet_fn: Callable, mel_dim: int,
                       compute_dtype, keys, memory, mask, carry: DecoderCarry, prev, t0: int,
                       stopped, lengths, n_steps_seg: int, stop_threshold: float,
                       rows: torch.Tensor | None = None):
    """``n_steps_seg`` AR steps from explicit state. Per step the decoded
    length grows for rows not yet stopped, THEN the stop flag updates (the
    JAX order). The state holds the batch rows ``rows`` (None: every row),
    which ``prenet_fn(frame, t, rows)`` takes its keep masks for; one row
    runs as two (:func:`one_row_as_two`). Returns (carry, prev, stopped,
    lengths, frames (K, B, mel*r), stop_logits (K, B), aligns (K, B, S))."""
    if prev.shape[0] == 1:
        return one_row_as_two(lambda two: decoder_ar_segment(
            p, fused, prenet_fn, mel_dim, compute_dtype,
            *(take_rows(x, two) for x in (keys, memory, mask, carry, prev)), t0,
            take_rows(stopped, two), take_rows(lengths, two), n_steps_seg, stop_threshold,
            two if rows is None else rows[two]), prev.device)
    f_k, s_k, w_k = [], [], []
    for i in range(n_steps_seg):
        pre_t = prenet_fn(prev, t0 + i, rows)
        carry, x, w = decoder_cell_step(p, fused, carry, pre_t, keys, memory,
                                        mask, compute_dtype)
        frames, stop_logit = _project(p, x)
        lengths = lengths + (~stopped).to(lengths.dtype)
        stopped = stopped | (torch.sigmoid(stop_logit.float()) > stop_threshold)
        prev = frames[..., -mel_dim:]
        f_k.append(frames)
        s_k.append(stop_logit)
        w_k.append(w)
    return (carry, prev, stopped, lengths,
            torch.stack(f_k), torch.stack(s_k), torch.stack(w_k))


def plain_body(p: DecoderParams, fused: tuple, prenet_fn: Callable, mel_dim: int,
               compute_dtype) -> Callable:
    """The plain loop's chunk body: :func:`decoder_ar_segment` under
    ``fused`` (:func:`fused_weights`, or :func:`quantize_fused` for the
    weight-only int8 gates)."""
    return functools.partial(decoder_ar_segment, p, fused, prenet_fn, mel_dim, compute_dtype)


def decoder_ar_scan(p: DecoderParams, keys, memory, mask, n_steps: int, body: Callable,
                    mel_dim: int, chunk: int = 16):
    """Fixed-length AR decode (constant work; the caller derives lengths
    from the stop logits): every row through the chunk ``body`` in chunks
    of K, with no stop check between them. Returns (frames (n_steps, B,
    mel*r), stops (n_steps, B), aligns (n_steps, B, S))."""
    B = mask.shape[0]
    carry = initial_carry(B, memory, len(p.lstm), p.lstm[0].hidden_size)
    prev = memory.new_zeros((B, mel_dim), dtype=torch.float32)
    stopped = torch.zeros(B, dtype=torch.bool, device=memory.device)
    lengths = torch.zeros(B, dtype=torch.int32, device=memory.device)
    K = chunk_size(n_steps, chunk)
    parts = []
    for t in range(0, n_steps, K):
        carry, prev, stopped, lengths, *fsw = body(
            keys, memory, mask, carry, prev, t, stopped, lengths, K, 0.5)
        parts.append(fsw)
    frames, stops, aligns = (torch.cat(x) for x in zip(*parts))
    return frames, stops, aligns


def chunk_size(n_steps: int, chunk: int) -> int:
    """Largest divisor of n_steps that is <= chunk (1 at worst)."""
    return max((k for k in range(1, min(chunk, n_steps) + 1) if n_steps % k == 0),
               default=1)


def decoder_ar_early_exit(p: DecoderParams, keys, memory, mask, n_steps: int,
                          stop_threshold: float, body: Callable, mel_dim: int,
                          stopped_init: torch.Tensor | None = None, chunk: int = 16):
    """AR decode in chunks of K steps through the chunk ``body`` until every
    row stopped (or n_steps), each chunk over the rows still decoding and no
    others: ``rows`` is then the batch indices of the rows the state holds
    (None while it holds every row), whose prenet keep masks the body takes.

    Rows in ``stopped_init`` start stopped (batch-bucket PAD rows), decode
    length 0 and never run. The stop check is one host read per chunk; at
    that read, where rows have stopped, the state is cut to the rows still
    decoding (a stopped row's state is dropped, never read again). Each
    chunk counts its rows launched x K as ``decode.row_steps``
    (:mod:`..telemetry`). A row's frames, stop logits and alignments up to
    the end of the chunk it stopped in are the decoder's; past it, as for
    steps never run, zero frames and alignments and stop logits of -1e4.
    Returns (frames (n_steps, B, mel*r), stops (n_steps, B), aligns
    (n_steps, B, S), lengths_steps (B,))."""
    B, S = mask.shape
    H = p.lstm[0].hidden_size
    carry = initial_carry(B, memory, len(p.lstm), H)
    prev = memory.new_zeros((B, mel_dim), dtype=torch.float32)
    frame_dim = p.frame_proj[0].shape[-1]
    frames = memory.new_zeros((n_steps, B, frame_dim), dtype=torch.float32)
    stops = memory.new_full((n_steps, B), -1e4, dtype=torch.float32)
    aligns = memory.new_zeros((n_steps, B, S), dtype=torch.float32)
    stopped = (torch.zeros(B, dtype=torch.bool, device=memory.device)
               if stopped_init is None else stopped_init.to(torch.bool).clone())
    lengths = torch.zeros(B, dtype=torch.int32, device=memory.device)
    out_lengths = torch.zeros_like(lengths)
    K = chunk_size(n_steps, chunk)
    rows = torch.arange(B, device=memory.device)  # the batch rows the state holds
    t = 0
    while t < n_steps:
        flags = stopped.tolist()  # the chunk's one host read
        live = [i for i, f in enumerate(flags) if not f]
        if not live:
            break
        if len(live) < len(flags):  # compact the state to the rows still decoding
            out_lengths.index_copy_(0, rows, lengths)
            pos = torch.tensor(live, device=memory.device)
            rows, carry, keys, memory, mask, prev, stopped, lengths = (
                take_rows(x, pos) for x in (rows, carry, keys, memory, mask, prev, stopped,
                                            lengths))
        carry, prev, stopped, lengths, f_k, s_k, w_k = body(
            keys, memory, mask, carry, prev, t, stopped, lengths, K, stop_threshold,
            rows=None if len(rows) == B else rows)
        for out, x in zip((frames, stops, aligns), (f_k, s_k, w_k)):
            out[t:t + K].index_copy_(1, rows, x)
        telemetry.count("decode.row_steps", len(rows) * K)  # the rows launched
        t += K
    out_lengths.index_copy_(0, rows, lengths)
    return frames, stops, aligns, out_lengths
