"""Tacotron decoder frame loops (port of ``multi_speaker_tts_tpu.ops.decoder_scan``):
the autoregressive decode and the teacher-forced scan.

One decoder frame (:func:`decoder_cell_step`): attention LSTM over
[prenet(prev), context] with fused [W_ih; W_hh] gates, location-sensitive
attention (SAME 31-tap conv over [w_prev, cum_prev], f32 energies, -1e9
mask), context, decoder LSTM stack, then the frame / stop projections. The
loop here is a Python loop: the default decode and the weight-only int8
reference (:func:`quantize_fused`, the int8 arm of :func:`_gates`). The
K-step kernel of the ``*_pallas`` serving modes lives in
:mod:`.decode_kernel` and enters :func:`decoder_ar_early_exit` as its
``segment_fn``.

The prenet runs through the caller's ``prenet_fn(frame, t)`` (t = global
step), as the JAX module takes ``prenet_apply_fn``: its always-on dropout
draws its keep masks per step, so tests can feed the JAX package's own
draws and production draws from a ``torch.Generator``.

The teacher-forced scan of training (:func:`decoder_tf_scan`, the port of
``decoder_tf_scan_ref``) runs the same cell over prenet-ed teacher frames
and is differentiated by autograd; the JAX package's hand-written backward
of that scan (``decoder_tf_scan``'s custom VJP: emitted gate gradients,
deferred weight-gradient GEMMs) is no Pallas kernel and is not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops.lstm import cell
from multi_speaker_tts_tpu_torch.ops.numerics import rounded


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


def location_conv(loc_in: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """SAME 1-D cross-correlation (B, S, Cin) x (K, Cin, C) -> (B, S, C), as
    one f32 matmul over the unfolded windows."""
    B, S, Cin = loc_in.shape
    K, _, C = kernel.shape
    lo = (K - 1) // 2
    xp = F.pad(loc_in, (0, 0, lo, K - 1 - lo))
    win = xp.unfold(1, K, 1).reshape(B, S, Cin * K)  # index c * K + d
    return win @ kernel.permute(1, 0, 2).reshape(Cin * K, C)


def attention_block(h0, w_prev, cum_prev, keys, ap: AttentionParams, mask):
    """One location-sensitive attention step -> (weights, cumulative)."""
    q = h0.float() @ ap.wq
    loc = location_conv(torch.stack([w_prev, cum_prev], dim=-1), ap.conv_kernel) @ ap.wloc
    energies = (torch.tanh(q[:, None, :] + keys + loc) @ ap.v)[..., 0]
    energies = torch.where(mask > 0, energies, torch.full_like(energies, -1e9))
    w = torch.softmax(energies, dim=-1)
    return w, cum_prev + w


def decoder_cell_step(p: DecoderParams, fused: tuple, carry: DecoderCarry,
                      pre_t, keys, memory, mask, compute_dtype):
    """One decoder frame -> (carry', x_t = [h_last, context], w_t)."""
    hs, cs = list(carry.h), list(carry.c)
    attn_in = torch.cat([pre_t, carry.context], dim=-1)
    hs[0], cs[0] = cell(_gates(fused[0], p.lstm[0].b, attn_in, hs[0], compute_dtype), cs[0])
    w, cum = attention_block(hs[0], carry.weights, carry.cum_weights, keys,
                             p.attention, mask)
    context = torch.bmm(w[:, None, :], memory.float())[:, 0]
    x = torch.cat([hs[0], context], dim=-1)
    for i in range(1, len(p.lstm)):
        hs[i], cs[i] = cell(_gates(fused[i], p.lstm[i].b, x, hs[i], compute_dtype), cs[i])
        x = torch.cat([hs[i], context], dim=-1)
    return DecoderCarry(tuple(hs), tuple(cs), w, cum, context), x, w


def decoder_tf_scan(p: DecoderParams, pre_seq, keys, memory, mask,
                    compute_dtype=torch.float32):
    """Teacher-forced scan over prenet-ed frames (T, B, P) -> (xs (T, B,
    H + D_mem) = [h_last, context] per step, attention weights (T, B, S)).
    A Python loop of :func:`decoder_cell_step` from the zero carry,
    differentiable by autograd."""
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


def _project(p: DecoderParams, x: torch.Tensor):
    frames = x @ p.frame_proj[0] + p.frame_proj[1]
    stop = (x @ p.stop_proj[0] + p.stop_proj[1])[..., 0]
    return frames, stop


def decoder_ar_segment(p: DecoderParams, fused: tuple, keys, memory, mask,
                       carry: DecoderCarry, prev, t0: int, stopped, lengths,
                       n_steps_seg: int, stop_threshold: float,
                       prenet_fn: Callable, mel_dim: int, compute_dtype):
    """``n_steps_seg`` AR steps from explicit state. Per step the decoded
    length grows for rows not yet stopped, THEN the stop flag updates (the
    JAX order). Returns (carry, prev, stopped, lengths, frames (K, B,
    mel*r), stop_logits (K, B), aligns (K, B, S))."""
    f_k, s_k, w_k = [], [], []
    for i in range(n_steps_seg):
        pre_t = prenet_fn(prev, t0 + i)
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


def decoder_ar_scan(p: DecoderParams, keys, memory, mask, n_steps: int,
                    prenet_fn: Callable, mel_dim: int,
                    compute_dtype=torch.float32, fused: tuple | None = None,
                    segment_fn: Callable | None = None, chunk: int = 16):
    """Fixed-length AR decode (constant work; the caller derives lengths
    from the stop logits). ``segment_fn`` (see :func:`decoder_ar_early_exit`)
    runs the steps in chunks of K through that chunk body, with no stop
    check between them. Returns (frames (n_steps, B, mel*r), stops
    (n_steps, B), aligns (n_steps, B, S))."""
    B = mask.shape[0]
    carry = initial_carry(B, memory, len(p.lstm), p.lstm[0].hidden_size)
    prev = memory.new_zeros((B, mel_dim), dtype=torch.float32)
    stopped = torch.zeros(B, dtype=torch.bool, device=memory.device)
    lengths = torch.zeros(B, dtype=torch.int32, device=memory.device)
    if segment_fn is not None:
        K = chunk_size(n_steps, chunk)
        parts = []
        for t in range(0, n_steps, K):
            carry, prev, stopped, lengths, *fsw = segment_fn(
                keys, memory, mask, carry, prev, t, stopped, lengths, K, 0.5)
            parts.append(fsw)
        frames, stops, aligns = (torch.cat(x) for x in zip(*parts))
        return frames, stops, aligns
    if fused is None:
        fused = fused_weights(p.lstm, compute_dtype)
    *_, frames, stops, aligns = decoder_ar_segment(
        p, fused, keys, memory, mask, carry, prev, 0, stopped, lengths, n_steps,
        0.5, prenet_fn, mel_dim, compute_dtype,
    )
    return frames, stops, aligns


def chunk_size(n_steps: int, chunk: int) -> int:
    """Largest divisor of n_steps that is <= chunk (1 at worst)."""
    return max((k for k in range(1, min(chunk, n_steps) + 1) if n_steps % k == 0),
               default=1)


def decoder_ar_early_exit(p: DecoderParams, keys, memory, mask, n_steps: int,
                          stop_threshold: float, prenet_fn: Callable,
                          mel_dim: int,
                          compute_dtype=torch.float32,
                          stopped_init: torch.Tensor | None = None,
                          chunk: int = 16, fused: tuple | None = None,
                          segment_fn: Callable | None = None):
    """AR decode in chunks of K steps until every row stopped (or n_steps).

    ``fused`` replaces the compute-dtype fused weights (e.g.
    :func:`quantize_fused` for the int8 decode). ``segment_fn``, when given,
    replaces :func:`decoder_ar_segment` as the chunk body: ``(keys, memory,
    mask, carry, prev, t0, stopped, lengths, K, stop_threshold) -> (carry,
    prev, stopped, lengths, frames, stops, aligns)``
    (:func:`..decode_kernel.decoder_ar_segment_kernel` is one).

    Rows in ``stopped_init`` start stopped (batch-bucket PAD rows) and
    decode length 0. The stop check is one host read per chunk. Steps
    never run keep zero frames/aligns and stop logits of -1e4. Returns
    (frames (n_steps, B, mel*r), stops (n_steps, B), aligns (n_steps, B,
    S), lengths_steps (B,))."""
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
    if fused is None and segment_fn is None:
        fused = fused_weights(p.lstm, compute_dtype)
    K = chunk_size(n_steps, chunk)
    t = 0
    while t < n_steps and not bool(stopped.all()):
        if segment_fn is not None:
            carry, prev, stopped, lengths, f_k, s_k, w_k = segment_fn(
                keys, memory, mask, carry, prev, t, stopped, lengths, K, stop_threshold)
        else:
            carry, prev, stopped, lengths, f_k, s_k, w_k = decoder_ar_segment(
                p, fused, keys, memory, mask, carry, prev, t, stopped, lengths, K,
                stop_threshold, prenet_fn, mel_dim, compute_dtype,
            )
        frames[t:t + K], stops[t:t + K], aligns[t:t + K] = f_k, s_k, w_k
        t += K
    return frames, stops, aligns, lengths

