"""LSTM primitives in plain PyTorch (port of ``multi_speaker_tts_tpu.ops.lstm``).

Torch gate order (i, f, g, o); weights in the JAX layout: w_ih (D, 4H),
w_hh (H, 4H), b (4H,). The input projection for all steps is hoisted out of
the time loop; only the recurrent product stays sequential. Operands are
rounded to the compute dtype and the arithmetic is f32
(:mod:`.numerics`); the cell state is always f32. These are the plain
versions behind the GE2E LSTM kernels (:mod:`.lstm_kernel`) and the BiLSTM
kernels (:mod:`.birnn_kernel`, whose ``bilstm`` is the port of
``bilstm_pallas``), forward (:func:`recurrence`, with the residuals the
reverse pass reads) and backward (:func:`recurrence_bwd`). :func:`lstm_stack`
and :func:`bilstm_fused` are the recurrences an f32 checkpoint runs, as the
JAX package's XLA scans (``lstm_stack_wavefront``, ``bilstm_fused``) are,
under autograd where a gradient is needed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_speaker_tts_tpu_torch.ops.numerics import rounded


class LSTMParams(NamedTuple):
    """One LSTM layer. w_ih: (D, 4H), w_hh: (H, 4H), b: (4H,)."""

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b: torch.Tensor

    @property
    def hidden_size(self) -> int:
        return self.w_hh.shape[0]


def cell(gates: torch.Tensor, c: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(h, c) from f32 pre-activation gates (..., 4H)."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c_new), c_new


def input_gates(p: LSTMParams, x: torch.Tensor,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Hoisted input projection for all steps: (..., D) -> (..., 4H) f32."""
    return rounded(x, compute_dtype) @ rounded(p.w_ih, compute_dtype) + p.b.float()


def recurrence(gx: torch.Tensor, w_hh: torch.Tensor, compute_dtype=torch.float32,
               reverse: bool = False, save_residuals: bool = False):
    """The sequential part over time-major gates gx (T, B, 4H) (input
    projection and bias already in): (ys (T, B, H) f32 in natural time,
    h_T, c_T); h enters each step's product rounded to the compute dtype.
    ``save_residuals`` appends what the reverse pass reads, in natural time:
    the f32 pre-activation gates (T, B, 4H) and c_{t-1} (T, B, H)."""
    T, B, H4 = gx.shape
    w = rounded(w_hh, compute_dtype)
    h = gx.new_zeros((B, H4 // 4), dtype=torch.float32)
    c = torch.zeros_like(h)
    ys, gates, c_prev = [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gates[t] = gx[t].float() + rounded(h, compute_dtype) @ w
        c_prev[t] = c
        h, c = cell(gates[t], c)
        ys[t] = h
    if save_residuals:
        return torch.stack(ys), h, c, torch.stack(gates), torch.stack(c_prev)
    return torch.stack(ys), h, c


def cell_bwd(gates: torch.Tensor, c_prev: torch.Tensor, dh: torch.Tensor,
             dc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the reverse pass from f32 pre-activation gates and
    c_{t-1}: (dG (B, 4H) f32, the dc carried to step t-1). ``dh`` is the
    step's whole output cotangent, ``dc`` the carry from step t+1; c_t is
    recomputed from c_{t-1}."""
    gi, gf, gg, go = gates.chunk(4, dim=-1)
    i, f, g, o = torch.sigmoid(gi), torch.sigmoid(gf), torch.tanh(gg), torch.sigmoid(go)
    tc = torch.tanh(f * c_prev + i * g)
    do = dh * tc * o * (1.0 - o)
    dc = dc + dh * o * (1.0 - tc * tc)
    dG = torch.cat([dc * g * i * (1.0 - i), dc * c_prev * f * (1.0 - f),
                    dc * i * (1.0 - g * g), do], dim=-1)
    return dG, dc * f


def recurrence_bwd(w_hh: torch.Tensor, gates: torch.Tensor, c_prev: torch.Tensor,
                   d_hT: torch.Tensor | None, d_ys: torch.Tensor | None,
                   compute_dtype=torch.float32, natural_time: bool = False) -> torch.Tensor:
    """The reverse pass of :func:`recurrence` from its residuals (gates and
    c_prev in natural time, any dtype): dG (T, B, 4H) in the compute dtype.
    Walks time in reverse (``natural_time`` for a direction that ran
    reversed); the f32 dh carry is bf16(dG_t) . W_hh^T with f32 sums, dc
    is carried in f32. ``d_hT`` / ``d_ys`` (f32) may be None (zero)."""
    T, B, H4 = gates.shape
    w_t = rounded(w_hh, compute_dtype).t()
    dh = gates.new_zeros((B, H4 // 4), dtype=torch.float32) if d_hT is None else d_hT.float()
    dc = torch.zeros_like(dh)
    dG = torch.empty((T, B, H4), dtype=compute_dtype, device=gates.device)
    for t in (range(T) if natural_time else range(T - 1, -1, -1)):
        dh_t = dh if d_ys is None else dh + d_ys[t].float()
        dg, dc = cell_bwd(gates[t].float(), c_prev[t].float(), dh_t, dc)
        dG[t] = dg.to(compute_dtype)
        dh = rounded(dg, compute_dtype) @ w_t
    return dG


def lstm(p: LSTMParams, x: torch.Tensor, reverse: bool = False,
         compute_dtype=torch.float32):
    """Full-sequence LSTM over (B, T, D): (outputs (B, T, H) f32, (h_T, c_T))."""
    gx = input_gates(p, x.transpose(0, 1), compute_dtype)
    ys, h, c = recurrence(gx, p.w_hh, compute_dtype, reverse)
    return ys.transpose(0, 1), (h, c)


def lstm_stack(layers, x: torch.Tensor, compute_dtype=torch.float32):
    """Stacked layers over (B, T, D), one after another: (the last layer's
    outputs (B, T, H) f32, its final hidden state h_T (B, H) f32)."""
    h_T = None
    for p in layers:
        x, (h_T, _) = lstm(p, x, compute_dtype=compute_dtype)
    return x, h_T


def bilstm_fused(fwd: LSTMParams, bwd: LSTMParams, x: torch.Tensor,
                 compute_dtype=torch.float32) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H) f32: both directions, input gates kept f32."""
    y_f, _ = lstm(fwd, x, False, compute_dtype)
    y_b, _ = lstm(bwd, x, True, compute_dtype)
    return torch.cat([y_f, y_b], dim=-1)
