"""LSTM primitives in plain PyTorch (port of ``multi_speaker_tts_tpu.ops.lstm``).

Torch gate order (i, f, g, o); weights in the JAX layout: w_ih (D, 4H),
w_hh (H, 4H), b (4H,). The input projection for all steps is hoisted out of
the time loop; only the recurrent product stays sequential. Operands are
rounded to the compute dtype and the arithmetic is f32
(:mod:`.numerics`); the cell state is always f32. These are the plain
versions behind the GE2E LSTM kernel (:mod:`.lstm_kernel`) and the BiLSTM
kernel (:mod:`.birnn_kernel`, whose ``bilstm`` is the port of
``bilstm_fused``).
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
               reverse: bool = False):
    """The sequential part over time-major gates gx (T, B, 4H) (input
    projection and bias already in): (ys (T, B, H) f32 in natural time,
    h_T, c_T); h enters each step's product rounded to the compute dtype."""
    T, B, H4 = gx.shape
    w = rounded(w_hh, compute_dtype)
    h = gx.new_zeros((B, H4 // 4), dtype=torch.float32)
    c = torch.zeros_like(h)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h, c = cell(gx[t].float() + rounded(h, compute_dtype) @ w, c)
        ys[t] = h
    return torch.stack(ys), h, c


def lstm(p: LSTMParams, x: torch.Tensor, reverse: bool = False,
         compute_dtype=torch.float32):
    """Full-sequence LSTM over (B, T, D): (outputs (B, T, H) f32, (h_T, c_T))."""
    gx = input_gates(p, x.transpose(0, 1), compute_dtype)
    ys, h, c = recurrence(gx, p.w_hh, compute_dtype, reverse)
    return ys.transpose(0, 1), (h, c)
