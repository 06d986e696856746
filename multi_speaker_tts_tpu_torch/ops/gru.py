"""GRU primitives in plain PyTorch (port of ``multi_speaker_tts_tpu.ops.gru``).

Torch gate order (r, z, n); weights in the JAX layout: w_ih (D, 3H), w_hh
(H, 3H), b_ih / b_hh (3H,). The two bias vectors stay separate: b_hn sits
inside the reset product, n = tanh(W_in x + b_in + r * (W_hn h + b_hn)).
The input projection for all steps is hoisted out of the time loop; operands
are rounded to the compute dtype and the arithmetic is f32
(:mod:`.numerics`); the carry is always f32. These are the f32-gate
references of the CBHG head's BiGRU; the kernel path (bf16 hoisted gates)
lives in :mod:`.birnn_kernel`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from multi_speaker_tts_tpu_torch.ops.numerics import rounded


class GRUParams(NamedTuple):
    """One GRU layer. w_ih: (D, 3H), w_hh: (H, 3H), b_ih / b_hh: (3H,)."""

    w_ih: torch.Tensor
    w_hh: torch.Tensor
    b_ih: torch.Tensor
    b_hh: torch.Tensor

    @property
    def hidden_size(self) -> int:
        return self.w_hh.shape[0]


def input_gates(p: GRUParams, x: torch.Tensor,
                compute_dtype=torch.float32) -> torch.Tensor:
    """Hoisted input projection for all steps: (..., D) -> (..., 3H) f32."""
    return rounded(x, compute_dtype) @ rounded(p.w_ih, compute_dtype) + p.b_ih.float()


def gru_cell_step(p: GRUParams, gates_x: torch.Tensor, h: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """One step from precomputed input gates (B, 3H) and h (B, H) -> new h."""
    gates_h = rounded(h, compute_dtype) @ rounded(p.w_hh, compute_dtype) + p.b_hh.float()
    H = p.hidden_size
    r = torch.sigmoid(gates_x[..., :H] + gates_h[..., :H])
    z = torch.sigmoid(gates_x[..., H:2 * H] + gates_h[..., H:2 * H])
    n = torch.tanh(gates_x[..., 2 * H:] + r * gates_h[..., 2 * H:])
    return (1.0 - z) * n + z * h


def recurrence(p: GRUParams, gx: torch.Tensor, compute_dtype=torch.float32,
               reverse: bool = False) -> torch.Tensor:
    """The sequential part over time-major input gates gx (T, B, 3H):
    ys (T, B, H) f32 in natural time, from a zero state."""
    T, B, _ = gx.shape
    h = gx.new_zeros((B, p.hidden_size), dtype=torch.float32)
    ys = [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        h = gru_cell_step(p, gx[t].float(), h, compute_dtype)
        ys[t] = h
    return torch.stack(ys)


def gru(p: GRUParams, x: torch.Tensor, reverse: bool = False,
        compute_dtype=torch.float32):
    """Full-sequence GRU over (B, T, D): (outputs (B, T, H) f32, h_T)."""
    ys = recurrence(p, input_gates(p, x.transpose(0, 1), compute_dtype),
                    compute_dtype, reverse)
    return ys.transpose(0, 1), ys[0 if reverse else -1]


def bigru_fused(fwd: GRUParams, bwd: GRUParams, x: torch.Tensor,
                compute_dtype=torch.float32) -> torch.Tensor:
    """(B, T, D) -> (B, T, 2H) f32: both directions, input gates kept f32."""
    y_f, _ = gru(fwd, x, False, compute_dtype)
    y_b, _ = gru(bwd, x, True, compute_dtype)
    return torch.cat([y_f, y_b], dim=-1)
