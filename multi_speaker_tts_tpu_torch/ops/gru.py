"""GRU primitives in plain PyTorch (port of ``multi_speaker_tts_tpu.ops.gru``).

Torch gate order (r, z, n); weights in the JAX layout: w_ih (D, 3H), w_hh
(H, 3H), b_ih / b_hh (3H,). The two bias vectors stay separate: b_hn sits
inside the reset product, n = tanh(W_in x + b_in + r * (W_hn h + b_hn)).
The input projection for all steps is hoisted out of the time loop; operands
are rounded to the compute dtype and the arithmetic is f32
(:mod:`.numerics`); the carry is always f32. These are the f32-gate
references of the CBHG head's BiGRU and the plain versions behind its
kernels (:mod:`.birnn_kernel`, bf16 hoisted gates), forward
(:func:`recurrence`, with residuals) and backward (:func:`recurrence_bwd`).
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


def gates_h(p: GRUParams, h: torch.Tensor, compute_dtype=torch.float32) -> torch.Tensor:
    """Recurrent gates bf16(h) . W_hh + b_hh (B, 3H) f32."""
    return rounded(h, compute_dtype) @ rounded(p.w_hh, compute_dtype) + p.b_hh.float()


def _cell(gates_x: torch.Tensor, gates_h: torch.Tensor, h: torch.Tensor):
    """(r, z, n, new h) from both gate sets (f32) and h."""
    r_x, z_x, n_x = gates_x.chunk(3, dim=-1)
    r_h, z_h, n_h = gates_h.chunk(3, dim=-1)
    r = torch.sigmoid(r_x + r_h)
    z = torch.sigmoid(z_x + z_h)
    n = torch.tanh(n_x + r * n_h)
    return r, z, n, (1.0 - z) * n + z * h


def gru_cell_step(p: GRUParams, gates_x: torch.Tensor, h: torch.Tensor,
                  compute_dtype=torch.float32) -> torch.Tensor:
    """One step from precomputed input gates (B, 3H) and h (B, H) -> new h."""
    return _cell(gates_x, gates_h(p, h, compute_dtype), h)[-1]


def recurrence(p: GRUParams, gx: torch.Tensor, compute_dtype=torch.float32,
               reverse: bool = False, save_residuals: bool = False):
    """The sequential part over time-major input gates gx (T, B, 3H):
    ys (T, B, H) f32 in natural time, from a zero state. ``save_residuals``
    returns (ys, gh (T, B, 3H), h_{t-1} (T, B, H)), f32 in natural time:
    what the reverse pass reads beside gx."""
    T, B, _ = gx.shape
    h = gx.new_zeros((B, p.hidden_size), dtype=torch.float32)
    ys, gh, h_prev = [None] * T, [None] * T, [None] * T
    for t in (range(T - 1, -1, -1) if reverse else range(T)):
        gh[t], h_prev[t] = gates_h(p, h, compute_dtype), h
        h = _cell(gx[t].float(), gh[t], h)[-1]
        ys[t] = h
    if save_residuals:
        return torch.stack(ys), torch.stack(gh), torch.stack(h_prev)
    return torch.stack(ys)


def recurrence_bwd(w_hh: torch.Tensor, gx: torch.Tensor, gh: torch.Tensor,
                   h_prev: torch.Tensor, d_ys: torch.Tensor, compute_dtype=torch.float32,
                   natural_time: bool = False):
    """The reverse pass of :func:`recurrence` from its residuals (gx, gh,
    h_{t-1}, natural time, any dtype) and the f32 output cotangents:
    (dGx, dGh) (T, B, 3H) in the compute dtype, dGx = [dr, dz, dn] and
    dGh = [dr, dz, dn * r]. Walks time in reverse (``natural_time`` for a
    direction that ran reversed); dh is carried in f32 as
    dh * z + bf16(dGh) . W_hh^T."""
    T, B, H3 = gx.shape
    w_t = rounded(w_hh, compute_dtype).t()
    dh = gx.new_zeros((B, H3 // 3), dtype=torch.float32)
    dGx = torch.empty((T, B, H3), dtype=compute_dtype, device=gx.device)
    dGh = torch.empty_like(dGx)
    for t in (range(T) if natural_time else range(T - 1, -1, -1)):
        dh_t = dh + d_ys[t].float()
        gh_t = gh[t].float()
        r, z, n, _ = _cell(gx[t].float(), gh_t, h_prev[t].float())
        dz = dh_t * (h_prev[t].float() - n) * z * (1.0 - z)
        dn = dh_t * (1.0 - z) * (1.0 - n * n)
        dr = dn * gh_t.chunk(3, dim=-1)[2] * r * (1.0 - r)
        dGx[t] = torch.cat([dr, dz, dn], dim=-1).to(compute_dtype)
        dgh = torch.cat([dr, dz, dn * r], dim=-1)
        dGh[t] = dgh.to(compute_dtype)
        dh = dh_t * z + rounded(dgh, compute_dtype) @ w_t
    return dGx, dGh


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
