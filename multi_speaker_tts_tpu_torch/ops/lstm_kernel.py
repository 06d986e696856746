"""GE2E LSTM stack on a persistent Hopper kernel (one launch per layer).

Replaces ``multi_speaker_tts_tpu/ops/lstm_pallas.py::lstm_seq_layer_fwd``
(kernel body ``_fwd_kernel``) and the stack loop ``lstm_stack_seq_pallas``.
The kernel (``csrc/lstm.cu``) fuses the input projection into the step as
the TPU kernel does: gates = [x_t, h_{t-1}] . [W_ih; W_hh] + b with bf16
operands and f32 accumulation, f32 cell state, outputs stored bf16.

:func:`lstm_seq_layer_plain` is the same layer in plain torch: the CPU
path (in any compute dtype) and the card's yardstick.
"""

from __future__ import annotations

import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams, input_gates, recurrence

KERNEL = _build.Kernel("ge2e_lstm", "lstm.cu", {
    "mstts_lstm_layer_fwd": [_build.P] * 7 + [_build.I] * 4 + [_build.P],
})


def lstm_seq_layer_plain(p: LSTMParams, x_tm: torch.Tensor,
                         compute_dtype=torch.bfloat16):
    """One layer over time-major (T, B, D): (ys (T, B, H) in the compute
    dtype, h_T (B, H) f32, c_T (B, H) f32)."""
    ys, h, c = recurrence(input_gates(p, x_tm, compute_dtype), p.w_hh, compute_dtype)
    return ys.to(compute_dtype), h, c


def _kernel_layout(w_ih: torch.Tensor, w_hh: torch.Tensor, b: torch.Tensor):
    """[W_ih; W_hh]^T as (4H, D + H) bf16 rows and the f32 bias."""
    return (torch.cat([w_ih, w_hh], dim=0).t().contiguous().to(torch.bfloat16),
            b.float().contiguous())


def lstm_seq_layer_kernel(p: LSTMParams, x_tm: torch.Tensor):
    """Launch ``csrc/lstm.cu`` on a CUDA bf16 (T, B, D) input."""
    _build.require_cuda(x_tm, torch.bfloat16, "x_tm")
    T, B, D = x_tm.shape
    H = p.hidden_size
    if p.w_ih.shape != (D, 4 * H) or D % 8 or H % 8:
        raise ValueError(f"LSTM kernel needs D, H multiples of 8: D={D}, H={H}")
    w, b = _build.packed(_kernel_layout, p.w_ih, p.w_hh, p.b)
    dev = x_tm.device
    ys = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    h_T = torch.empty((B, H), dtype=torch.float32, device=dev)
    c_T = torch.empty_like(h_T)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    KERNEL.call(
        "mstts_lstm_layer_fwd", x_tm.data_ptr(), w.data_ptr(), b.data_ptr(),
        ys.data_ptr(), h_T.data_ptr(), c_T.data_ptr(), bar.data_ptr(),
        T, B, D, H, _build.stream_ptr(x_tm),
    )
    return ys, h_T, c_T


def lstm_seq_layer_fwd(p: LSTMParams, x_tm: torch.Tensor,
                       compute_dtype=torch.bfloat16):
    """The kernel for a CUDA tensor (bf16 compute only), the plain version
    for a CPU tensor."""
    if x_tm.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the LSTM kernel computes in bf16 only")
        return lstm_seq_layer_kernel(p, x_tm.to(torch.bfloat16).contiguous())
    return lstm_seq_layer_plain(p, x_tm, compute_dtype)


def lstm_stack_seq(layers, x: torch.Tensor, compute_dtype=torch.bfloat16):
    """Stacked layers, layer by layer over (B, T, D): (last layer's outputs
    (B, T, H) f32, its final hidden state (B, H) f32)."""
    ys = x.transpose(0, 1).to(compute_dtype).contiguous()
    h_T = None
    for p in layers:
        ys, h_T, _ = lstm_seq_layer_fwd(p, ys, compute_dtype)
    return ys.transpose(0, 1).float(), h_T
