"""One fused location-sensitive attention step and its context, a Hopper kernel.

Replaces ``tools/attention_probe.py::make_pallas_loop`` (kernel body
``_fused_attn_kernel``): the probe's fused decoder attention step. From the
attention-RNN output h0 (B, H), the previous and cumulative weights padded
to (B, S + K - 1) with ``(K - 1) // 2`` zeros in front and the rest behind,
keys (B, S, A), memory (B, S, D) and an additive mask (B, S) of 0 / -1e9,
it returns the weights (B, S), the cumulative weights (B, S) and the
context (B, D), all f32. No serving or training path calls it; the
attention-step probe (:mod:`multi_speaker_tts_tpu_torch.tools.attention_probe`)
does, as the JAX package's probe is the only caller of its kernel.

:func:`attention_step` launches ``csrc/attention_step.cu`` on CUDA tensors
(or raises) and runs :func:`attention_step_plain`, the same function in
plain torch, on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops.decoder_scan import AttentionParams, location_conv

KERNEL = _build.Kernel("attention_step", "attention_step.cu", {
    "mstts_attention_step": [_build.P, _build.P, _build.P],  # ptrs, dims, stream
})
# Batch rows per thread block (1, 2 or 4). Every block reads all of wq, so
# more rows a block cut that traffic, but also the number of blocks and the
# work that runs side by side: at the probe's shapes 1 is the fastest
# (PERF.md, row 11; the probe times each).
ROWS_PER_BLOCK = 1
# The limits of csrc/attention_step.cu. A block that would need more shared
# memory than the card gives (a very wide H at R = 4) fails at launch, and
# KERNEL.call raises.
MAX_S = 256
MAX_A = 512
MAX_C = 32  # one lane per location channel


def shape_reason(S: int, A: int, D: int, C: int, rows: int = ROWS_PER_BLOCK) -> str | None:
    """Why the kernel does not take these widths, or None if it does."""
    if S > MAX_S:
        return f"needs at most {MAX_S} memory positions, got {S}"
    if A > MAX_A or A % 32:
        return f"needs an attention width that is a multiple of 32 up to {MAX_A}, got {A}"
    if D % 32:
        return f"needs a memory width that is a multiple of 32, got {D}"
    if C > MAX_C:
        return f"needs at most {MAX_C} location channels, got {C}"
    if rows not in (1, 2, 4):
        return f"takes 1, 2 or 4 rows a block, got {rows}"
    return None


def maskadd_of(mask: torch.Tensor) -> torch.Tensor:
    """(B, S) 1 = valid -> the additive mask, 0 where valid and -1e9 elsewhere."""
    return torch.zeros(mask.shape, device=mask.device).masked_fill(mask <= 0, -1e9)


def attention_step_plain(h0, w_prev_pad, cum_prev_pad, keys, memory, maskadd,
                         ap: AttentionParams):
    """The kernel's function in plain torch -> (w, cum, ctx). The padding
    borders are zeros, so the location conv runs on the rows between them
    (:func:`location_conv` pads with the same zeros)."""
    S = keys.shape[1]
    half = (ap.conv_kernel.shape[0] - 1) // 2
    w_prev = w_prev_pad[:, half:half + S]
    cum_prev = cum_prev_pad[:, half:half + S]
    q = h0.float() @ ap.wq
    loc = location_conv(torch.stack([w_prev, cum_prev], dim=-1), ap.conv_kernel) @ ap.wloc
    energies = (torch.tanh(q[:, None, :] + keys + loc) @ ap.v)[..., 0] + maskadd
    w = torch.softmax(energies, dim=-1)
    ctx = torch.bmm(w[:, None, :], memory.float())[:, 0]
    return w, cum_prev + w, ctx


def attention_step_kernel(h0, w_prev_pad, cum_prev_pad, keys, memory, maskadd,
                          ap: AttentionParams, rows: int = ROWS_PER_BLOCK):
    """Launch ``csrc/attention_step.cu`` on CUDA f32 tensors. Same returns as
    :func:`attention_step_plain`."""
    B, S, A = keys.shape
    D, H = memory.shape[-1], h0.shape[-1]
    K, _, C = ap.conv_kernel.shape
    reason = shape_reason(S, A, D, C, rows)
    if reason is not None:
        raise ValueError(f"attention step kernel {reason}")
    if (memory.shape[:2] != (B, S) or h0.shape[0] != B or maskadd.shape != (B, S)
            or w_prev_pad.shape != (B, S + K - 1) or cum_prev_pad.shape != (B, S + K - 1)
            or ap.wq.shape != (H, A) or ap.conv_kernel.shape[1] != 2
            or ap.wloc.shape != (C, A) or ap.v.shape != (A, 1)):
        raise ValueError("attention step kernel: inconsistent shapes")

    def f32(t):
        t = t.contiguous()
        _build.require_cuda(t, torch.float32, "attention step input")
        return t if t.data_ptr() % 16 == 0 else t.clone()  # the kernel loads 16 bytes at a time

    ins = [f32(t) for t in (h0, w_prev_pad, cum_prev_pad, keys, memory, maskadd,
                            ap.wq, ap.conv_kernel, ap.wloc, ap.v)]
    w = torch.empty((B, S), dtype=torch.float32, device=keys.device)
    cum = torch.empty_like(w)
    ctx = torch.empty((B, D), dtype=torch.float32, device=keys.device)
    ptrs = [t.data_ptr() for t in (*ins, w, cum, ctx)]
    dims = [B, S, A, D, H, K, C, rows]
    KERNEL.call("mstts_attention_step", (ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_int * len(dims))(*dims), _build.stream_ptr(keys))
    return w, cum, ctx


def attention_step(h0, w_prev_pad, cum_prev_pad, keys, memory, maskadd,
                   ap: AttentionParams):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = attention_step_kernel if keys.is_cuda else attention_step_plain
    return fn(h0, w_prev_pad, cum_prev_pad, keys, memory, maskadd, ap)
