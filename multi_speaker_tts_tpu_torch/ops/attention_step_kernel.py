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
    "mstts_attention_smem_bytes": [_build.P, _build.P],  # dims, out
    "mstts_attention_max_clusters": [_build.P],  # out
})
# The constants of csrc/attention_step.cu: blocks a cluster, threads and
# warps a block, rows a cluster, memory ring slots, the shared memory a
# block may have on an H100, and the kernel's width limits.
CLUSTER, WARPS, MAX_ROWS, MAX_SLOTS = 8, 16, 8, 15
SMEM_LIMIT = 232448
MAX_S = 256
MAX_A = 512
MAX_C = 32  # the location channels of a warp task, eight at a time


def _align(n: int) -> int:
    return (n + 127) // 128 * 128


def smem_bytes(S: int, A: int, D: int, K: int, C: int, R: int, chunk: int, slots: int) -> int:
    """Shared memory a block of the kernel needs: the regions of
    ``make_layout`` in ``csrc/attention_step.cu``, each 128-byte aligned
    (a card test holds the two equal)."""
    Sc = -(-S // CLUSTER)
    cols4 = A // (4 * CLUSTER)
    cols4p = 1 << max(0, (cols4 - 1).bit_length())
    Cp = -(-C // 8) * 8
    regions = (
        4 * R * max(Sc * A, D),                    # keys, then the context partials
        4 * slots * chunk * D,                     # the memory ring
        4 * Cp * A,                                # wloc
        8 * K * Cp,                                # the conv taps
        4 * A,                                     # v
        4 * R * A,                                 # q
        4 * R * (A // CLUSTER),                    # this block's q columns
        4 * max(WARPS * R * cols4p * 4, R * Sc * Cp),  # q partials, then loc
        8 * R * (Sc + K - 1),                      # wp, cp windows
        4 * R * Sc, 4 * R * Sc,                    # energies, exp(e - m_j)
        8 * R,                                     # (m_j, l_j)
        8 * (1 + slots),                           # mbarriers
    )
    return sum(_align(n) for n in regions)


def kernel_plan(B: int, S: int, A: int, D: int, K: int, C: int, card_clusters: int) -> dict | None:
    """Rows a cluster (R), positions a memory chunk and ring slots, as the
    wrapper launches them: R is the fewest rows that keep the clusters
    within what the card holds at once (``card_clusters``, from
    :func:`max_clusters`), lowered while a
    block's fixed regions leave no room for a ring of two chunks of one
    position. The ring holds every chunk of a block where it fits, else
    whole rows' runs of positions, else shorter runs, two slots or more.
    None if no R fits the card's shared memory."""
    Sc = -(-S // CLUSTER)
    for R in range(min(MAX_ROWS, max(1, -(-B // max(1, card_clusters)))), 0, -1):
        room = SMEM_LIMIT - smem_bytes(S, A, D, K, C, R, 0, 0)
        row = 4 * D  # one position of memory
        if Sc * row * R <= room and R <= MAX_SLOTS:
            chunk, slots = Sc, R
        elif 2 * Sc * row <= room:
            chunk, slots = Sc, min(MAX_SLOTS, R, room // (Sc * row))
        elif 2 * row <= room:
            chunk = room // (2 * row)
            slots = min(MAX_SLOTS, room // (chunk * row), R * -(-Sc // chunk))
        else:
            continue
        smem = smem_bytes(S, A, D, K, C, R, chunk, slots)
        if smem <= SMEM_LIMIT:
            return {"R": R, "chunk": chunk, "slots": slots, "smem": smem,
                    "clusters": -(-B // R), "blocks": CLUSTER * -(-B // R)}
    return None


def shape_reason(S: int, A: int, D: int, C: int, K: int = 31) -> str | None:
    """Why the kernel does not take these widths, or None if it does."""
    if S > MAX_S:
        return f"needs at most {MAX_S} memory positions, got {S}"
    if A > MAX_A or A % 32:
        return f"needs an attention width that is a multiple of 32 up to {MAX_A}, got {A}"
    if D % 32:
        return f"needs a memory width that is a multiple of 32, got {D}"
    if C > MAX_C:
        return f"needs at most {MAX_C} location channels, got {C}"
    if kernel_plan(1, S, A, D, K, C, 1) is None:
        need = smem_bytes(S, A, D, K, C, 1, 1, 2)
        return (f"needs {need} bytes of shared memory a block at one row a cluster "
                f"(S {S}, A {A}, D {D}, K {K}, C {C}); an H100 block has {SMEM_LIMIT}")
    return None


def max_clusters(device) -> int:
    """The kernel's clusters the card holds at once (one block an SM)."""
    idx = torch.device(device).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _MAX_CLUSTERS:
        out = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = KERNEL.lib().mstts_attention_max_clusters(ctypes.byref(out))
        if err != 0 or out.value < 1:
            raise RuntimeError(f"attention step kernel: no cluster fits the card (error {err})")
        _MAX_CLUSTERS[idx] = out.value
    return _MAX_CLUSTERS[idx]


_MAX_CLUSTERS: dict[int, int] = {}


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
                          ap: AttentionParams):
    """Launch ``csrc/attention_step.cu`` on CUDA f32 tensors. Same returns as
    :func:`attention_step_plain`."""
    B, S, A = keys.shape
    D, H = memory.shape[-1], h0.shape[-1]
    K, _, C = ap.conv_kernel.shape
    reason = shape_reason(S, A, D, C, K)
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
        return t if t.data_ptr() % 16 == 0 else t.clone()  # 16-byte loads and bulk copies

    ins = [f32(t) for t in (h0, w_prev_pad, cum_prev_pad, keys, memory, maskadd,
                            ap.wq, ap.conv_kernel, ap.wloc, ap.v)]
    plan = kernel_plan(B, S, A, D, K, C, max_clusters(keys.device))
    w = torch.empty((B, S), dtype=torch.float32, device=keys.device)
    cum = torch.empty_like(w)
    ctx = torch.empty((B, D), dtype=torch.float32, device=keys.device)
    ptrs = [t.data_ptr() for t in (*ins, w, cum, ctx)]
    dims = [B, S, A, D, H, K, C, plan["R"], plan["chunk"], plan["slots"]]
    KERNEL.call("mstts_attention_step", (ctypes.c_void_p * len(ptrs))(*ptrs),
                (ctypes.c_int * len(dims))(*dims), _build.stream_ptr(keys))
    return w, cum, ctx


def attention_step(h0, w_prev_pad, cum_prev_pad, keys, memory, maskadd,
                   ap: AttentionParams):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = attention_step_kernel if keys.is_cuda else attention_step_plain
    return fn(h0, w_prev_pad, cum_prev_pad, keys, memory, maskadd, ap)
