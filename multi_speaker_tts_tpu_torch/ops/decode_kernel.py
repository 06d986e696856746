"""K autoregressive decode steps in one kernel launch.

Replaces ``multi_speaker_tts_tpu/ops/decode_pallas.py::decode_segment_pallas``
(kernel body ``_kernel``, called through ``decoder_ar_segment_pallas``, weights
``prepare_bundle``), the chunk body of the early-exit decode under
``Synthesizer(quantize="int8_pallas" | "bf16_pallas")``. One call runs K
steps with no host work between them: prenet with the caller's dropout
scale masks, layer-0 gates from [prenet, context, h0], cell 0,
location-sensitive attention, context, layer-1 gates from [h0, context,
h1], cell 1, the fused frame + stop projection, and the frame feedback.
The two gate products are int8 (per-row activation and per-column weight
scales, exact s32 accumulation) or bf16 (f32 accumulation); everything else
is f32. The stopped / lengths bookkeeping stays outside, vectorised over
the chunk's stop logits (:func:`decoder_ar_segment_kernel`).

On a CUDA tensor :func:`decode_segment` launches ``csrc/decode.cu`` (one
persistent cooperative launch a group of at most 16 batch rows, as many
as fit the card's shared memory at the text's memory positions S,
:func:`kernel_row_groups` from :func:`layout_bytes`, the Python copy of the
kernel's layout; five grid-barrier rounds a step; gate
products on tensor cores, int8 weights resident in shared memory for the
segment, in bf16 mode layer 0's too and layer 1's streamed every step;
past H 1024 on an H100 up to four m-tiles of gate rows a block, the
windows that fit resident and the rest streamed, gate products deeper than
4,096 staged in pieces; int8 past H 2048 in passes of four m-tiles; see
the source's header) or raises; on a CPU tensor it runs
:func:`decode_segment_plain`, the same arithmetic in plain torch.
:func:`pack_gate_weights` lays each block's gate rows out in the order its
lanes read them, for the grid :func:`decode_layout` mirrors. The kernel
takes S up to the largest at which a launch over one row fits
(:func:`max_positions`, about 5,300 in bf16 and 3,800 in int8 at production
width on an H100); past it the AR decode runs the plain loop
(``models/tacotron.py`` ``Decoder._ar_setup``). The dropout masks are drawn by the wrapper from
the caller's ``prenet_masks(t)`` in the plain loop's order, so the plain
decode, the int8 plain decode and the kernel decode follow one trajectory
under one seed. :func:`kernel_body` hands the AR loops the kernel as their
chunk body.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.ops.decoder_scan import DecoderCarry, DecoderParams, quantize_w
from multi_speaker_tts_tpu_torch.ops.lstm import cell
from multi_speaker_tts_tpu_torch.ops.numerics import rounded

_FUNCTIONS = {"mstts_decode_segment": [_build.P, _build.P, _build.P],
              "mstts_decode_layout": [_build.P, _build.P]}
# One source, one launch count per mode.
KERNELS = {
    "int8": _build.Kernel("decode_segment_int8", "decode.cu", _FUNCTIONS),
    "bf16": _build.Kernel("decode_segment_bf16", "decode.cu", _FUNCTIONS),
}
MAX_B = 16  # batch rows a launch: two n-tiles of 8 in the gate products
PRENET_BLOCKS = 4  # blocks of csrc/decode.cu that run the prenet (kPre)
# Hidden units a gate block owns in one pass of the gate product: 4U gate
# rows in four m-tiles (kMaxMt); int8 takes more in passes, bf16 does not.
MAX_UNITS = 16
MAX_M_TILES = 4
# The limits of csrc/decode.cu, whose own check is the last guard.
_WIDTH = 16  # H, memory width and last prenet width in 16-element pieces
# The constants of csrc/decode.cu's make_layout.
_THREADS, _WARPS, _ROWS_A_PASS = 512, 16, 4
# The card the decisions below take on a CPU tensor (_build.H100).
H100 = _build.H100
card_limits = _build.card_limits


class Widths(NamedTuple):
    """The decoder's widths that size a launch of csrc/decode.cu."""
    H: int
    D: int
    P1: int
    P2: int
    A: int
    mel: int
    conv_k: int
    conv_c: int


def widths_of(bundle: dict) -> Widths:
    """The widths of a :func:`prepare_bundle` bundle."""
    H = bundle["b0"].shape[0] // 4
    conv_k, _, conv_c = bundle["ck"].shape
    return Widths(H, bundle["wproj"].shape[1] - H, bundle["wp1"].shape[0],
                  bundle["wp2"].shape[0], bundle["wq"].shape[1], bundle["wp1"].shape[1],
                  conv_k, conv_c)


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def _x_stride(n_bytes: int) -> int:
    s = -(-n_bytes // 64) * 64
    return s + 64 if s % 128 == 0 else s


def _place(B: int, S: int, w: Widths, quantized: bool, lay: dict, r0: int, r1: int,
           max_smem: int) -> int:
    """``place`` in csrc/decode.cu: the bytes of a launch over B rows at S
    with r0 / r1 windows of each m-tile resident (the location weights
    leave shared memory where they would not fit)."""
    U, mt = lay["U"], lay["mt"]
    nt = -(-B // 8)
    mp = mt > MAX_M_TILES  # passes of MAX_M_TILES, their partial sums beside the staged rows
    misc_at = 1024 * mt * (r0 + r1)
    pad = S + w.conv_k - 1
    loc = w.conv_c * w.A + w.conv_k * 2 * w.conv_c
    att = -(-(w.A + 2 * pad + S) // 4) * 4
    part = 4 * _WARPS * 16 * min(mt, MAX_M_TILES) * 8 * nt
    xs = B * lay["xstride"]
    gate = ((_align16(xs) + _align16(part) if mp else _align16(max(xs, part)))
            + 4 * (16 * mt * MAX_B + MAX_B + _ROWS_A_PASS * _WARPS))
    attn = 4 * (_WARPS * w.conv_c * 4 + w.A + _THREADS + S)
    per = -(-w.P2 // PRENET_BLOCKS)
    pre = 4 * (2 * B * w.P1 + w.P1 + per + B * per + B * w.mel + 24
               + 4 * max(w.mel, w.P1) + _THREADS * _ROWS_A_PASS * 2)
    scr = max(gate, attn, pre)
    # The location weights leave shared memory first; past four m-tiles then wq.
    for loc_res, wq_res in ((True, True), (False, True), (False, False))[:3 if mp else 2]:
        misc = (U * w.A if wq_res else 0) + 4 * 16 * mt + 2 * B * U
        total = (misc_at + _align16(4 * misc) + _align16(4 * (att + (loc if loc_res else 0)))
                 + scr)
        if total <= max_smem:
            break
    return total


def layout_bytes(B: int, S: int, w: Widths, quantized: bool, n_sm: int,
                 max_smem: int) -> dict:
    """``make_layout`` and the fit test of ``mstts_decode_layout`` in
    csrc/decode.cu, in Python: the dynamic shared memory a block of a
    launch over B rows at S memory positions takes (``total``), whether
    that launch fits a card of ``n_sm`` SMs and ``max_smem`` opt-in bytes a
    block (``fits``), and the windows of each layer's m-tiles it keeps
    resident (``r0``, ``r1``). Everything a block keeps scales with B or S
    but the gate weights: the B staged activation rows of a gate product,
    and the attention row's (w, cum), mask and energies. Every window is
    resident (int8 both layers, bf16 layer 0) unless the weights alone
    outgrow a block, so that not even a launch over one row at one position
    fits beside them (past H 1024 on an H100): then as many as fit beside
    the launch's other regions, layer 0's first, the rest streamed."""
    lay = decode_layout(w.H, n_sm)
    win = 64 if quantized else 32
    K0p = -(-(w.P2 + w.D + w.H) // win) * win
    K1p = -(-(2 * w.H + w.D) // win) * win
    nw0, nw1 = K0p // win, K1p // win
    lay = dict(lay, xstride=_x_stride((1 if quantized else 2) * max(K0p, K1p)))
    full1 = nw1 if quantized else 0
    r0, r1 = nw0, full1
    total = _place(B, S, w, quantized, lay, r0, r1, max_smem)
    if (total > max_smem
            and _place(1, 1, w, quantized, lay, nw0, full1, max_smem) > max_smem):
        total = _place(B, S, w, quantized, lay, 0, 0, max_smem)
        if total <= max_smem:
            nres = (max_smem - total) // (1024 * lay["mt"])
            r0 = min(nres, nw0)
            r1 = min(nres - r0, full1)
            total = _place(B, S, w, quantized, lay, r0, r1, max_smem)
        else:
            r0 = r1 = 0
    fits = (total <= max_smem and lay["grid"] <= n_sm
            and (lay["mt"] <= MAX_M_TILES or quantized) and B <= lay["nblk"])
    return {"total": total, "fits": fits, "r0": r0, "r1": r1}


@functools.lru_cache(maxsize=256)
def max_positions(w: Widths, quantized: bool, n_sm: int, max_smem: int,
                  rows: int = 1) -> int:
    """The largest S at which a launch over ``rows`` rows fits (0 if none):
    with ``rows=1`` the kernel's own limit on memory positions. A launch's
    bytes grow with S, so the fitting S are 1 .. the limit."""
    fits = lambda S: layout_bytes(rows, S, w, quantized, n_sm, max_smem)["fits"]  # noqa: E731
    if not fits(1):
        return 0
    lo, hi = 1, 2
    while fits(hi):
        lo, hi = hi, 2 * hi
    while hi - lo > 1:  # fits(lo), not fits(hi)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid)
    return lo


@functools.lru_cache(maxsize=256)
def group_rows(S: int, w: Widths, quantized: bool, n_sm: int, max_smem: int) -> int:
    """The most rows, up to MAX_B, that one launch takes at S (0 if not one)."""
    return max((b for b in range(1, MAX_B + 1)
                if layout_bytes(b, S, w, quantized, n_sm, max_smem)["fits"]), default=0)


def _shape_reason(H: int, D: int, prenet_sizes, S: int | None, A: int, mel_dim: int,
                  conv_c: int, conv_k: int = 31, quantized: bool = True,
                  card: tuple[int, int] = H100) -> str | None:
    """The one shape gate of the kernel: why it does not take these widths,
    or None. Any batch is taken (:func:`row_groups`); memory positions up to
    the largest S at which a launch over one row fits the card's shared
    memory (:func:`max_positions`; ``card``: SMs and opt-in bytes a block);
    in int8 any H (past 16 units a gate block the multi-pass build), in
    bf16 up to 16 units a gate block (H 2048 on an H100; past it the
    reference's 80 MB rule refuses too). ``S=None`` checks the widths
    alone."""
    P1, P2 = prenet_sizes
    if H % _WIDTH or D % _WIDTH or P2 % _WIDTH:
        return (f"needs H, memory and prenet widths in multiples of {_WIDTH}: "
                f"{H}, {D}, {P2}")
    if P1 % 4 or mel_dim % 4 or A % 4 or conv_c % 4:
        return ("needs the first prenet, mel, attention and location-conv widths in "
                f"multiples of 4: {P1}, {mel_dim}, {A}, {conv_c}")
    if not quantized and decode_layout(H, card[0])["mt"] > MAX_M_TILES:
        return (f"needs at most {4 * MAX_UNITS} gate rows a block in bf16 mode: H <= "
                f"{MAX_UNITS} x (SMs - {PRENET_BLOCKS}) = "
                f"{MAX_UNITS * (card[0] - PRENET_BLOCKS)} on this card, got H={H}")
    if S is not None:
        limit = max_positions(Widths(H, D, P1, P2, A, mel_dim, conv_k, conv_c), quantized, *card)
        if S > limit:
            return position_reason(S, limit, quantized)
    return None


def position_reason(S: int, limit: int, quantized: bool) -> str:
    return (f"needs at most {limit} memory positions in {'int8' if quantized else 'bf16'} "
            "mode (the largest S at which a launch over one row fits the card's shared "
            f"memory), got {S}")


def unsupported_reason(p: DecoderParams, prenet_sizes, memory_dim: int, S: int | None,
                       mel_dim: int, quantized: bool = True,
                       card: tuple[int, int] = H100) -> str | None:
    """Why the kernel does not take this decoder at S memory positions
    (``None``: at any), or None if it does."""
    if len(p.lstm) != 2 or len(prenet_sizes) != 2:
        return (f"needs the 2-layer decoder and prenet, got {len(p.lstm)} and "
                f"{len(prenet_sizes)} layers")
    H = p.lstm[0].hidden_size
    if p.lstm[1].hidden_size != H:
        return "needs equal LSTM sizes"
    conv_k, _, conv_c = p.attention.conv_kernel.shape
    return _shape_reason(H, memory_dim, prenet_sizes, S, p.attention.wq.shape[1],
                         mel_dim, conv_c, conv_k, quantized, card)


def supported(p: DecoderParams, prenet_sizes, memory_dim: int, S: int | None,
              mel_dim: int, quantized: bool = True, card: tuple[int, int] = H100) -> bool:
    return unsupported_reason(p, prenet_sizes, memory_dim, S, mel_dim, quantized, card) is None


# The JAX gate's budget for the bf16 mode's fused weights (bytes).
REFERENCE_BF16_WEIGHT_BYTES = 80 * 1024 * 1024


def reference_supported(p: DecoderParams, prenet_sizes, memory_dim: int, S: int,
                        quantized: bool = True) -> bool:
    """The JAX package's gate of its decode kernel (``decode_pallas.supported``:
    a TPU's lane and VMEM budgets), copied: the 2-layer decoder with equal
    LSTM sizes, widths in multiples of 128, S <= 256 and, in bf16, both
    fused matrices within 80 MB. Where it refuses, the reference decodes on
    its XLA path; where the port's kernel refuses too, so does the port
    (``Decoder._ar_setup``)."""
    if len(p.lstm) != 2:
        return False
    H = p.lstm[0].hidden_size
    P = prenet_sizes[-1]
    lane = _build.REFERENCE_LANE
    if p.lstm[1].hidden_size != H or H % lane or memory_dim % lane or P % lane or S > 256:
        return False
    if not quantized:
        w_bytes = 2 * 4 * H * ((P + memory_dim + H) + (2 * H + memory_dim))
        return w_bytes <= REFERENCE_BF16_WEIGHT_BYTES
    return True


def plain_reason(p: DecoderParams, prenet_sizes, memory_dim: int, S: int, mel_dim: int,
                 quantized: bool, card: tuple[int, int], on_card: bool) -> str | None:
    """Why the AR decode runs the plain loop in the kernel's place, or None
    (the kernel, which raises on any other refusal). The reference decodes
    on its XLA path wherever its gate refuses (:func:`reference_supported`);
    the port does where its kernel refuses too: past the kernel's limit on
    memory positions (:func:`position_limit`, on any device), and on the
    card at widths the kernel refuses at any S."""
    limit = position_limit(p, prenet_sizes, memory_dim, mel_dim, quantized, card)
    if limit is not None:
        if S <= limit:
            return None
        return (f"S={S} past the decode kernel's {limit} memory positions in "
                f"{'int8' if quantized else 'bf16'} mode")
    if not on_card or reference_supported(p, prenet_sizes, memory_dim, S, quantized):
        return None
    why = unsupported_reason(p, prenet_sizes, memory_dim, S, mel_dim, quantized, card)
    return f"decode kernel {why}; the reference's gate refuses it too"


def position_limit(p: DecoderParams, prenet_sizes, memory_dim: int, mel_dim: int,
                   quantized: bool, card: tuple[int, int]) -> int | None:
    """The kernel's limit on memory positions for this decoder on ``card``
    (:func:`max_positions` at one row), or None where it refuses the
    decoder at any S: past the limit and only there, the AR decode runs
    the plain loop (``Decoder._ar_setup``)."""
    if not supported(p, prenet_sizes, memory_dim, None, mel_dim, quantized, card):
        return None
    H = p.lstm[0].hidden_size
    conv_k, _, conv_c = p.attention.conv_kernel.shape
    w = Widths(H, memory_dim, *prenet_sizes, p.attention.wq.shape[1], mel_dim, conv_k, conv_c)
    return max_positions(w, quantized, *card) or None


def decode_layout(H: int, n_sm: int) -> dict:
    """The kernel's grid (``make_layout`` in ``csrc/decode.cu``): U units a
    gate block, ``nblk`` gate blocks, PRENET_BLOCKS prenet blocks, and the
    m-tiles of a block's 4U gate rows."""
    U = -(-H // (n_sm - PRENET_BLOCKS))
    nblk = -(-H // U)
    return {"U": U, "nblk": nblk, "grid": nblk + PRENET_BLOCKS, "mt": -(-4 * U // 16)}


def gate_rows(H: int, U: int, nblk: int, mt: int) -> torch.Tensor:
    """(nblk, 16 mt) indices into the 4H gate columns, -1 for a pad row:
    block j's local row r = g U + u is gate g of unit j U + u."""
    r = torch.arange(16 * mt)
    g, u = r // U, r % U
    unit = torch.arange(nblk)[:, None] * U + u[None]
    ok = (g[None] < 4) & (unit < H)
    return torch.where(ok, g[None] * H + unit, torch.full_like(unit, -1))


def pack_gate_weights(w: torch.Tensor, H: int, U: int, nblk: int, mt: int) -> torch.Tensor:
    """(4H, K) gate rows (int8, or bf16) -> the kernel's bytes (nblk, mt,
    windows, 2, 32, 16): a window is 64 int8 or 32 bf16 values of k, depth
    zero-padded to whole windows; lane 4 g + t of half h holds the 16 bytes
    of k at t x 16 bytes of row 16 m + g + 8 h (:func:`gate_rows`), pad rows
    zero."""
    esize = w.element_size()
    per = 16 // esize  # values a lane's 16 bytes
    win = 4 * per
    K = w.shape[1]
    Kp = -(-K // win) * win
    idx = gate_rows(H, U, nblk, mt).to(w.device)
    rows = torch.nn.functional.pad(w.view(torch.int16) if esize == 2 else w, (0, Kp - K))
    rows = torch.where((idx >= 0)[..., None], rows[idx.clamp(min=0)], torch.zeros_like(rows[:1]))
    # (nblk, mt, h, g, window, t, per) -> (nblk, mt, window, h, g, t, per)
    rows = rows.reshape(nblk, mt, 2, 8, Kp // win, 4, per).permute(0, 1, 4, 2, 3, 5, 6)
    return rows.contiguous().view(torch.uint8).reshape(nblk, mt, Kp // win, 2, 32, 16)


def _bundle(quantize: bool, ws) -> dict:
    (w_ih0, w_hh0, b0, w_ih1, w_hh1, b1, wq, ck, wloc, v,
     frame_w, frame_b, stop_w, stop_b, wp1, bp1, wp2, bp2) = ws
    out = {"quantized": quantize}
    for i, (w_ih, w_hh, b) in enumerate(((w_ih0, w_hh0, b0), (w_ih1, w_hh1, b1))):
        cat = torch.cat([w_ih, w_hh], dim=0).float()
        if quantize:
            wq8, scale = quantize_w(cat)
            out[f"w{i}"] = wq8.t().contiguous()  # (4H, K) rows per gate column
            out[f"s{i}"] = scale.contiguous()
        else:
            out[f"w{i}"] = cat.t().contiguous().to(torch.bfloat16)
            out[f"s{i}"] = torch.ones_like(b, dtype=torch.float32)
        out[f"b{i}"] = b.float().contiguous()
    # Fused frame + stop projection, f32: rows = mel*r frame outputs, then stop.
    out["wproj"] = torch.cat([frame_w, stop_w], dim=1).float().t().contiguous()
    out["bproj"] = torch.cat([frame_b, stop_b]).float().contiguous()
    out["wp1"], out["bp1"] = wp1.float().t().contiguous(), bp1.float().contiguous()
    out["wp2"], out["bp2"] = wp2.float().t().contiguous(), bp2.float().contiguous()
    out["wq"] = wq.float().contiguous()
    out["ck"] = ck.float().contiguous()
    out["wloc"] = wloc.float().contiguous()
    out["v"] = v.float().reshape(-1).contiguous()
    return out


def _bundle_int8(*ws) -> dict:
    return _bundle(True, ws)


def _bundle_bf16(*ws) -> dict:
    return _bundle(False, ws)


def prepare_bundle(p: DecoderParams, prenet_ws, quantize: bool = True) -> dict:
    """Every per-step weight in the kernel's layout: the fused [W_ih; W_hh]
    of both layers as (4H, K) rows (int8 with per-column scales, or bf16),
    the fused f32 frame + stop projection, the prenet and the attention
    weights. Built once per weight state (``_build.packed``), never per call.
    ``prenet_ws``: [(w1 (mel, P1), b1), (w2 (P1, P2), b2)]."""
    if len(p.lstm) != 2 or len(prenet_ws) != 2:
        raise ValueError("the decode segment needs a 2-layer decoder and a 2-layer prenet")
    if p.lstm[0].hidden_size != p.lstm[1].hidden_size:
        raise ValueError("the decode segment needs equal LSTM sizes")
    ap = p.attention
    ws = (*p.lstm[0], *p.lstm[1], ap.wq, ap.conv_kernel, ap.wloc, ap.v,
          *p.frame_proj, *p.stop_proj, *prenet_ws[0], *prenet_ws[1])
    return _build.packed(_bundle_int8 if quantize else _bundle_bf16, *ws)


def _segment_gates(bundle: dict, i: int, xh: torch.Tensor) -> torch.Tensor:
    w, s, b = bundle[f"w{i}"], bundle[f"s{i}"], bundle[f"b{i}"]
    if bundle["quantized"]:
        xq, amax = dscan.quantize_rows(xh)
        return dscan.int8_product(xq, w.t()) * (amax * s[None, :]) + b
    return rounded(xh, torch.bfloat16) @ w.float().t() + b


def decode_segment_plain(bundle: dict, keys, memory, mask, carry: DecoderCarry,
                         prev, m1, m2, K: int, mel_dim: int, r: int):
    """The kernel's arithmetic in plain torch. ``m1`` / ``m2``: (K, B, P)
    dropout scale masks (keep / keep_prob) or None. Returns (carry', prev',
    frames (K, B, mel*r), stops (K, B), aligns (K, B, S)). One row runs as
    two (:func:`..decoder_scan.one_row_as_two`)."""
    if prev.shape[0] == 1:
        return dscan.one_row_as_two(lambda two: decode_segment_plain(
            bundle, *(dscan.take_rows(x, two) for x in (keys, memory, mask, carry, prev)),
            *(None if m is None else m[:, two] for m in (m1, m2)), K, mel_dim, r), prev.device)
    ap = dscan.AttentionParams(bundle["wq"], bundle["ck"], bundle["wloc"],
                               bundle["v"][:, None])
    (h0, h1), (c0, c1) = carry.h, carry.c
    w, cum, ctx = carry.weights, carry.cum_weights, carry.context
    memory = memory.float()
    ys, aligns = [], []
    for k in range(K):
        a = torch.relu(prev @ bundle["wp1"].t() + bundle["bp1"])
        if m1 is not None:
            a = a * m1[k]
        a = torch.relu(a @ bundle["wp2"].t() + bundle["bp2"])
        if m2 is not None:
            a = a * m2[k]
        h0, c0 = cell(_segment_gates(bundle, 0, torch.cat([a, ctx, h0], dim=-1)), c0)
        w, cum = dscan.attention_block(h0, w, cum, keys, ap, mask)
        ctx = torch.bmm(w[:, None, :], memory)[:, 0]
        h1, c1 = cell(_segment_gates(bundle, 1, torch.cat([h0, ctx, h1], dim=-1)), c1)
        y = torch.cat([h1, ctx], dim=-1) @ bundle["wproj"].t() + bundle["bproj"]
        prev = y[:, mel_dim * (r - 1):mel_dim * r]
        ys.append(y)
        aligns.append(w)
    ys = torch.stack(ys)
    carry = DecoderCarry((h0, h1), (c0, c1), w, cum, ctx)
    return carry, prev, ys[..., :mel_dim * r], ys[..., mel_dim * r], torch.stack(aligns)


def row_groups(B: int, rows: int = MAX_B) -> list[slice]:
    """The launches of one chunk: consecutive groups of ``rows`` rows (the
    last takes the rest). Decode rows are independent (only the weights are
    shared), so each group runs as its own launch on views of the batch's
    state."""
    return [slice(g, min(g + rows, B)) for g in range(0, B, rows)]


def kernel_row_groups(bundle: dict, B: int, S: int, device) -> list[slice]:
    """The row groups the kernel launches over for B rows at S memory
    positions on ``device``: the most rows, up to MAX_B, whose launch fits
    the card's shared memory at this S (:func:`group_rows`). Each group
    reads the gate weights again. Raises past the one-row limit."""
    w = widths_of(bundle)
    card = card_limits(device)
    rows = group_rows(S, w, bundle["quantized"], *card)
    if rows == 0:
        raise ValueError("decode kernel " + position_reason(
            S, max_positions(w, bundle["quantized"], *card), bundle["quantized"]))
    return row_groups(B, rows)


# Pointer table of csrc/decode.cu (enum Ptr), in order.
_WEIGHT_KEYS = ("w0", "w1", "s0", "b0", "s1", "b1", "wproj", "bproj", "wp1", "bp1",
                "wp2", "bp2", "wq", "ck", "wloc", "v")


def decode_segment_kernel(bundle: dict, keys, memory, mask, carry: DecoderCarry,
                          prev, m1, m2, K: int, mel_dim: int, r: int):
    """Launch ``csrc/decode.cu`` on CUDA f32 state, once for each group of
    :func:`kernel_row_groups`. Same returns as :func:`decode_segment_plain`.
    Raises for what the kernel does not take (:func:`_shape_reason`), S past
    its one-row limit included."""
    B, S, A = keys.shape
    D = memory.shape[-1]
    H = carry.h[0].shape[-1]
    P1, P2 = bundle["wp1"].shape[0], bundle["wp2"].shape[0]
    conv_k, _, conv_c = bundle["ck"].shape
    reason = _shape_reason(H, D, (P1, P2), S, A, mel_dim, conv_c, conv_k, bundle["quantized"],
                           card_limits(keys.device))
    if reason is not None:
        raise ValueError(f"decode kernel {reason}")
    if bundle["wproj"].shape != (mel_dim * r + 1, H + D) or bundle["wp1"].shape[1] != mel_dim:
        raise ValueError("decode kernel: bundle and mel_dim / r disagree")
    if m1 is not None and (m1.shape != (K, B, P1) or m2.shape != (K, B, P2)):
        raise ValueError("decode kernel: dropout masks must be (K, B, P1) and (K, B, P2)")
    rows = [memory.shape[0], mask.shape[0], prev.shape[0], *(x.shape[0] for x in carry.h),
            *(x.shape[0] for x in carry.c), carry.weights.shape[0], carry.cum_weights.shape[0],
            carry.context.shape[0]]
    if any(n != B for n in rows) or mask.shape[1] != S or memory.shape[1] != S:
        raise ValueError(f"decode kernel: inputs disagree on the batch rows ({B} keys rows, "
                         f"then {rows}) or the memory positions")
    groups = kernel_row_groups(bundle, B, S, keys.device)
    if len(groups) == 1:
        return _launch(bundle, keys, memory, mask, carry, prev, m1, m2, K, mel_dim, r)
    outs = [_launch(bundle, keys[g], memory[g], mask[g],
                    DecoderCarry(*(tuple(x[g] for x in v) if isinstance(v, tuple) else v[g]
                                   for v in carry)),
                    prev[g], None if m1 is None else m1[:, g], None if m2 is None else m2[:, g],
                    K, mel_dim, r)
            for g in groups]
    carries = [o[0] for o in outs]
    carry = DecoderCarry(*(tuple(torch.cat(x) for x in zip(*v)) if isinstance(v[0], tuple)
                           else torch.cat(v) for v in zip(*carries)))
    return (carry, torch.cat([o[1] for o in outs]),
            *(torch.cat([o[i] for o in outs], dim=1) for i in (2, 3, 4)))


def _launch(bundle: dict, keys, memory, mask, carry: DecoderCarry, prev, m1, m2, K: int,
            mel_dim: int, r: int):
    """One launch of ``csrc/decode.cu`` over one row group."""
    B, S, A = keys.shape
    D = memory.shape[-1]
    H = carry.h[0].shape[-1]
    P1, P2 = bundle["wp1"].shape[0], bundle["wp2"].shape[0]
    conv_k, _, conv_c = bundle["ck"].shape
    n_out = mel_dim * r + 1

    def f32(t):
        t = t.contiguous()
        _build.require_cuda(t, torch.float32, "decode segment input")
        return t if t.data_ptr() % 16 == 0 else t.clone()  # the kernel loads 16 bytes at a time

    keys, memory, mask = f32(keys), f32(memory), f32(mask)
    state = [f32(t) for t in (carry.h[0], carry.c[0], carry.h[1], carry.c[1],
                              carry.weights, carry.cum_weights, carry.context, prev)]
    if m1 is not None:
        m1, m2 = f32(m1), f32(m2)
    dev = keys.device
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    lay = decode_layout(H, n_sm)
    packed = bundle.setdefault("packed", {})
    key = (lay["U"], lay["nblk"], lay["mt"], dev)
    if key not in packed:
        packed[key] = tuple(pack_gate_weights(bundle[f"w{i}"], H, lay["U"], lay["nblk"], lay["mt"])
                            for i in range(2))
    w0p, w1p = packed[key]
    sizes = [K * B * n_out, K * B * S, B * H, B * H, B * H, B * H, B * S, B * S, B * D,
             B * mel_dim,  # the outputs, then the scratch (see mstts_decode_segment):
             4 * B * H + B * (D + P2) + 4 * B * A]  # h0, h1 x 2, ctx, a2, 64-bit query sums
    # One allocation, every piece 16-byte aligned.
    padded = [-(-n // 4) * 4 for n in sizes]
    flat = torch.empty(sum(padded), dtype=torch.float32, device=dev)
    (ys, aligns, h0, c0, h1, c1, w, cum, ctx, prev_out, scratch) = (
        piece[:n] for piece, n in zip(flat.split(padded), sizes))
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    ptrs = [w0p.data_ptr(), w1p.data_ptr()] + [bundle[k].data_ptr() for k in _WEIGHT_KEYS[2:]]
    ptrs += [keys.data_ptr(), memory.data_ptr(), mask.data_ptr(),
             0 if m1 is None else m1.data_ptr(), 0 if m2 is None else m2.data_ptr()]
    ptrs += [t.data_ptr() for t in state]
    ptrs += [t.data_ptr() for t in (ys, aligns, h0, c0, h1, c1, w, cum, ctx, prev_out,
                                    scratch, bar)]
    dims = [K, B, S, A, D, H, P1, P2, mel_dim, r, conv_k, conv_c, int(bundle["quantized"])]
    KERNELS["int8" if bundle["quantized"] else "bf16"].call(
        "mstts_decode_segment", (ctypes.c_void_p * len(ptrs))(*ptrs),
        (ctypes.c_int * len(dims))(*dims), _build.stream_ptr(keys),
    )
    ys = ys.view(K, B, n_out)
    carry = DecoderCarry((h0.view(B, H), h1.view(B, H)), (c0.view(B, H), c1.view(B, H)),
                         w.view(B, S), cum.view(B, S), ctx.view(B, D))
    return (carry, prev_out.view(B, mel_dim), ys[..., :mel_dim * r], ys[..., mel_dim * r],
            aligns.view(K, B, S))


def decode_segment(bundle: dict, keys, memory, mask, carry: DecoderCarry, prev,
                   m1, m2, K: int, mel_dim: int, r: int):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    fn = decode_segment_kernel if keys.is_cuda else decode_segment_plain
    return fn(bundle, keys, memory, mask, carry, prev, m1, m2, K, mel_dim, r)


def scale_masks(prenet_masks: Callable, t0: int, K: int, keep_prob: float,
                rows: torch.Tensor | None = None):
    """The keep masks of steps t0 .. t0+K-1, drawn from ``prenet_masks(t)``
    in the plain loop's order (per step: layer 1, then layer 2), as two
    (K, B, P) f32 scale masks keep / keep_prob, of the batch rows ``rows``
    alone where given. (For keep_prob = 0.5 the scaled product equals the
    plain loop's x / keep_prob bit for bit.)"""
    drawn = [prenet_masks(t0 + i) for i in range(K)]

    def scaled(layer):
        m = torch.stack([d[layer] for d in drawn])
        return (m if rows is None else m[:, rows]).float() / keep_prob

    return scaled(0), scaled(1)


def advance_stops(stop_logits, stopped, lengths, stop_threshold: float):
    """The plain loop's per-step bookkeeping (lengths += ~stopped, THEN
    stopped |= flag), vectorised over a segment's (K, B) stop logits: step t
    counts iff no flag was raised before t (exclusive prefix). Returns
    (stopped', lengths')."""
    flags = torch.sigmoid(stop_logits.float()) > stop_threshold
    before = stopped[None] | ((torch.cumsum(flags, dim=0) - flags.to(torch.int64)) > 0)
    return (stopped | flags.any(dim=0),
            lengths + (~before).sum(dim=0).to(lengths.dtype))


def decoder_ar_segment_kernel(bundle: dict, keys, memory, mask, carry: DecoderCarry,
                              prev, t0: int, stopped, lengths, n_steps_seg: int,
                              stop_threshold: float, prenet_masks: Callable | None,
                              mel_dim: int, r: int, prenet_dropout: float,
                              rows: torch.Tensor | None = None):
    """The kernel's chunk of ``n_steps_seg`` steps: the same return tuple as
    ``decoder_scan.decoder_ar_segment``, with the stopped / lengths
    bookkeeping applied, vectorised, to the segment's per-step stop logits.
    The state holds the batch rows ``rows`` (None: every row of
    ``prenet_masks``' draws), whose keep masks the chunk reads."""
    m1 = m2 = None
    if prenet_dropout > 0.0:
        m1, m2 = scale_masks(prenet_masks, t0, n_steps_seg, 1.0 - prenet_dropout, rows)
    carry, prev, f_k, s_k, w_k = decode_segment(
        bundle, keys, memory, mask, carry, prev, m1, m2, n_steps_seg, mel_dim, r)
    stopped, lengths = advance_stops(s_k, stopped, lengths, stop_threshold)
    return carry, prev, stopped, lengths, f_k, s_k, w_k


def kernel_body(bundle: dict, prenet_masks: Callable | None, mel_dim: int, r: int,
                prenet_dropout: float) -> Callable:
    """The kernel's chunk body for the AR loops of ``decoder_scan``: each
    call runs :func:`decoder_ar_segment_kernel`, looked up in this module
    when it is called."""
    def body(keys, memory, mask, carry, prev, t0, stopped, lengths, K, stop_threshold,
             rows=None):
        return decoder_ar_segment_kernel(bundle, keys, memory, mask, carry, prev, t0, stopped,
                                         lengths, K, stop_threshold, prenet_masks, mel_dim, r,
                                         prenet_dropout, rows=rows)

    return body
