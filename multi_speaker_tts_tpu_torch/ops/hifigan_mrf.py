"""HiFi-GAN's multi-receptive-field fusion (the MRF of ``models/hifigan.py``)
as channels-last implicit-GEMM convolutions, a Hopper kernel
(``csrc/hifigan_mrf.cu``; no TPU counterpart: the JAX package has no
generator).

Activations are (B, L, C), channels last, between the convolutions. Each
ResBlock1 dilation step is two launches of one kernel (:func:`conv`):

- conv 1 (dilation d) reads the step's activation and writes
  ``lrelu(conv + bias, 0.1)``, rounded once to the compute dtype;
- conv 2 (dilation 1) reads that, adds its bias and the f32 residual, and
  writes the residual and the next step's activation; on a block's last
  dilation it adds the block's output into the stage's f32 MRF sum, and on
  the last block writes the mean (:func:`mrf`).

Two pointwise passes sit at the MRF's edges: :func:`mrf_in` makes the
stage's f32 input from the transposed convolution's output (its bias added
in f32), and :func:`activation` writes an f32 input's activation once for
all the blocks. Arithmetic: the operands of every convolution rounded to
bf16 once, f32 sums, the residual stream and the MRF's sum and mean in f32.

:func:`conv_plain` is one launch's function in plain torch (the f32 sum of
the rounded operands, then the same epilogue in the same order); on a CPU
tensor :func:`conv` runs it, so :func:`mrf` is the same sequence of
buffers and launches on either device. :func:`use_kernel` is the dispatch:
bf16 on the card launches, and refuses a convolution the kernel was not
built for (:data:`TILES`); a CPU tensor or another compute dtype runs the
generator's plain path.
"""

from __future__ import annotations

import ctypes
import functools
import re
from typing import NamedTuple

import torch
import torch.nn.functional as F

from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch.audio.dsp import log_dispatch
from multi_speaker_tts_tpu_torch.ops import _build

_CONV_ARGS = [
    _build.P, _build.P, _build.P,  # a, w, bias
    _build.P, _build.P, _build.P, _build.P,  # xin, sum, xout, act
    _build.I, _build.I, _build.I, _build.I, _build.I,  # B, L, C, k, d
    _build.F, _build.F,  # slope, div
    _build.P,  # stream
]
KERNEL = _build.Kernel("hifigan_mrf_conv", "hifigan_mrf.cu", {"mstts_mrf_conv": _CONV_ARGS})
IN_KERNEL = _build.Kernel("hifigan_mrf_in", "hifigan_mrf.cu", {
    "mstts_mrf_in": [_build.P, _build.P, _build.P, ctypes.c_longlong, _build.I, _build.P],
    "mstts_mrf_act": [_build.P, _build.P, ctypes.c_longlong, _build.F, _build.P]})

SLOPE = 0.1  # the stages' LeakyReLU slope (LRELU_SLOPE of the public code)


def _tiles() -> dict[int, tuple[int, ...]]:
    """The kernel's instantiations, read from its source's ``using TileN =
    Tile<C, ...>`` lines: width C -> (warps along L, warps along C, rows and
    columns of a warp's tile, input channels a pipeline step, depth of the
    weight ring)."""
    text = (_build.CSRC / KERNEL.source).read_text()
    found = re.findall(r"^using Tile\d+ = Tile<([\d, ]+)>;", text, re.M)
    return {int(t[0]): tuple(t[1:7]) for t in ([int(v) for v in f.split(",")] for f in found)}


TILES = _tiles()


class Plan(NamedTuple):
    tm: int  # positions a block
    tn: int  # output channels a block
    rows: int  # slab rows: tm + (k - 1) d
    smem: int  # dynamic shared memory a block, bytes
    grid: tuple[int, int, int]  # (position tiles, channel tiles, rows B)


def plan(C: int, k: int, d: int, L: int, B: int) -> Plan:
    """One launch at width C, kernel k, dilation d over (B, L, C), as
    ``launch`` in the source makes it: the bf16 slab of (tm + (k - 1) d)
    rows x (C + 8) and a ring of weight chunks of tn x (chunk + 8)."""
    wm, wn, rows, cols, chunk, stages = TILES[C]
    tm, tn = wm * rows, wn * cols
    slab = tm + (k - 1) * d
    smem = 2 * (slab * (C + 8) + stages * tn * (chunk + 8))
    return Plan(tm, tn, slab, smem, (-(-L // tm), C // tn, B))


def refusal(C: int, k: int, d: int, card: tuple[int, int] = _build.H100) -> str | None:
    """Why the kernel does not take a convolution of width C, kernel k and
    dilation d on ``card`` (SMs, opt-in bytes a block), or None."""
    if C not in TILES:
        return f"{C} channels: the MRF kernel is built for {sorted(TILES)}"
    if k % 2 == 0 or k < 1 or d < 1:
        return f"kernel {k}, dilation {d}: the MRF kernel takes odd kernels and d >= 1"
    need = plan(C, k, d, 1, 1).smem
    if need > card[1]:
        return (f"kernel {k}, dilation {d} at {C} channels: a block needs {need} bytes of "
                f"shared memory, the card gives {card[1]}")
    return None


@functools.lru_cache(maxsize=64)
def route(on_card: bool, compute_dtype, shapes: tuple, card: tuple[int, int] = _build.H100
          ) -> tuple[str, str | None]:
    """("kernel", None) where the MRF kernels run a generator's stages of
    these (C, k, d) convolutions (``shapes``); ("plain", why) for a CPU
    tensor (no reason to print) or a compute dtype other than bf16. bf16 on
    the card at a convolution the kernel refuses (:func:`refusal`) raises:
    the plain path is the f32 compute dtype's."""
    if not on_card:
        return "plain", None
    if compute_dtype != torch.bfloat16:
        return "plain", f"compute dtype {compute_dtype}: the MRF kernels compute in bf16 only"
    for C, k, d in shapes:
        why = refusal(C, k, d, card)
        if why is not None:
            raise ValueError(f"HiFi-GAN MRF in bf16 on the card: {why}; the generator's "
                             "plain path runs in f32 (Train.Use_Mixed_Precision false)")
    return "kernel", None


def use_kernel(x: torch.Tensor, compute_dtype, shapes) -> bool:
    """:func:`route` for the device ``x`` lies on; a plain route on the card
    prints one ``[dispatch] hifigan_mrf -> plain`` line a process."""
    chosen, why = route(x.is_cuda, compute_dtype, shapes,
                        _build.card_limits(x.device) if x.is_cuda else _build.H100)
    if chosen == "plain" and why is not None:
        log_dispatch("hifigan_mrf", "plain", why)
    return chosen == "kernel"


def _taps(w: torch.Tensor) -> torch.Tensor:
    return w.permute(2, 0, 1).contiguous()  # (C_out, C_in, k) -> (k, C_out, C_in)


def _f32(b: torch.Tensor) -> torch.Tensor:
    return b.float().contiguous()


def conv_plain(a, w, bias, d, xin=None, acc=None, xout=None, act=None, slope=SLOPE, div=1.0):
    """One launch in plain torch on (B, L, C) tensors: ``v = conv_d(a) + bias``
    summed in f32 from the rounded operands, then ``v = xin + v``, ``v = acc +
    v``, ``v / div`` where given, ``xout`` <- v and ``act`` <- lrelu(v,
    slope) in act's dtype. ``xout`` may be ``xin`` or ``acc``."""
    k = w.shape[-1]
    v = F.conv1d(a.transpose(1, 2).float(), w.float(), bias.float(), dilation=d,
                 padding=d * (k - 1) // 2).transpose(1, 2)
    if xin is not None:
        v = xin + v
    if acc is not None:
        v = acc + v
    if div != 1:
        v = v / div
    if xout is not None:
        xout.copy_(v)
    if act is not None:
        act.copy_(F.leaky_relu(v, slope))


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check(t, dtype, shape, name):
    _build.require_cuda(t, dtype, name)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")


def conv_kernel(a, w, bias, d, xin=None, acc=None, xout=None, act=None, slope=SLOPE, div=1.0):
    """Launch ``mstts_mrf_conv``: :func:`conv_plain`'s function on CUDA
    tensors, a bf16 (B, L, C) activation and weight, f32 residual, sum and
    output, a bf16 ``act``."""
    _build.require_cuda(a, torch.bfloat16, "a")
    B, L, C = a.shape
    k = w.shape[-1]
    if tuple(w.shape) != (C, C, k) or w.dtype != torch.bfloat16:
        raise ValueError(f"weight must be bf16 {(C, C, k)}, got {w.dtype} {tuple(w.shape)}")
    why = refusal(C, k, d, _build.card_limits(a.device))
    if why is not None:
        raise ValueError(f"MRF kernel: {why}")
    for t, name in ((xin, "xin"), (acc, "acc"), (xout, "xout")):
        if t is not None:
            _check(t, torch.float32, (B, L, C), name)
    if act is not None:
        _check(act, torch.bfloat16, (B, L, C), "act")
    if L == 0:
        return
    wt, bt = _build.packed(_taps, w), _build.packed(_f32, bias)
    KERNEL.call("mstts_mrf_conv", a.data_ptr(), wt.data_ptr(), bt.data_ptr(), _ptr(xin),
                _ptr(acc), _ptr(xout), _ptr(act), B, L, C, k, d, float(slope), float(div),
                _build.stream_ptr(a))


def conv(a, w, bias, d, **epilogue):
    """:func:`conv_kernel` on a CUDA tensor, :func:`conv_plain` on a CPU one."""
    (conv_kernel if a.is_cuda else conv_plain)(a, w, bias, d, **epilogue)


def _channels_last(t: torch.Tensor) -> None:
    if not t.is_contiguous() or t.data_ptr() % 16 or t.shape[-1] % 8:
        raise ValueError(f"a contiguous (B, L, C) tensor, C a multiple of 8, is needed: "
                         f"{tuple(t.shape)}, strides {t.stride()}")


def mrf_in(y: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """The transposed convolution's (B, L, C) output ``y`` (no bias) -> the
    stage's f32 input ``y + bias``: ``mstts_mrf_in`` on a bf16 CUDA tensor,
    plain torch on a CPU one."""
    if not y.is_cuda:
        return y.float() + bias.float()
    _build.require_cuda(y, torch.bfloat16, "y")
    _channels_last(y)
    x0 = torch.empty(y.shape, dtype=torch.float32, device=y.device)
    if y.numel():
        IN_KERNEL.call("mstts_mrf_in", y.data_ptr(), _build.packed(_f32, bias).data_ptr(),
                       x0.data_ptr(), y.numel(), y.shape[-1], _build.stream_ptr(y))
    return x0


def activation(x: torch.Tensor, slope: float, dtype=torch.bfloat16) -> torch.Tensor:
    """``lrelu(x, slope)`` of an f32 (B, L, C)-contiguous ``x``, rounded
    once to ``dtype``: ``mstts_mrf_act`` on a CUDA tensor (bf16), plain torch
    on a CPU one."""
    if not x.is_cuda:
        return F.leaky_relu(x, slope).to(dtype)
    _build.require_cuda(x, torch.float32, "x")
    _channels_last(x)
    if dtype != torch.bfloat16:
        raise ValueError(f"the MRF kernels' activations are bf16, not {dtype}")
    a = torch.empty(x.shape, dtype=dtype, device=x.device)
    if x.numel():
        IN_KERNEL.call("mstts_mrf_act", x.data_ptr(), a.data_ptr(), x.numel(), float(slope),
                       _build.stream_ptr(x))
    return a


@torch.no_grad()
def mrf(blocks, x: torch.Tensor) -> torch.Tensor:
    """The mean over ``blocks`` (``ResBlock1``s: ``kernel_size``,
    ``dilations``, ``convs1``, ``convs2``) of each block run on the f32
    (B, L, C)-contiguous input ``x``, in the dtype of the blocks' weights.
    Its activation is written once for the blocks; the running sum is in
    f32 and in the plain MRF's order: ((b0 + b1) + b2) / 3."""
    a = activation(x, SLOPE, blocks[0].convs1[0].weight.dtype)
    h, a_step = torch.empty_like(a), torch.empty_like(a)
    x_step, out = torch.empty_like(x), torch.empty_like(x)
    n = len(blocks)
    for j, block in enumerate(blocks):
        last = len(block.dilations) - 1
        for m, d in enumerate(block.dilations):
            c1, c2 = block.convs1[m], block.convs2[m]
            a_in, x_in = (a, x) if m == 0 else (a_step, x_step)
            conv(a_in, c1.weight, c1.bias, d, act=h, slope=SLOPE)
            if m < last:
                conv(h, c2.weight, c2.bias, 1, xin=x_in, xout=x_step, act=a_step, slope=SLOPE)
            else:
                conv(h, c2.weight, c2.bias, 1, xin=x_in, acc=out if j else None, xout=out,
                     div=n if j == n - 1 else 1.0)
            if a.is_cuda:
                telemetry.count("vocode.mrf_kernel_steps", a.shape[0])
    return out
