"""Probe: the fused attention-step kernel against the plain attention step.

The port of the JAX package's ``tools/attention_probe.py``. It times one
step of location-sensitive attention (query projection, location conv,
energies, softmax, cumulative weights and the context contraction) two
ways, each in a loop of ``iters`` steps where every step's context feeds
the next step's query (``h = h0 + pad(ctx)``), so no step can be hoisted:

1. plain: :func:`..ops.decoder_scan.attention_block` and the context
   ``bmm``, as the teacher-forced scan runs them (many small launches a
   step);
2. kernel: :func:`..ops.attention_step_kernel.attention_step`, one launch
   of ``csrc/attention_step.cu`` a step (on the CPU its plain version).

Run on the card::

    python -m multi_speaker_tts_tpu_torch.tools.attention_probe [-B 96] [-S 100] \
        [-A 128] [-D 512] [-H 1024] [-iters 200] [-device cuda]

``-device cpu`` runs both loops on the CPU, where the kernel loop runs the
plain version. On the card the probe also prints the kernel's launch plan
(batch rows a cluster, memory chunks) and times one kernel step alone
(:func:`step_card_us`). The inputs
are drawn from ``np.random.default_rng(0)`` in the JAX probe's order
(:func:`probe_inputs`), so both probes see the same arrays.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from multi_speaker_tts_tpu_torch.inference import resolve_device
from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask
from multi_speaker_tts_tpu_torch.ops import decoder_scan
from multi_speaker_tts_tpu_torch.ops.decoder_scan import AttentionParams

CONV_TAPS, CONV_CHANNELS = 31, 32  # the location conv of every shipped decoder


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("-B", type=int, default=96)
    p.add_argument("-S", type=int, default=100)
    p.add_argument("-A", type=int, default=128)
    p.add_argument("-D", type=int, default=512)
    p.add_argument("-H", type=int, default=1024)
    p.add_argument("-iters", type=int, default=200)
    p.add_argument("-device", default=None,
                   help="cuda (the default; raises without a card) or cpu")
    return p


def probe_inputs(args, seed: int, device):
    """(ap, keys, memory, mask, h0, w0, cum0) on ``device``: normal x 0.1 f32
    from ``np.random.default_rng(seed)`` in the JAX probe's order (wq, conv
    kernel, wloc, v, keys, memory, h0), all-ones mask, start weights one-hot
    at position 0."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.1).astype(np.float32)).to(device)

    ap = AttentionParams(wq=f(args.H, args.A), conv_kernel=f(CONV_TAPS, 2, CONV_CHANNELS),
                         wloc=f(CONV_CHANNELS, args.A), v=f(args.A, 1))
    keys = f(args.B, args.S, args.A)
    memory = f(args.B, args.S, args.D)
    mask = torch.ones((args.B, args.S), dtype=torch.float32, device=device)
    h0 = f(args.B, args.H)
    w0 = torch.zeros((args.B, args.S), dtype=torch.float32, device=device)
    w0[:, 0] = 1.0
    return ap, keys, memory, mask, h0, w0, w0.clone()


def make_plain_loop(ap: AttentionParams, keys, memory, mask, n_iters: int):
    """The attention block + context contraction as the teacher-forced scan
    runs them, ``n_iters`` dependent steps -> run(h0, w0, cum0) -> (w, cum, ctx)."""

    def run(h0, w0, cum0):
        w, cum = w0, cum0
        ctx = torch.zeros((h0.shape[0], memory.shape[2]), dtype=torch.float32,
                          device=h0.device)
        for _ in range(n_iters):
            # h0 depends on ctx in the real scan; folding ctx back in keeps a
            # true data dependence from step to step.
            h = h0 + F.pad(ctx, (0, h0.shape[1] - ctx.shape[1]))
            w, cum = decoder_scan.attention_block(h, w, cum, keys, ap, mask)
            ctx = torch.bmm(w[:, None, :], memory.float())[:, 0]
        return w, cum, ctx

    return run


def make_kernel_loop(ap: AttentionParams, keys, memory, mask, n_iters: int):
    """The same loop through the fused step, one kernel launch a step."""
    K = ap.conv_kernel.shape[0]
    half = (K - 1) // 2
    maskadd = ask.maskadd_of(mask)

    def run(h0, w0, cum0):
        w, cum = w0, cum0
        ctx = torch.zeros((h0.shape[0], memory.shape[2]), dtype=torch.float32,
                          device=h0.device)
        for _ in range(n_iters):
            h = h0 + F.pad(ctx, (0, h0.shape[1] - ctx.shape[1]))
            wp = F.pad(w, (half, K - 1 - half))
            cp = F.pad(cum, (half, K - 1 - half))
            w, cum, ctx = ask.attention_step(h, wp, cp, keys, memory, maskadd, ap)
        return w, cum, ctx

    return run


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_loop(fn, h0, w0, cum0) -> float:
    """Seconds for one call of ``fn``: the two-point slope (5 calls less 1
    call, over 4), median of three, after a warm-up call. On the card the
    interval is read from CUDA events; on the CPU from the host clock."""
    device = h0.device
    fn(h0, w0, cum0)
    _sync(device)

    def run(n):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                fn(h0, w0, cum0)
            stop.record()
            stop.synchronize()
            return start.elapsed_time(stop) / 1e3
        t0 = time.perf_counter()
        for _ in range(n):
            fn(h0, w0, cum0)
        return time.perf_counter() - t0

    pers = []
    for _ in range(3):
        a, b = run(1), run(5)
        pers.append((b - a) / 4)
    return sorted(pers)[1]


def step_card_us(fn, reps: int = 20) -> float:
    """Microseconds of card time a call of ``fn``: the card is first held
    in a spin of about 10 ms, so the host queues every call before the card
    reaches the first, and the CUDA events time the card's work alone (a
    step is shorter than its host-side dispatch)."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)  # clock cycles
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) * 1e3 / reps


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        name = torch.cuda.get_device_name(device)
    else:
        name = "cpu (the kernel loop runs the plain version)"
    print(f"device: {name}")
    ap, keys, memory, mask, h0, w0, cum0 = probe_inputs(args, 0, device)

    plain = make_plain_loop(ap, keys, memory, mask, args.iters)
    t_plain = time_loop(plain, h0, w0, cum0)
    print(f"plain : {t_plain * 1e3:8.3f} ms / {args.iters} steps "
          f"({t_plain / args.iters * 1e6:6.2f} us/step)")

    kernel = make_kernel_loop(ap, keys, memory, mask, args.iters)
    t_kernel = time_loop(kernel, h0, w0, cum0)
    print(f"kernel: {t_kernel * 1e3:8.3f} ms / {args.iters} steps "
          f"({t_kernel / args.iters * 1e6:6.2f} us/step)")

    for a, b, label in zip(plain(h0, w0, cum0), kernel(h0, w0, cum0), ("w", "cum", "ctx")):
        print(f"max|plain - kernel| {label}: {float((a - b).abs().max()):.2e}")

    print(f"verdict: kernel/plain = {t_kernel / t_plain:.3f}x")

    if device.type == "cuda":  # the first step's inputs
        K, _, C = ap.conv_kernel.shape
        borders = ((K - 1) // 2, K - 1 - (K - 1) // 2)
        step = (h0, F.pad(w0, borders), F.pad(cum0, borders), keys, memory,
                ask.maskadd_of(mask), ap)
        plan = ask.kernel_plan(args.B, args.S, args.A, args.D, K, C,
                               ask.max_clusters(device))
        us = step_card_us(lambda: ask.attention_step_kernel(*step))
        print(f"kernel plan {plan} (the card holds {ask.max_clusters(device)} clusters)")
        print(f"kernel step alone: {us:6.2f} us of card time")


if __name__ == "__main__":
    main()
