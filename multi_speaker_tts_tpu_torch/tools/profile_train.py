"""Profile the train step: device time by category, the top operations
with their source, and the decoder scan's host time (port of the top-level
``tools/profile_train.py``, on ``torch.profiler`` instead of xprof).

The workload is one teacher-forced ``Trainer.train_step`` at the shipped
defaults' production widths (GE2E 768x3 trainable, decoder LSTM 1024x2,
CBHG head, mixed precision) on a seeded batch at the training CLI's first
bucket (B 32, 50 tokens, 200 mel frames: ``chip_smoke.py`` pass (j)'s
shapes), from a fresh seeded init. After two warm-up steps it times
``-steps`` steps (CUDA events) and traces them, then prints:

- device ms a step by category (the hand-written kernels of ``csrc/``,
  GEMMs, convolutions, elementwise, reductions, copies, other), from the
  CUDA kernel and copy events, and the device's busy share of the step;
- the top ``-top`` host-side operations, by the device time of the kernels
  they launched, each at the port's two innermost frames that called it
  (one entry per operation and call site; the backward and the autograd
  Functions' own launches have none);
- the host time of the decoder scan (``ops/decoder_scan._TFScan``): its
  forward and its backward, each the wall time between entry and exit on
  the thread that ran it (the time to issue its work; the card runs behind
  it), beside the step's wall time;

then one JSON line. ``-device cpu`` (with ``-tiny``: ``tiny_test_hparams``
at B 4, 12 tokens, 20 frames) runs the same on the CPU, where the device
categories are not measured and only the host times are reported.

    python -m multi_speaker_tts_tpu_torch.tools.profile_train [-steps 3] [-top 20]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import numpy as np
import torch

from multi_speaker_tts_tpu_torch import telemetry

WARMUP = 2  # steps before the measured ones: library loads, packed weights, cuBLAS choices

# Kernel name substrings -> category; the first match wins.
CATEGORIES = (
    ("csrc kernels", ("mel_fft", "mel_dft", "lstm", "bigru", "gru_", "griffin", "decode_",
                      "attention_step")),
    ("convs", ("conv", "cudnn", "implicit", "fprop", "dgrad", "wgrad")),
    ("gemms", ("gemm", "cutlass", "xmma", "cublas", "matmul")),
    ("reductions", ("reduce", "norm")),
    ("elementwise", ("elementwise", "vectorized", "unrolled", "pointwise")),
    ("copies", ("memcpy", "memset", "copy", "cat")),
)


def category(name: str) -> str:
    low = name.lower()
    for cat, subs in CATEGORIES:
        if any(s in low for s in subs):
            return cat
    return "other"


def seeded_batch(hp, B: int, S: int, T: int, seed: int = 0) -> dict:
    """A collated batch of seeded random values at (B, S tokens, T frames)."""
    rng = np.random.default_rng(seed)
    M, F = hp.Sound.Mel_Dim, hp.Sound.Spectrogram_Dim
    L = hp.Speaker_Embedding.GE2E.Window_Length
    return {
        "tokens": rng.integers(2, 30, size=(B, S)).astype(np.int32),
        "token_lengths": np.full((B,), S, np.int32),
        "mels": rng.uniform(0, 1, size=(B, T, M)).astype(np.float32),
        "mel_lengths": np.full((B,), T, np.int32),
        "spects": rng.uniform(0, 1, size=(B, T, F)).astype(np.float32),
        "ref_mels": rng.uniform(0, 1, size=(B, L, M)).astype(np.float32),
        "speaker_ids": np.zeros((B,), np.int32),
    }


@contextlib.contextmanager
def scan_host_timer():
    """Time each forward and backward of the decoder scan's autograd
    Function on the host (and mark them as profiler spans); yields the
    {"forward": [ms...], "backward": [ms...]} lists."""
    from multi_speaker_tts_tpu_torch.ops import decoder_scan

    cls = decoder_scan._TFScan
    original = {"forward": cls.__dict__["forward"], "backward": cls.__dict__["backward"]}
    times = {"forward": [], "backward": []}

    def timed(kind):
        fn = original[kind].__func__

        def run(ctx, *args):
            with telemetry.span(f"decoder_scan.{kind}"):
                t0 = time.perf_counter()
                out = fn(ctx, *args)
                times[kind].append((time.perf_counter() - t0) * 1e3)
            return out

        return staticmethod(run)

    cls.forward, cls.backward = timed("forward"), timed("backward")
    try:
        yield times
    finally:
        cls.forward, cls.backward = original["forward"], original["backward"]


_PORT = "multi_speaker_tts_tpu_torch/"
_SITE = "site: "


class _CallSites(torch.overrides.TorchFunctionMode):
    """Runs each torch call made on this thread inside a profiler span
    named by the port's two innermost frames that led to it, so that an
    operation's kernels can be traced to their source: the profiler's own
    Python stacks (``with_stack``) are not recorded on every machine. The
    backward, which the autograd engine runs, passes through no span."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        frames, f = [], sys._getframe(1)
        while f is not None and len(frames) < 2:
            path = f.f_code.co_filename.replace("\\", "/")
            if _PORT in path:
                frames.append(f"{path.split(_PORT)[-1]}({f.f_lineno}): {f.f_code.co_name}")
            f = f.f_back
        with telemetry.span(_SITE + " <- ".join(frames)):
            return func(*args, **(kwargs or {}))


def _call_site(event) -> list[str]:
    """The port's frames of the :class:`_CallSites` span around an event."""
    q = event.cpu_parent
    while q is not None and not q.name.startswith(_SITE):
        q = q.cpu_parent
    return q.name[len(_SITE):].split(" <- ") if q is not None and len(q.name) > len(_SITE) else []


def profile(trainer, batch: dict, steps: int, top: int) -> dict:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    on_card = trainer.device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    step_ms, walls = [], []
    with scan_host_timer() as scan_ms:
        for _ in range(steps):  # unprofiled: CUDA events and the host wall
            sync()
            t0 = time.perf_counter()
            if on_card:
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                start.record()
            trainer.train_step(batch)
            if on_card:
                stop.record()
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
            if on_card:
                step_ms.append(start.elapsed_time(stop))
        scan_unprofiled = {k: list(v) for k, v in scan_ms.items()}
        with torch_profile(activities=acts) as prof, _CallSites():
            for _ in range(steps):
                trainer.train_step(batch)
            sync()
    per_cat, intervals, n_ops = {}, [], 0
    for e in prof.events():
        # A span's range on the card's timeline (record_function, such as
        # the scan's own) is no device work.
        if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False):
            ms = e.time_range.elapsed_us() / 1e3
            cat = category(e.name)
            per_cat[cat] = per_cat.get(cat, 0.0) + ms / steps
            intervals.append((e.time_range.start, e.time_range.end))
            n_ops += 1
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        busy_us += max(0.0, b - max(a, end))
        end = max(end, b)
    # The host-side operations that launched the device work, by the device
    # time of their own kernels, each at its call site in the port.
    by_op = {}
    for e in prof.events():
        dev_us = getattr(e, "self_device_time_total", 0.0)
        if (e.device_type != DeviceType.CPU or dev_us <= 0
                or getattr(e, "is_user_annotation", False) or e.name.startswith(_SITE)):
            continue
        key = (e.name, tuple(_call_site(e)) or ("(autograd: a backward or a Function)",))
        by_op[key] = by_op.get(key, 0.0) + dev_us / 1e3 / steps
    ops = sorted(((ms, name, list(src)) for (name, src), ms in by_op.items()),
                 key=lambda o: -o[0])
    n = len(scan_unprofiled["forward"])
    wall = float(np.mean(walls))
    fwd = float(np.mean(scan_unprofiled["forward"])) if n else None
    bwd = float(np.mean(scan_unprofiled["backward"])) if scan_unprofiled["backward"] else None
    return {
        "device": str(trainer.device),
        "steps": steps,
        "step_ms": float(np.mean(step_ms)) if step_ms else None,
        "step_wall_ms": wall,
        "device_busy_ms_per_step": busy_us / 1e3 / steps if on_card else None,
        "device_ops_per_step": n_ops / steps if on_card else None,
        "per_category_ms": ({k: round(v, 4) for k, v in sorted(per_cat.items(),
                                                               key=lambda kv: -kv[1])}
                            if on_card else None),
        "top_ops": [{"ms": round(ms, 4), "op": key[:80], "source": src}
                    for ms, key, src in ops[:top]],
        "scan_host_ms": {"forward": fwd, "backward": bwd,
                         "calls_per_step": {k: len(v) / steps
                                            for k, v in scan_unprofiled.items()},
                         "share_of_step_wall": ((fwd or 0.0) + (bwd or 0.0)) / wall},
    }


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-b", "--batch", type=int, default=None, help="rows (default 32)")
    parser.add_argument("-steps", type=int, default=3)
    parser.add_argument("-top", type=int, default=20)
    parser.add_argument("-tiny", action="store_true",
                        help="tiny_test_hparams at B 4, 12 tokens, 20 frames")
    parser.add_argument("-device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multi_speaker_tts_tpu_torch.hparams import default_hparams, tiny_test_hparams
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer
    from multi_speaker_tts_tpu_torch.weights import random_init

    if args.tiny:
        hp, (B, S, T) = tiny_test_hparams(), (4, 12, 20)
    else:
        hp = default_hparams()
        B, S, T = hp.Train.Batch_Size, hp.Train.Batch_Bucketing.Token_Buckets[0], \
            hp.Train.Batch_Bucketing.Mel_Buckets[0]
    B = args.batch or B
    hp = hp.replace(Train={"Batch_Size": B})
    trainer = Trainer(hp, device=args.device, seed=0)
    random_init(hp, torch.Generator().manual_seed(0), **trainer._modules())
    trainer.initialized = True
    batch = seeded_batch(hp, B, S, T)
    print(f"[profile_train] {trainer.device}: B {B}, S {S}, T {T}, r "
          f"{hp.Decoder.N_Frames_Per_Step}, mixed precision {hp.Train.Use_Mixed_Precision}; "
          f"{WARMUP} warm-up steps, {args.steps} measured")
    for _ in range(WARMUP):
        trainer.train_step(batch)
    result = profile(trainer, batch, args.steps, args.top)
    if result["per_category_ms"] is not None:
        busy = result["device_busy_ms_per_step"]
        print(f"\n== device ms a step by category ({args.steps} steps; busy {busy:.3f} ms of "
              f"{result['step_ms']:.3f} ms, {result['device_ops_per_step']:.0f} device ops) ==")
        for cat, ms in result["per_category_ms"].items():
            print(f"  {ms:9.3f}  {cat}")
    print(f"\n== top {args.top} operations by device time (ms a step) ==")
    for op in result["top_ops"]:
        print(f"  {op['ms']:9.3f}  {op['op']:<48s} {' <- '.join(op['source'])}")
    sh = result["scan_host_ms"]
    print(f"\n== host time of the decoder scan (ms a step; step wall "
          f"{result['step_wall_ms']:.2f} ms) ==\n  forward {sh['forward']:.2f}, backward "
          f"{sh['backward']:.2f}: {100 * sh['share_of_step_wall']:.1f}% of the step's wall time")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
