"""GE2E train-step roofline: budget table and (N, M, T) shape sweep (port of
the top-level ``tools/ge2e_roofline.py``).

Measures the port's GE2E train step (``train/ge2e_trainer.GE2ETrainer``:
the 3 x 768 LSTM stack on ``csrc/lstm.cu`` forward and ``csrc/lstm_bwd.cu``
backward, the projection, the GE2E loss, the SGD update) at the shipped
defaults' widths across a batch-shape grid, derives the analytic wavefront
budget (the JAX tool's arithmetic), and can profile the base shape with the
port's ``tools/profile_train`` summariser.

    python -m multi_speaker_tts_tpu_torch.tools.ge2e_roofline            # base shape
    python -m multi_speaker_tts_tpu_torch.tools.ge2e_roofline -sweep     # (N, M, T) grid
    python -m multi_speaker_tts_tpu_torch.tools.ge2e_roofline -trace DIR # profile the base shape

A step's time is the JAX tool's: the median of five differential timings
(2 and 12 steps, the card synchronized around each). MFU is the analytic
budget's FLOPs (``analytic_budget``; ``torch.utils.flop_counter`` does not
see the hand-written kernels, and XLA's cost analysis has no counterpart)
over the H100's dense bf16 peak, 989 TFLOP/s. Each shape prints one JSON
line with the card's name and power limit; ``-device cpu`` runs the plain
recurrences.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.tools import _timing

PEAK_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)
SWEEP = [
    (16, 10, 160),  # paper / bench base
    (8, 10, 160),   # fewer speakers
    (32, 10, 160),  # more speakers (rows 320)
    (64, 10, 160),  # rows 640
    (16, 5, 160),   # fewer utterances
    (16, 20, 160),  # rows 320 via M
    (16, 10, 80),   # shorter crops
    (16, 10, 240),  # longer crops
]


def _trainer(N: int, M: int, T: int, device, work: str):
    from multi_speaker_tts_tpu_torch.hparams import default_hparams
    from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer

    hp = default_hparams().replace(GE2E_Train={"Batch_Speakers": N, "Batch_Utterances": M,
                                               "Frame_Length": T})
    trainer = GE2ETrainer(hp, checkpoint_dir=str(pathlib.Path(work) / "ckpt"),
                          log_dir=str(pathlib.Path(work) / "logs"), device=device, seed=0)
    rng = np.random.default_rng(0)
    mels = torch.from_numpy(rng.uniform(0, 1, size=(N * M, T, hp.Sound.Mel_Dim))
                            .astype(np.float32)).to(trainer.device)
    return trainer, mels


def measure(N: int, M: int, T: int, device=None, trace_dir: str | None = None) -> dict:
    with tempfile.TemporaryDirectory() as work:
        trainer, mels = _trainer(N, M, T, device, work)
        dev = trainer.device
        trainer.train_step(mels)  # warm: the kernels' build, the allocator's pool

        def run(n):
            return _timing.wall_s(lambda: trainer.train_step(mels), n, dev)

        # Median of 5 differential timings (the JAX tool's rule).
        pers = sorted((run(12) - run(2)) / 10 for _ in range(5))
        per = max(pers[2], 1e-9)
        if trace_dir:
            profile_steps(trainer, mels, trace_dir)
    flops = analytic_budget(N, M, T)["model_tflop_per_step"] * 1e12
    out = {
        "N": N, "M": M, "T": T, "rows": N * M,
        "ms_per_step": round(per * 1e3, 3),
        "frames_per_sec": round(N * M * T / per, 1),
        "step_tflops": round(flops / 1e12, 3),
        # A device metric: on the CPU it is not measured.
        "mfu": round(flops / per / PEAK_FLOPS, 4) if dev.type == "cuda" else None,
        "flops_source": "analytic_budget",
        "device": str(dev),
        "card": _timing.card(dev),
    }
    return out


def profile_steps(trainer, mels, trace_dir: str, steps: int = 4, top: int = 25) -> dict:
    """Four steps under ``torch.profiler`` through ``tools/profile_train``'s
    summariser: device ms a step by category and the top operations,
    printed and written to ``trace_dir/summary.json``."""
    from multi_speaker_tts_tpu_torch.tools import profile_train

    print(f"[ge2e_roofline] profiling {steps} steps -> {trace_dir}")
    result = profile_train.profile(trainer, mels, steps, top)
    result.pop("scan_host_ms")  # the TTS decoder scan's; the GE2E step has none
    path = pathlib.Path(trace_dir)
    path.mkdir(parents=True, exist_ok=True)
    (path / "summary.json").write_text(json.dumps(result, indent=1))
    if result["per_category_ms"] is not None:
        print(f"== device ms a step by category (busy {result['device_busy_ms_per_step']:.3f} "
              f"ms of {result['step_ms']:.3f} ms) ==")
        for cat, ms in result["per_category_ms"].items():
            print(f"  {ms:9.3f}  {cat}")
    print(f"== top {top} operations by device time (ms a step) ==")
    for op in result["top_ops"]:
        print(f"  {op['ms']:9.3f}  {op['op']:<48s} {' <- '.join(op['source'])}")
    return result


def analytic_budget(N: int, M: int, T: int) -> dict:
    """Wavefront FLOP / sequential-depth model for the production GE2E
    (3 x 768 LSTM + 256 projection, mel 80): what bounds the step at this
    shape (the JAX tool's arithmetic)."""
    B = N * M
    L, H, mel, E = 3, 768, 80, 256
    steps = T + L - 1
    flop_l0 = 2 * B * (mel + H) * 4 * H
    flop_l12 = 2 * 2 * B * (2 * H) * 4 * H
    fwd = steps * (flop_l0 + flop_l12) / (L / L)  # per wavefront step all L run
    bwd_scan = 2 * fwd  # transposed gate GEMMs + cell vjps ~ 2x fwd GEMM cost
    dW = 2 * fwd  # post-loop contraction reads the same residual volume
    proj = 2 * B * H * E * 3  # fwd + bwd dx + dW
    total = fwd + bwd_scan + dW + proj
    per_step_rows = B
    return {
        "model_tflop_per_step": round(total / 1e12, 3),
        "sequential_steps": 2 * steps,
        "rows_per_wavefront_gemm": per_step_rows,
        "note": (
            "per-wavefront-step GEMM is (3, B, ~1.5k)x(3, ~1.5k, 3k); at "
            f"B={B} rows the MXU tile is underfed below B=128 and the "
            "sequential depth (2*(T+L-1) dependent steps) sets the floor"
        ),
    }


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-sweep", action="store_true")
    ap.add_argument("-trace", default=None, help="profile directory for the base shape")
    ap.add_argument("-N", type=int, default=16)
    ap.add_argument("-M", type=int, default=10)
    ap.add_argument("-T", type=int, default=160)
    ap.add_argument("-device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    shapes = SWEEP if args.sweep else [(args.N, args.M, args.T)]
    results = []
    for (N, M, T) in shapes:
        t0 = time.perf_counter()
        r = measure(N, M, T, args.device, trace_dir=args.trace if not args.sweep else None)
        r["seconds"] = round(time.perf_counter() - t0, 1)
        results.append(r)
        print(json.dumps(r), flush=True)

    base = analytic_budget(args.N, args.M, args.T)
    print("analytic:", json.dumps(base))
    if args.sweep:
        print("\n| N | M | T | rows | ms/step | frames/s | MFU |")
        print("|---|---|---|---|---|---|---|")
        for r in results:
            print(f"| {r['N']} | {r['M']} | {r['T']} | {r['rows']} | "
                  f"{r['ms_per_step']} | {r['frames_per_sec']:,.0f} | {r.get('mfu', '-')} |")
    return results


if __name__ == "__main__":
    main()
