"""The benchmark of ``multi_speaker_tts_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload synth.b32-short --seed 7 --seconds 30 --trace 0

Runs from the root of a checkout, on the machine that holds the card(s)
the cell asks for. Prints the set-up, the measured window's metrics (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer metrics from
a ``torch.profiler`` trace of the window), and the check of what the window
produced against the plain reference: each number compared beside its
limit, as the last lines on standard error and under ``compared`` as the
last key of the result, which is the last line on standard output.

Exits with another code than 0, printing no result, where the checkout
lacks the port, where CUDA or the cell's cards are missing, and where a
module of JAX, flax or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = "multi_speaker_tts_tpu_torch"


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    if not (ROOT / PORT / "__init__.py").is_file():
        print(f"error: no {PORT} package beside the benchmark in {ROOT}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from benchmark.harness.cell import Cell, Context, isolate_caches

    isolate_caches()
    import torch

    from benchmark.harness import runner

    cell = Cell.by_name(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell asks for {chips} CUDA device(s); "
              f"cuda available: {torch.cuda.is_available()}", file=sys.stderr)
        return 3
    torch.set_num_threads(1)  # one process, one host thread: the steadiest load
    ctx = Context(cell, args.seed, args.seconds, bool(args.trace))
    out = runner.execute(ctx, T0)
    runner.forbidden_or_exit()
    result = out["result"]
    result["device"]["power_limit"] = power_limit()
    print(f"card: {result['device']['power_limit']}", file=sys.stderr)
    runner.report_compared(out["compared"])
    sys.stderr.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
