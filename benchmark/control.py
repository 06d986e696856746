"""Readings for the limits of a cell's compared numbers: the program's
numbers on a list of seeds and, on the same served outputs, the control's:
the plain reference computed one precision below the configuration's (fp8
operands for its bf16), put in the program's place, and for a training cell
also the planted fault of half the batch left out. ``--quantize`` runs the
program on its own lower-precision decode (``int8_pallas``), the synthesis
cell's control; ``--fault <name>`` plants a fault of ``faults.py`` under
the timed path. A synthesis cell's check also prints each compared row's
gaps on standard error. One process, so that the kernels build once:

    python3 benchmark/control.py --workload synth.b32-short --seeds 11,12,13 --seconds 5

Prints one JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--seconds", type=float, default=5.0)
    parser.add_argument("--quantize", default=None)
    parser.add_argument("--fault", default=None, help="a function of faults.py")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import faults
    from benchmark.harness.cell import Cell, Context, isolate_caches

    isolate_caches()
    import torch

    from benchmark.harness import runner

    if not torch.cuda.is_available():
        print("error: no CUDA device", file=sys.stderr)
        return 3
    torch.set_num_threads(1)
    cell = Cell.by_name(args.workload)
    overrides = {"report_rows": True, **({"quantize": args.quantize} if args.quantize else {})}
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = Context(cell, seed, args.seconds, False, overrides=overrides,
                      control=args.quantize is None and args.fault is None)
        t0 = time.perf_counter()
        patch, undo = faults.patcher()
        if args.fault:
            getattr(faults, args.fault)(patch)
        try:
            out = runner.execute(ctx, t0)
        finally:
            undo()
        print(json.dumps({"seed": seed, "quantize": args.quantize, "fault": args.fault,
                          "correct": out["result"]["correct"],
                          "attempted": out["result"]["attempted"],
                          "metrics": {k: v["value"] for k, v in out["result"]["metrics"].items()},
                          "compared": {c.name: c.value for c in out["compared"]},
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
