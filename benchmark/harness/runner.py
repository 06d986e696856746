"""Set-up, the measured window, the per-layer readings and the check of one
run, for ``run.py``, ``control.py`` and the harness's tests.

A driver (``drivers/<name>.py``) provides:

- ``setup(ctx) -> state``: the program, its inputs from the seed, and a
  warm-up of every shape the cell's traffic uses;
- ``step(state, i) -> record``: one timed call of the entry point, done
  when its answer is on the host; ``record["requests"]`` counts the
  requests it answered;
- ``end_to_end(state, records, window_s) -> {metric: value}``;
- ``work(state, records) -> dict``: what the per-layer readers count;
- ``check(state, records, ctx) -> [Compared]``: after the window, the
  program's state released, the plain reference against what the window
  produced.
"""

from __future__ import annotations

import sys
import time
import traceback

from benchmark.harness.cell import Compared, Context, forbidden_loaded, judge
from benchmark.harness.trace import Trace


class Window:
    """What a per-layer reader (``metrics/<name>.py``, ``read(window)``)
    sees: the trace, the driver's records and its ``work``."""

    def __init__(self, trace: Trace, records: list, work: dict, window_s: float):
        self.trace, self.records, self.work, self.window_s = trace, records, work, window_s


def _sync(device: str) -> None:
    import torch

    if device.startswith("cuda"):
        torch.cuda.synchronize()


def execute(ctx: Context, t0: float) -> dict:
    """One run: -> {"result": the result line's dict, "compared": [...]}."""
    import torch

    driver = ctx.cell.driver()
    prof = None
    if ctx.trace:
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if ctx.device.startswith("cuda"):
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities):  # the profiler's own start-up cost
            pass
        prof = profile(activities=activities)
    state = driver.setup(ctx)
    _sync(ctx.device)
    setup_s = time.perf_counter() - t0

    records, failed = [], 0
    if prof is not None:
        prof.start()
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < ctx.seconds:
        try:
            records.append(driver.step(state, i))
        except Exception:  # a failed request is counted, and the run goes on
            traceback.print_exc()
            failed += 1
        i += 1
    window_s = time.perf_counter() - start
    if prof is not None:
        prof.stop()
    attempted = sum(r["requests"] for r in records) + failed

    device = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    if ctx.device.startswith("cuda"):
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": int(ctx.cell.entry["chips"]),
                  "memory_peak_bytes": max(torch.cuda.max_memory_allocated(d)
                                           for d in range(int(ctx.cell.entry["chips"])))}
    metrics = {}
    if not ctx.trace:
        values = driver.end_to_end(state, records, window_s)
        values["setup_s"] = setup_s
        for m in ctx.cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    breakdown = None
    if ctx.trace:
        trace = Trace.from_profiler(prof, window_s)
        del prof
        print(trace.summary(), file=sys.stderr)
        view = Window(trace, records, driver.work(state, records), window_s)
        for m in ctx.cell.per_layer:
            value = ctx.cell.reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device["busy_s"] = trace.busy_s
        device["window_s"] = window_s
        breakdown = {"device_ops": trace.top_device_ops(), "idle_gaps": trace.idle_gaps()}
        del trace, view

    compared: list[Compared] = driver.check(state, records, ctx) if records else []
    # The control's and the planted faults' readings (``name.tag``, read by
    # control.py only) are not the program's.
    correct = judge([c for c in compared if "." not in c.name]) and failed == 0
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in compared}
    return {"result": result, "compared": compared}


def report_compared(compared: list[Compared], out=sys.stderr) -> None:
    for c in compared:
        print(f"compared {c.name}: {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAIL'}", file=out)


def forbidden_or_exit() -> None:
    found = forbidden_loaded()
    if found:
        print(f"error: modules of {', '.join(found)} were loaded in this process", file=sys.stderr)
        sys.exit(4)
