"""Reading the program's own spans and counts of work in a traced window.

Idle time by what the host was doing. The device is idle wherever no
kernel or copy runs (the window less the union of device intervals, as
``trace.idle_share`` takes it). Its idle time inside a set of host
intervals is their length less their overlap with the device's busy
intervals: exact interval arithmetic, no sampling. A synthesis window's
idle time splits with no gap and no overlap into the host's time in
``synth.prepare``, in ``synth.decode``, in ``synth.return``, in the rest of
``synth.call`` (the stages between them), and outside every ``synth.call``
(the caller's time: the window's idle time less that inside the calls).

Counts of work are the program's ``multi_speaker_tts_tpu_torch.telemetry``
events stamped inside the trace's host extent: the profiler stamps its host
events in Unix-epoch nanoseconds, as the program stamps its counts.

Where the program has no such span or store (an older checkout), or the
trace no device events (a CPU run), a reader finds nothing and returns None.
"""

from __future__ import annotations

SYNTH_PARTS = ("prepare", "decode", "return")  # the spans ``synth.<part>`` inside ``synth.call``


def union(intervals) -> list[tuple[int, int]]:
    """Sorted, disjoint intervals covering the same points as ``intervals``."""
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def subtract(xs, ys) -> list[tuple[int, int]]:
    """The points of the disjoint sorted intervals ``xs`` outside the disjoint
    sorted intervals ``ys``."""
    out, j = [], 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k, cur = j, a
        while k < len(ys) and ys[k][0] < b:
            if ys[k][0] > cur:
                out.append((cur, ys[k][0]))
            cur = max(cur, ys[k][1])
            k += 1
        if cur < b:
            out.append((cur, b))
    return out


def length(xs) -> int:
    return sum(b - a for a, b in xs)


def overlap(xs, ys) -> int:
    """The length of the intersection of two disjoint sorted interval lists."""
    total, i, j = 0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def host_spans(trace, name: str) -> list[tuple[int, int]]:
    """The union of the host intervals of the program's span ``name``."""
    return union((a, b) for a, b, n, _ in trace.host if n == name)


def synth_idle_ns(window) -> dict | None:
    """{part: device-idle ns while the host was there} for the parts of
    :data:`SYNTH_PARTS`, ``stages`` and ``caller``; they add up to the
    window's idle time. Computed once a window."""
    if "synth_idle_ns" not in window.__dict__:
        window.synth_idle_ns = _synth_idle_ns(window.trace, window.window_s)
    return window.synth_idle_ns


def _synth_idle_ns(trace, window_s: float) -> dict | None:
    if trace is None or not trace.device:
        return None
    calls = host_spans(trace, "synth.call")
    if not calls:
        return None
    busy = trace.busy_intervals()

    def idle(xs):
        return length(xs) - overlap(xs, busy)

    parts = {p: host_spans(trace, f"synth.{p}") for p in SYNTH_PARTS}
    out = {p: idle(xs) for p, xs in parts.items()}
    out["stages"] = idle(subtract(calls, union(x for xs in parts.values() for x in xs)))
    out["caller"] = round(window_s * 1e9) - length(busy) - idle(calls)
    return out


def synth_idle_ms(window, part: str) -> float | None:
    """Device-idle ms a batch while the host was in ``part``."""
    split = synth_idle_ns(window)
    if split is None or not window.records:
        return None
    return split[part] / len(window.records) / 1e6


def counted(window, name: str) -> int | None:
    """The program's count ``name`` over the window (None where the program
    keeps no counts, counted none, or dropped some of the window's)."""
    try:
        from multi_speaker_tts_tpu_torch import telemetry
    except ImportError:
        return None
    trace = window.trace
    if trace is None or not trace.host:
        return None
    events = telemetry.events(name, trace.host[0][0], max(b for _, b, _, _ in trace.host))
    return sum(n for _, n in events) if events else None


def ratio(window, name: str, needed: int) -> float | None:
    """The program's count ``name`` over the work the window's inputs
    needed (``needed``)."""
    done = counted(window, name)
    return None if done is None or needed <= 0 else done / needed


def span_device_ms(window, span: str) -> float | None:
    """Device ms a record of the kernels inside ``span``'s device-side ranges."""
    if window.trace is None or not window.records:
        return None
    s = window.trace.span_device_s(span)
    return None if s is None else s / len(window.records) * 1e3
