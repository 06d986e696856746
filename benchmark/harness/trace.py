"""Reading a ``torch.profiler`` trace of the measured window.

The profiler's raw events (``kineto_results.events()``) are read once into
plain tuples: the device's kernels and copies, the device-side ranges of
the program's ``record_function`` spans (kineto's ``gpu_user_annotation``
events), and the host's spans and operations. Busy time is the union of
the device intervals, as ``tools/profile_train.py`` takes it; a span's
device time is that union inside the span's device-side ranges.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float
    device: list = field(default_factory=list)  # (start_ns, end_ns, name) kernels and copies
    gpu_spans: dict = field(default_factory=dict)  # span name -> [(start_ns, end_ns)]
    host: list = field(default_factory=list)  # (start_ns, end_ns, name, is_annotation)

    @classmethod
    def from_profiler(cls, prof, window_s: float) -> "Trace":
        from torch.autograd import DeviceType

        tr = cls(window_s)
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1e3)
            dur = e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1e3)
            name = e.name()
            annotation = bool(e.is_user_annotation()) if hasattr(e, "is_user_annotation") else False
            if hasattr(e, "activity_type"):
                annotation = annotation or "annotation" in str(e.activity_type()).lower()
            if e.device_type() == DeviceType.CUDA:
                if annotation:
                    tr.gpu_spans.setdefault(name, []).append((start, start + dur))
                elif dur > 0:
                    tr.device.append((start, start + dur, name))
            else:
                tr.host.append((start, start + dur, name, annotation))
        tr.device.sort()
        tr.host.sort()
        return tr

    def summary(self) -> str:
        return (f"trace: {len(self.device)} device events, {len(self.host)} host events, "
                f"device spans {sorted((k, len(v)) for k, v in self.gpu_spans.items())[:12]}")

    # -- device time -----------------------------------------------------------
    def busy_intervals(self) -> list[tuple[int, int]]:
        """The union of device intervals, sorted and disjoint."""
        out: list[list[int]] = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernels(self, *substrings: str) -> list[tuple[int, int, str]]:
        """Device events whose name holds any of ``substrings``."""
        return [k for k in self.device if any(s in k[2] for s in substrings)]

    def kernel_s(self, *substrings: str) -> float:
        return sum(b - a for a, b, _ in self.kernels(*substrings)) / 1e9

    def span_device_s(self, span: str) -> float | None:
        """Device busy seconds inside the device-side ranges of ``span``
        (None where the trace has no such range)."""
        ranges = sorted(self.gpu_spans.get(span, []))
        if not ranges:
            return None
        busy = self.busy_intervals()
        starts = [a for a, _ in busy]
        total = 0
        for lo, hi in ranges:
            i = max(bisect.bisect_right(starts, lo) - 1, 0)
            while i < len(busy) and busy[i][0] < hi:
                total += max(0, min(hi, busy[i][1]) - max(lo, busy[i][0]))
                i += 1
        return total / 1e9

    # -- breakdown ---------------------------------------------------------------
    def top_device_ops(self, n: int = 10) -> list[list]:
        by_name: dict[str, int] = {}
        for a, b, name in self.device:
            by_name[name] = by_name.get(name, 0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The ``n`` longest gaps between device intervals, each named by
        the innermost host span (else host operation) open at its middle."""
        busy = self.busy_intervals()
        gaps = sorted(((b0, a1) for (_, b0), (a1, _) in zip(busy, busy[1:]) if a1 > b0),
                      key=lambda g: g[0] - g[1])[:n]
        host_starts = [h[0] for h in self.host]
        out = []
        for lo, hi in gaps:
            mid = (lo + hi) // 2
            label, best = "host: no span", None
            i = bisect.bisect_right(host_starts, mid)
            # The host list is sorted by start: walk back over events that
            # began before ``mid`` and keep the latest-starting one that
            # still covers it, preferring a program span.
            for j in range(i - 1, max(i - 20000, -1), -1):
                a, b, name, annotation = self.host[j]
                if b >= mid:
                    rank = (annotation, a)
                    if best is None or rank > best:
                        best, label = rank, name
            out.append([label[:160], (hi - lo) / 1e9])
        return out


def idle_share(window):
    """A per-layer reader: the share of the traced window in which no
    operation ran on the device (the union of kernel and copy intervals),
    in %."""
    if window.trace is None:
        return None
    return 100.0 * (1.0 - window.trace.busy_s / window.window_s)
