"""The port's spans and counts of work, for a ``torch.profiler`` run to read.

- :func:`span` is a ``torch.profiler.record_function`` span while a
  profiler session records, and a shared no-op context otherwise: the
  profiler's trace holds each span's host interval and the device-side
  range of the kernels launched inside it.
- :func:`count` records ``(time.time_ns(), name, n)`` while a session
  records. The profiler stamps its host events in Unix-epoch nanoseconds,
  so a count's stamp lies on the trace's timeline, inside the span it was
  counted in. Counts do not ride on spans: a span's attributes come back
  only under ``record_shapes=True``.
- :func:`events` returns the counts of one name inside a time range, or
  None where the store dropped events that range may have held.

With no profiler recording each call costs one check of the profiler's flag.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.profiler import record_function

CAPACITY = 1 << 16  # events kept; older ones are dropped first

_recording = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler span named ``name`` while a session records, else a no-op."""
    return record_function(name) if _recording() else _NO_SPAN


class _Store:
    """A bounded in-memory log of counts, oldest dropped first."""

    def __init__(self, capacity: int):
        self.log = collections.deque(maxlen=capacity)
        self.dropped = 0
        self.lock = threading.Lock()

    def add(self, stamp: int, name: str, n: int) -> None:
        with self.lock:
            if len(self.log) == self.log.maxlen:
                self.dropped += 1
            self.log.append((stamp, name, n))

    def between(self, name: str, lo_ns: int, hi_ns: int) -> list | None:
        with self.lock:
            # Dropped events are older than every kept one: the range is
            # whole only if it starts after the oldest kept event.
            if self.dropped and (not self.log or self.log[0][0] >= lo_ns):
                return None
            return [(t, n) for t, k, n in self.log if k == name and lo_ns <= t <= hi_ns]


_store = _Store(CAPACITY)


def count(name: str, n: int) -> None:
    """Record ``n`` units of work named ``name`` now, while a session records."""
    if _recording():
        _store.add(time.time_ns(), name, int(n))


def events(name: str, lo_ns: int, hi_ns: int) -> list[tuple[int, int]] | None:
    """``[(stamp_ns, n)]`` of ``name`` stamped in [lo_ns, hi_ns], or None
    where events of that range may have been dropped."""
    return _store.between(name, lo_ns, hi_ns)
