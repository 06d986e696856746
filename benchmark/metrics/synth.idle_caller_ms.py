"""Device-idle ms a batch while the host was outside every ``synth.call``: the
caller's time between calls (``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    return spans.synth_idle_ms(window, "caller")
