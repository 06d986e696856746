"""Device-idle ms a batch while the host was in ``synth.return``: the copies to
the host, the joins, the per-row results (``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    return spans.synth_idle_ms(window, "return")
