"""Device-idle ms a batch while the host was in ``synth.prepare``: tokens,
buckets, host-to-device copies, the prenet mask sampler (``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    return spans.synth_idle_ms(window, "prepare")
