"""Device-idle ms a batch while the host was in ``synth.decode``: the chunk
loop's launches, mask draws and stop checks (``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    return spans.synth_idle_ms(window, "decode")
