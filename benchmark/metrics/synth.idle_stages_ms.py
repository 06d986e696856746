"""Device-idle ms a batch while the host was in ``synth.call`` but in none of
``synth.prepare``, ``synth.decode`` and ``synth.return``: the encoder, postnet,
linear head and vocoder stages and the lines between them (``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    return spans.synth_idle_ms(window, "stages")
