"""The model operations the window's batches needed at their own lengths,
with the HiFi-GAN generator as the vocoder (``rooflines/hifigan.py``
``step_flops``), over the window's time and the bf16 peak, in %."""

from benchmark.harness.peaks import BF16_FLOPS
from benchmark.reference import text
from benchmark.rooflines import hifigan


def read(window):
    if not window.records:
        return None
    hp = window.work["hp"]
    flops = sum(hifigan.step_flops(hp, b, [len(text.encode(t)) for t in r["texts"]])
                for b, r in zip(window.work["batches"], window.records))
    return 100.0 * flops / (window.window_s * BF16_FLOPS)
