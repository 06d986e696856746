"""Share of the device time inside the program's ``synth.vocode`` span (the
HiFi-GAN generator's convolutions and activations, the 16-bit rounding and
the copy of the waveform to the host) that the generator's bound needs
(``rooflines/hifigan.py``: each row's decoded frames), in %."""

from benchmark.rooflines import hifigan


def read(window):
    t = window.trace.span_device_s("synth.vocode") if window.trace else None
    if not t or not window.records:
        return None
    hp = window.work["hp"]
    return 100.0 * sum(hifigan.batch_bound_s(hp, b) for b in window.work["batches"]) / t
