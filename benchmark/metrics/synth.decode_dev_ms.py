"""Device time a batch of the kernels launched inside the program's
``synth.decode`` span (the early-exit decode), in ms: the union of device
intervals inside the span's device-side ranges, over the window's batches."""


def read(window):
    if window.trace is None or not window.records:
        return None
    s = window.trace.span_device_s("synth.decode")
    return None if s is None else s / len(window.records) * 1e3
