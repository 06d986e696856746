"""Device time a batch of the kernels launched inside the program's
``synth.vocode`` span (Griffin-Lim, inverse pre-emphasis, PCM), in ms."""


def read(window):
    if window.trace is None or not window.records:
        return None
    s = window.trace.span_device_s("synth.vocode")
    return None if s is None else s / len(window.records) * 1e3
