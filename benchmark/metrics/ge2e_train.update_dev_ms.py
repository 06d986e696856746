"""Device ms a training step of the kernels inside the device-side ranges of
the program's ``train.update`` span: the optimizer and the clamp of w
(``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    return spans.span_device_ms(window, "train.update")
