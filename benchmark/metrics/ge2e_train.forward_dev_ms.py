"""Device ms a training step of the kernels inside the device-side ranges of
the program's ``train.forward`` span: the embeddings and the loss
(``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    return spans.span_device_ms(window, "train.forward")
