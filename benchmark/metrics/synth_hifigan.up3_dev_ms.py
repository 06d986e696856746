"""Device time a batch of the kernels launched inside the program's
``vocode.up3`` span: the HiFi-GAN generator's last stage (the transposed
convolution to 32 channels at the sample rate and its MRF), the stage
bound by bandwidth, in ms."""

from benchmark.harness import spans


def read(window):
    return spans.span_device_ms(window, "vocode.up3")
