"""Three times the GE2E forward's operations (forward, and the backward to
inputs and weights) over the rows and the T frames of each window step,
over the window's time and the bf16 peak, in %."""

from benchmark.harness.peaks import BF16_FLOPS
from benchmark.rooflines import models


def read(window):
    w = window.work
    if w.get("kind") != "train" or not w["steps"]:
        return None
    flops = 3 * w["steps"] * w["rows"] * models.ge2e_forward(w["dims"], w["T"])
    return 100.0 * flops / (window.window_s * BF16_FLOPS)
