"""The GE2E forward's operations over the windows inside the clips' real
frames (the mel front end left out), over the window's time and the bf16
peak, in %."""

from benchmark.harness.peaks import BF16_FLOPS
from benchmark.rooflines import models


def read(window):
    w = window.work
    if w.get("kind") != "embed" or not w["calls"]:
        return None
    flops = sum(c["real_windows"] for c in w["calls"]) * models.ge2e_forward(w["dims"], w["T"])
    return 100.0 * flops / (window.window_s * BF16_FLOPS)
