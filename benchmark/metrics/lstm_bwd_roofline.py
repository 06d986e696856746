"""Share of the LSTM backward's device time (#8) that its bound needs over
the window's training steps (``rooflines/lstm_bwd.py``), in %."""

from benchmark.rooflines import lstm_bwd


def read(window):
    t = window.trace.kernel_s("lstm_bwd_kernel") if window.trace else 0.0
    w = window.work
    if t <= 0 or w.get("kind") != "train":
        return None
    return 100.0 * w["steps"] * lstm_bwd.stack_bound_s(w["dims"], w["T"], w["rows"]) / t
