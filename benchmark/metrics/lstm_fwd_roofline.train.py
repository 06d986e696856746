"""Share of the persistent LSTM forward's device time (#2r, residual mode)
that its bound needs over the window's training steps
(``rooflines/lstm_fwd.py``: every layer over the step's rows and frames), in %."""

from benchmark.rooflines import lstm_fwd


def read(window):
    t = window.trace.kernel_s("lstm_persistent_kernel") if window.trace else 0.0
    w = window.work
    if t <= 0 or w.get("kind") != "train":
        return None
    return 100.0 * w["steps"] * lstm_fwd.stack_bound_s(w["dims"], w["T"], w["rows"], True) / t
