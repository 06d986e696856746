"""Share of the persistent LSTM forward's device time (#2) that its bound
needs over the window's embedding calls: every layer over the windows that
lie inside the clips' real frames (``rooflines/lstm_fwd.py``), in %."""

from benchmark.rooflines import lstm_fwd


def read(window):
    t = window.trace.kernel_s("lstm_persistent_kernel") if window.trace else 0.0
    w = window.work
    if t <= 0 or w.get("kind") != "embed":
        return None
    return 100.0 * sum(lstm_fwd.stack_bound_s(w["dims"], w["T"], c["real_windows"], False)
                       for c in w["calls"]) / t
