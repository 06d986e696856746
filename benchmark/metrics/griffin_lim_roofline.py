"""Share of the staged Griffin-Lim kernel's device time that its bound
needs (``rooflines/griffin_lim_staged.py``: each row's decoded frames), in %."""

from benchmark.rooflines import griffin_lim_staged


def read(window):
    t = window.trace.kernel_s("gl_staged_kernel") if window.trace else 0.0
    if t <= 0:
        return None
    hp = window.work["hp"]
    return 100.0 * sum(griffin_lim_staged.batch_bound_s(hp, b)
                       for b in window.work["batches"]) / t
