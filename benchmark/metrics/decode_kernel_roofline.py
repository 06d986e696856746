"""Share of the decode kernel's device time that its bound needs
(``rooflines/decode.py``: the window's batches, chunk by chunk, the rows
still decoding), in %."""

from benchmark.rooflines import decode


def read(window):
    t = window.trace.kernel_s("decode_kernel") if window.trace else 0.0
    if t <= 0:
        return None
    hp = window.work["hp"]
    return 100.0 * sum(decode.batch_bound_s(hp, b) for b in window.work["batches"]) / t
