"""Share of the mel front end's device time (#1) that its bound needs over
the window's embedding calls (``rooflines/mel.py``), in %."""

from benchmark.rooflines import mel


def read(window):
    t = window.trace.kernel_s("mel_fft_kernel", "mel_dft_kernel") if window.trace else 0.0
    w = window.work
    if t <= 0 or w.get("kind") != "embed":
        return None
    return 100.0 * sum(mel.bound(w["sound"], c["rows"], c["samples"], c["frames"])
                       for c in w["calls"]) / t
