"""Row frames the vocoder ran (the program's ``vocode.row_frames``: every row
of a call at its frame bucket) over the frames each row decoded, summed over
the window's batches (``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    needed = sum(sum(b["frames"]) for b in window.work["batches"])
    return spans.ratio(window, "vocode.row_frames", needed)
