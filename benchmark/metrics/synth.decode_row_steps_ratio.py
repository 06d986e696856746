"""Row steps the decode ran (the program's ``decode.row_steps``: every row of
the padded batch, K steps a chunk, until the last row stops) over the steps
each row decoded, summed over the window's batches (``harness/spans.py``)."""

from benchmark.harness import spans


def read(window):
    needed = sum(sum(b["steps"]) for b in window.work["batches"])
    return spans.ratio(window, "decode.row_steps", needed)
