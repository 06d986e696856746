"""Share of the traced window in which no operation ran on the device, in %
(``harness/trace.py``: ``idle_share``)."""

from benchmark.harness.trace import idle_share as read  # noqa: F401
