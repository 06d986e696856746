"""The readers of the program's own spans and counts (``harness/spans.py``):
a hand-built trace's idle time split exactly among the host's spans, the
five parts adding up to the idle share's idle time; a trace without the
program's spans reads nothing; and small traced runs on the CPU read the
counts of work (at least the work needed) and nothing for the readers that
need the card's trace."""

import pytest

from benchmark.harness import spans
from benchmark.harness.cell import Cell
from benchmark.harness.runner import Window
from benchmark.harness.trace import Trace, idle_share
from benchmark.tests import small

IDLE = ["synth.idle_prepare_ms", "synth.idle_decode_ms", "synth.idle_stages_ms",
        "synth.idle_return_ms", "synth.idle_caller_ms"]
RATIOS = ["synth.decode_row_steps_ratio", "synth.vocode_frame_ratio"]
TRAIN = ["ge2e_train.forward_dev_ms", "ge2e_train.update_dev_ms"]


def hand_built(with_call: bool = True) -> Window:
    """A 1,000 ns window of two batches: the device busy on [100, 200],
    [300, 350] and [600, 900] (450 ns, so 550 ns idle), the host in one call
    over [50, 950] with its parts nested in it."""
    host = [(50, 120, "synth.prepare", True), (150, 500, "synth.decode", True),
            (160, 170, "aten::rand", False), (500, 700, "synth.vocode", True),
            (700, 800, "synth.return", True), (880, 940, "synth.return", True)]
    if with_call:
        host.append((50, 950, "synth.call", True))
    tr = Trace(1e-6, device=[(100, 200, "k"), (300, 350, "k"), (600, 900, "k")],
               host=sorted(host))
    return Window(tr, [{}, {}], {}, 1e-6)


def read(name: str, window):
    return Cell.by_name("synth.b32-short").reader(name).read(window)


def test_idle_split_is_exact():
    window = hand_built()
    # In ns, over 2 batches: prepare [50, 120] less [100, 120] busy; decode
    # [150, 500] less 100 busy; return 160 less 120 busy; the stages [120,
    # 150], [500, 700], [800, 880], [940, 950] less 210 busy; the caller
    # [0, 50] and [950, 1000].
    want = {"synth.idle_prepare_ms": 50, "synth.idle_decode_ms": 250,
            "synth.idle_stages_ms": 110, "synth.idle_return_ms": 40,
            "synth.idle_caller_ms": 100}
    got = {name: read(name, window) for name in IDLE}
    assert got == pytest.approx({k: v / 2 / 1e6 for k, v in want.items()})
    idle_s = idle_share(window) / 100 * window.window_s
    assert sum(got.values()) * len(window.records) / 1e3 == pytest.approx(idle_s)


def test_no_call_span_reads_nothing():
    window = hand_built(with_call=False)
    assert [read(name, window) for name in IDLE] == [None] * len(IDLE)


@pytest.mark.parametrize("xs, ys, want", [
    ([(0, 10)], [(2, 3), (5, 7)], [(0, 2), (3, 5), (7, 10)]),
    ([(0, 4), (6, 9)], [(3, 7)], [(0, 3), (7, 9)]),
    ([(0, 4)], [], [(0, 4)]),
    ([(1, 2)], [(0, 5)], []),
])
def test_subtract(xs, ys, want):
    assert spans.subtract(xs, ys) == want
    assert spans.overlap(xs, ys) == spans.length(xs) - spans.length(want)


def test_small_synthesis_counts_its_padded_work():
    metrics = small.run("synth.b32-short", trace=True)["result"]["metrics"]
    for name in RATIOS:
        assert metrics[name]["value"] >= 1.0, name
    assert not set(IDLE) & set(metrics)  # no device trace on the CPU


def test_small_training_reads_no_device_span():
    metrics = small.run("ge2e_train.n64m10", trace=True)["result"]["metrics"]
    assert not set(TRAIN) & set(metrics)
