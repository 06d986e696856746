"""Each cell's run with its timed path broken underneath (``faults.py``):
the harness's look for a card skipped, the rest of a run driven at a small
size on the CPU, and ``correct`` has to come out false; unbroken, true. The
faults are those the cell can have: an answer altered where it is
produced, a step that leaves the state unchanged (for every row, one row,
or one row group), half of the batch left out with the mean taken over the
rest."""

import pytest

from benchmark import faults
from benchmark.tests import small


def test_sound_runs_are_correct():
    for cell in small.SIZES:
        out = small.run(cell)
        assert out["result"]["correct"], (cell, out["result"]["compared"])


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in faults.BY_CELL.items() for f in fs],
                         ids=lambda x: x if isinstance(x, str) else x.__name__)
def test_fault_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch.setattr)
    out = small.run(cell)
    assert not out["result"]["correct"], out["result"]["compared"]
