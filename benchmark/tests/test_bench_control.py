"""The control has to come out not correct: the plain reference put in the
program's place one precision below the configuration's (fp8 operands for
its bf16), read on the same served outputs, and for the synthesis cell the
program's own lower-precision decode (``int8_pallas``). At a small size on
the CPU, and on the card at the cells' own sizes (``control.py`` prints the
readings the limits were set from)."""

import time

import pytest

from benchmark.tests import small


def control_fails(result) -> list[str]:
    return [k for k, v in result["compared"].items()
            if "." in k and v["value"] > v["limit"]]


@pytest.mark.parametrize("cell", list(small.SIZES))
def test_control_fails_small(cell):
    out = small.run(cell, control=True)
    assert control_fails(out["result"]), out["result"]["compared"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(small.SIZES))
def test_control_fails_on_card(card, cell):
    from benchmark.harness import runner
    from benchmark.harness.cell import Cell, Context

    ctx = Context(Cell.by_name(cell), 4242, 3.0, False, device=card, control=True)
    out = runner.execute(ctx, time.perf_counter())
    assert control_fails(out["result"]), out["result"]["compared"]


def test_int8_decode_fails_small():
    out = small.run("synth.b32-short", quantize="int8_pallas")
    assert not out["result"]["correct"], out["result"]["compared"]


@pytest.mark.cuda
def test_int8_decode_fails_on_card(card):
    from benchmark.harness import runner
    from benchmark.harness.cell import Cell, Context

    ctx = Context(Cell.by_name("synth.b32-short"), 4243, 6.0, False, device=card,
                  overrides={"quantize": "int8_pallas"})
    out = runner.execute(ctx, time.perf_counter())
    assert not out["result"]["correct"], out["result"]["compared"]
