"""The HiFi-GAN cell (``synth_hifigan.b32-short``) at a small size on the
CPU: the same driver with the generator at 32 channels (the published
rates and kernels) and limits of its own, set from this size's readings
(one seed: ``wave_row`` 5.7e-3, ``stage_row`` 3.0e-3; their fp8 control
7.6e-2 and 3.6e-2). A sound run is correct; each fault of
``faults_hifigan.py`` planted under the timed path makes it not correct;
the fp8 control fails the vocoder's numbers; the generator's operations
at V1's widths are the published arithmetic's."""

import time

import pytest
import torch

from benchmark import faults_hifigan
from benchmark.harness import runner
from benchmark.harness.cell import Cell, Context
from benchmark.rooflines import hifigan as roof
from benchmark.tests import small

CELL = "synth_hifigan.b32-short"
SIZE = {"params": small.SYNTH["params"],
        "hp": {"Vocoder": {"HiFiGAN": {"Upsample_Initial_Channel": 32}}},
        "limits": {**{k: v for k, v in small.SYNTH["limits"].items()
                      if k in ("enroll_gap", "frame_med", "stop_med", "align_row", "postnet_med")},
                   "wave_row": 0.015, "wave_med": 0.015, "stage_row": 0.01,
                   "wave_rerun_gap": 0.0}}


def run(control: bool = False, seed: int = (1 << 31) + 7):
    torch.manual_seed(0)
    ctx = Context(Cell.by_name(CELL), seed, 1.0, False, device="cpu", overrides=SIZE,
                  control=control)
    return runner.execute(ctx, time.perf_counter())


def test_sound_run_is_correct():
    out = run()
    assert out["result"]["correct"], out["result"]["compared"]
    assert set(SIZE["limits"]) == set(out["result"]["compared"])


@pytest.mark.parametrize("fault", faults_hifigan.FAULTS, ids=lambda f: f.__name__)
def test_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch.setattr)
    out = run()
    assert not out["result"]["correct"], out["result"]["compared"]


def test_the_fp8_control_fails_the_vocoder():
    got = {c.name: c.value for c in run(control=True)["compared"]}
    for name in ("wave_row", "wave_med", "stage_row"):
        assert got[name] <= SIZE["limits"][name] < got[name + ".control"] / 3, name


def test_operations_at_v1_widths():
    """The configuration's widths (V1, ``config_v1.json``): 614.1 MFLOP a
    frame, 594.5 of them the MRFs', 13,926,017 parameters."""
    V1 = Cell.by_name(CELL).config["hp"]["Vocoder"]["HiFiGAN"]
    assert roof.frame_flops(V1, 80) == pytest.approx(614.1e6, rel=1e-4)
    no_mrf = dict(V1, Resblock_Kernel_Sizes=[], Resblock_Dilation_Sizes=[])
    assert roof.frame_flops(V1, 80) - roof.frame_flops(no_mrf, 80) == pytest.approx(594.5e6,
                                                                                    rel=1e-4)
    assert roof.parameters(V1, 80) == 13_926_017
