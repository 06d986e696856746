"""The phase-stamp tool's host side: the stamped copy of a kernel source and
the folding of its stamps into phases and barrier rounds (the tool itself
runs on the card)."""

import pathlib

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu_torch.tools import phase_stamps

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

CSRC = pathlib.Path(phase_stamps.__file__).resolve().parents[1] / "csrc"


@pytest.mark.parametrize("source, kernel, barriers, arrive_wait", [
    ("decode.cu", "decode_kernel", 4, 1),         # four barriers and one split barrier a step
    ("griffin_lim_dense.cu", "gl_dense_kernel", 2, 1),
])
def test_stamped_source_brackets_every_grid_barrier(source, kernel, barriers, arrive_wait):
    text = (CSRC / source).read_text()
    got = phase_stamps.stamped_source(text, kernel, CSRC)
    # Start, end, and both sides of each barrier line of the kernel's body.
    assert got.count("mstts_stamp(mstts_stamp_n++)") == 2 + 2 * (barriers + arrive_wait)
    assert got.count("int mstts_stamp_n = 0;") == 1
    assert f'#include "{CSRC / "common.cuh"}"' in got and "mstts_read_stamps" in got
    # The rest of the source is untouched.
    assert got.count("__global__") == text.count("__global__")


def test_stamped_source_refuses_an_unknown_kernel():
    with pytest.raises(ValueError, match="no __global__"):
        phase_stamps.stamped_source((CSRC / "decode.cu").read_text(), "no_such_kernel", CSRC)


def test_fold_splits_phases_and_rounds():
    """A launch of 1 set-up round and 3 steps of 2 rounds: phases of 50 and
    70 cycles, barriers of 10 and 20."""
    stamps = [1000]
    stamps += [stamps[-1] + 40, stamps[-1] + 45]  # set-up phase 40, its barrier 5
    for _ in range(3):
        for phase, wait in ((50, 10), (70, 20)):
            stamps += [stamps[-1] + phase, stamps[-1] + phase + wait]
    stamps.append(stamps[-1] + 30)
    buf = np.zeros(8192, np.int64)
    buf[:len(stamps)] = stamps
    got = phase_stamps.fold(buf, 2)
    assert got["steps"] == 3 and got["set_up_cycles"] == 45
    assert got["phase_cycles"] == [50, 70] and got["barrier_cycles"] == [10, 20]
    assert got["cycles_a_step"] == 150
    assert got["phase_shares"] == [round(50 / 150, 4), round(70 / 150, 4)]
