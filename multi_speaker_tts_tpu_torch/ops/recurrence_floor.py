"""The sequential floor of the persistent recurrence kernels.

``csrc/barrier_floor.cu`` launches the grid and block of the LSTM and
BiLSTM kernels (``lstm_persistent.cuh``, ``lstm_bwd.cuh``) and runs only
their grid barrier, ``rounds`` times: the least time that T dependent steps
can take on the card with this design, whatever the arithmetic of a step.
It replaces no TPU kernel and no model path calls it; ``chip_smoke.py``
times it beside each recurrence (``floor_ms``). It has no plain version
and no CPU path.
"""

from __future__ import annotations

import ctypes

import torch

from multi_speaker_tts_tpu_torch.ops import _build

KERNEL = _build.Kernel("barrier_floor", "barrier_floor.cu", {
    "mstts_barrier_floor": [_build.P, _build.I, _build.I, _build.I, _build.P, _build.P],
})


def barrier_floor(rounds: int, ndir: int, hidden: int, device):
    """Launch ``rounds`` grid barriers on the grid of an ``ndir``-direction
    recurrence of ``hidden`` units on a CUDA ``device``. Returns the grid's
    block count and the barrier's arrival counter, which holds
    ``rounds * blocks`` once the launch has run."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the barrier-floor kernel runs on a CUDA device only")
    bar = torch.zeros(1, dtype=torch.int32, device=device)
    blocks = ctypes.c_int(0)
    KERNEL.call("mstts_barrier_floor", bar.data_ptr(), rounds, ndir, hidden,
                ctypes.addressof(blocks), torch.cuda.current_stream(device).cuda_stream)
    return blocks.value, bar
