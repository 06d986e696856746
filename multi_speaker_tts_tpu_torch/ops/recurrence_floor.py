"""Sequential floors of the recurrent kernels (``csrc/barrier_floor.cu``).

:func:`barrier_floor` launches a grid of 256-thread blocks, the LSTM and
BiLSTM kernels' (``lstm_persistent.cuh``, ``lstm_bwd.cuh``), or an explicit
block count and block size (the Griffin-Lim kernels', ``griffin_lim.cu`` and
``griffin_lim_dense.cu``; the decode segment's 512-thread blocks,
``decode.cu``), and runs only their grid barrier, ``rounds`` times: the least time that many dependent
rounds can take on the card with that design, whatever the arithmetic of a
round. :func:`gru_chain_floor` runs the BiGRU forward's grid and blocks
(``bigru.cu``) through T steps of only its dependent chain: the recurrent
product (``bigru_step.cuh``), the bf16 store of h and the step's block
barrier, without the input gates and the cell; :func:`gru_bwd_chain_floor`
the same for the BiGRU backward (``bigru_bwd.cu``): ldmatrix of bf16(dGh),
the K = 3H product, the bf16 store of dGh and the block barrier, without
the residuals and the cell.

They replace no TPU kernel and no model path calls them; ``chip_smoke.py``
times them beside those kernels (``floor_ms``). They have no plain version
and no CPU path.
"""

from __future__ import annotations

import ctypes

import torch

from multi_speaker_tts_tpu_torch.ops import _build

KERNEL = _build.Kernel("barrier_floor", "barrier_floor.cu", {
    "mstts_barrier_floor": [_build.P] + [_build.I] * 5 + [_build.P, _build.P],
    "mstts_gru_chain_floor": [_build.P] + [_build.I] * 3 + [_build.P, _build.P],
    "mstts_gru_bwd_chain_floor": [_build.P] + [_build.I] * 3 + [_build.P, _build.P],
})


def _cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("the floor kernels run on a CUDA device only")
    return device


def barrier_floor(rounds: int, ndir: int, hidden: int, device, blocks: int = 0,
                  threads: int = 256):
    """Launch ``rounds`` grid barriers on a CUDA ``device``: on the grid of
    an ``ndir``-direction recurrence of ``hidden`` units, or on ``blocks``
    blocks when that is > 0, of ``threads`` threads a block. Returns the
    grid's block count and the barrier's arrival counter, which holds
    ``rounds * blocks`` once the launch has run."""
    device = _cuda(device)
    bar = torch.zeros(1, dtype=torch.int32, device=device)
    grid = ctypes.c_int(0)
    KERNEL.call("mstts_barrier_floor", bar.data_ptr(), rounds, ndir, hidden, blocks, threads,
                ctypes.addressof(grid), torch.cuda.current_stream(device).cuda_stream)
    return grid.value, bar


def gru_chain_floor(steps: int, batch: int, hidden: int, device, backward: bool = False) -> int:
    """Launch ``steps`` steps of the BiGRU forward's (or, with ``backward``,
    the BiGRU backward's) dependent chain on a CUDA ``device``, on its grid
    for ``batch`` rows of ``hidden`` units (zero weights: their values do
    not change the time). Returns the grid's block count."""
    device = _cuda(device)
    if hidden % 16 or not 16 <= hidden <= 192:
        raise ValueError(f"the BiGRU floor needs H % 16 == 0 and 16 <= H <= 192, got {hidden}")
    w = torch.zeros((3 * hidden, hidden), dtype=torch.bfloat16, device=device)
    grid = ctypes.c_int(0)
    KERNEL.call("mstts_gru_bwd_chain_floor" if backward else "mstts_gru_chain_floor",
                w.data_ptr(), steps, batch, hidden, ctypes.addressof(grid),
                torch.cuda.current_stream(device).cuda_stream)
    return grid.value
