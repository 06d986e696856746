"""Bound of the persistent LSTM forward (``csrc/lstm.cu`` +
``lstm_persistent.cuh``, #2; #2r with ``residuals``) on one layer over B
rows and T steps, as ``chip_smoke.py`` counts it: the bf16 inputs, weights
and outputs once (with residuals the gates and c_{t-1}, 5H a row a step),
the f32 bias and states; 2 operations a multiply-add of the input and
recurrent products. bf16 peak."""

from __future__ import annotations

from benchmark.harness.peaks import BF16_FLOPS, bound_s


def layer_bound_s(T: int, B: int, D: int, H: int, residuals: bool) -> float:
    res = T * B * 5 * H if residuals else 0
    n_bytes = 2 * (T * B * D + 4 * H * (D + H) + T * B * H + res) + 4 * (4 * H + 2 * B * H)
    return bound_s(n_bytes, 2 * T * B * 4 * H * (D + H), BF16_FLOPS)


def stack_bound_s(dims: dict, T: int, B: int, residuals: bool) -> float:
    return sum(layer_bound_s(T, B, dims["mel"] if i == 0 else dims["H"], dims["H"], residuals)
               for i in range(dims["layers"]))
