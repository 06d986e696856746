"""Bound of the LSTM backward (``csrc/lstm_bwd.cu`` + ``lstm_bwd.cuh``, #8)
on one layer over B rows and T steps, as ``chip_smoke.py`` counts it: the
saved bf16 gates and f32 cell states read once, W_hh once, the upstream
f32 cotangents of every step once, the gate cotangents written once; the
recurrent product dh = dG W_hh^T, 2 operations a multiply-add. bf16 peak."""

from __future__ import annotations

from benchmark.harness.peaks import BF16_FLOPS, bound_s


def layer_bound_s(T: int, B: int, H: int) -> float:
    gates, cells, dys = 2 * T * B * 4 * H, 4 * T * B * H, 4 * T * B * H
    n_bytes = gates + cells + 2 * 4 * H * H + 4 * T * B * 4 * H + dys + 4 * B * H
    return bound_s(n_bytes, 2 * T * B * 4 * H * H, BF16_FLOPS)


def stack_bound_s(dims: dict, T: int, B: int) -> float:
    return dims["layers"] * layer_bound_s(T, B, dims["H"])
