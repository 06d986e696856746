"""The AR decode's two gate products alone at the serving shape (port of the
top-level ``tools/gates_probe.py``).

The decode step is: layer-0 gates (B, 2048) @ (2048, 4096) -> attention ->
layer-1 gates (B, 2816) @ (2816, 4096) -> projections. This probe times just
the two dependent gate products, with the LSTM cell between them, in a loop
of ``-steps`` steps (true step-to-step dependence, both layers' outputs
kept live), through the port's plain decode route
(``ops/decoder_scan._gates``): bf16 (``fused_weights``) and the weight-only
int8 route (``quantize_fused``; key ``int8_xla``, the JAX tool's name for
the XLA int8 it replaces). The JAX tool's third variant, ``int8_pallas``,
imports ``ops.gates_pallas``, which the JAX package does not have: there is
nothing to port, and this tool says so.

    python -m multi_speaker_tts_tpu_torch.tools.gates_probe [-batch 8] [-steps 200] [-device cpu]

On the card (the default) the loop is timed by a two-point slope (one and
five loops, the best of three each, the card synchronized around each);
prints one line a variant, then ``PROBE {json}`` with the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.tools import _timing


def make_loop(fused0, fused1, b0, b1, x0, T: int, compute_dtype):
    """The probe's loop: T steps of both gate products and cells from zero
    state; returns a scalar of both layers' outputs."""
    from multi_speaker_tts_tpu_torch.ops.decoder_scan import _gates
    from multi_speaker_tts_tpu_torch.ops.lstm import cell

    B, H = x0.shape[0], b0.shape[0] // 4

    def run():
        z = x0.new_zeros((B, H))
        h0, c0, h1, c1 = z, z, z, z
        for _ in range(T):
            h0, c0 = cell(_gates(fused0, b0, x0, h0, compute_dtype), c0)
            # stand-in for attention / context: reuse a slice of h0 as input
            x1 = torch.cat([h0, h0[:, :768]], dim=-1)
            h1, c1 = cell(_gates(fused1, b1, x1, h1, compute_dtype), c1)
        # Both layers' outputs: the second product is never dead work.
        return h0.mean() + h1.mean()

    return run


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-batch", type=int, default=8)
    parser.add_argument("-steps", type=int, default=200)
    parser.add_argument("-device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multi_speaker_tts_tpu_torch.inference import resolve_device
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
    from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

    dev = resolve_device(args.device)
    B, T = args.batch, args.steps
    H = 1024
    D0, D1 = 1024 + H, 1792 + H  # fused [x; h] rows a layer
    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    w0 = t(rng.standard_normal((D0, 4 * H)) * 0.02)
    w1 = t(rng.standard_normal((D1, 4 * H)) * 0.02)
    b0 = torch.zeros(4 * H, device=dev)
    b1 = torch.zeros(4 * H, device=dev)
    x0 = t(rng.standard_normal((B, D0 - H)))
    lstm = (LSTMParams(w0[:D0 - H], w0[D0 - H:], b0), LSTMParams(w1[:D1 - H], w1[D1 - H:], b1))
    variants = {
        "bf16": dscan.fused_weights(lstm, torch.bfloat16),
        "int8_xla": dscan.quantize_fused(dscan.DecoderParams(lstm, None, None, None)),
    }
    print("int8_pallas: not run: the JAX tool imports ops.gates_pallas, which the JAX "
          "package does not have (nothing to port)", flush=True)
    report = {"batch": B, "steps": T}
    with torch.no_grad():
        for name, (f0, f1) in variants.items():
            run = make_loop(f0, f1, b0, b1, x0, T, torch.bfloat16)
            float(run())  # warm
            us = _timing.per_call_ms(run, dev) * 1e3 / T
            report[f"gates_us_per_step_{name}"] = round(us, 2)
            print(f"{name}: {us:.1f} us/step (2 gate GEMMs)", flush=True)
    report["device"] = str(dev)
    report["card"] = _timing.card(dev)
    print("PROBE " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
