"""A/B: the K-step decode kernel (``csrc/decode.cu``) against the plain AR
loop at the production serving shape (port of the top-level
``tools/decode_kernel_ab.py``).

Chains n_steps / K K-step chunks through the port's
``decoder_ar_early_exit`` (threshold 1.5 never fires, so every variant runs
every step; prenet dropout 0.5 on, masks from one seeded generator) and
reports us a step for, under the JAX tool's keys: ``xla_bf16`` and
``xla_int8`` (the plain loop with bf16 and weight-only int8 gates, the
port's counterparts of the XLA segment), ``pallas_int8`` and
``pallas_bf16`` (the kernel's two modes as the chunk body). Random weights
at production width (H 1024, memory 768, prenet 256, attention 128, mel 80,
r 2, location conv 31 x 32) at the JAX tool's scale of 0.05.

    python -m multi_speaker_tts_tpu_torch.tools.decode_kernel_ab \\
        [-batch 8] [-steps 192] [-chunk 16] [-S 48] [-device cpu]

Beyond the JAX tool's keys: the kernel's launches a run of each kernel
variant (chunks x row groups), and the row groups it launches at this S
and batch (``decode_kernel.kernel_row_groups``: as many rows a launch as
fit the card's shared memory at S), with the card's name and power limit.
On the card a run is timed by a two-point slope (one and five runs, the
best of three, the card synchronized around each); ``-device cpu`` runs the
kernel's plain version as the chunk body.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.tools import _timing

H, D, P, A, MEL, R, CONV_K, CONV_C = 1024, 768, 256, 128, 80, 2, 31, 32
DROP = 0.5  # the production prenet's always-on dropout


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-batch", type=int, default=8)
    parser.add_argument("-steps", type=int, default=192)
    parser.add_argument("-chunk", type=int, default=16)
    parser.add_argument("-S", type=int, default=48)
    parser.add_argument("-device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multi_speaker_tts_tpu_torch.inference import prenet_mask_sampler, resolve_device
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.models.layers import prenet_step
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
    from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

    dev = resolve_device(args.device)
    B, T, K, S = args.batch, args.steps, args.chunk, args.S
    rng = np.random.default_rng(0)

    def w(*shape, scale=0.05):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(dev)

    lstm = (LSTMParams(w(P + D, 4 * H), w(H, 4 * H), w(4 * H)),
            LSTMParams(w(H + D, 4 * H), w(H, 4 * H), w(4 * H)))
    att = dscan.AttentionParams(w(H, A), w(CONV_K, 2, CONV_C), w(CONV_C, A), w(A, 1))
    prenet_ws = [(w(MEL, P), w(P)), (w(P, P), w(P))]
    p = dscan.DecoderParams(lstm, att, (w(H + D, MEL * R), w(MEL * R)), (w(H + D, 1), w(1)))
    keys = w(B, S, A, scale=0.3)
    memory = w(B, S, D, scale=0.3)
    mask = torch.ones(B, S, device=dev)
    hp = Recursive_Parse({"Decoder": {"Prenet": {"Dropout_Rate": DROP, "Sizes": [P, P]}}})

    report = {"batch": B, "steps": T, "chunk": K, "S": S}

    def early_exit_run(body_of):
        def run():
            masks = prenet_mask_sampler(hp, dev, 7, B)  # the same draws every run
            frames, *_ = dscan.decoder_ar_early_exit(p, keys, memory, mask, T, 1.5,
                                                     body_of(masks), MEL, chunk=K)
            return frames.mean()

        return run

    def plain(fuse):  # the weights fused a run, as a synthesis call fuses them
        return lambda masks: dscan.plain_body(p, fuse(), prenet_step(prenet_ws, DROP, masks),
                                              MEL, torch.bfloat16)

    def kernel(bundle):
        return lambda masks: dk.kernel_body(bundle, masks, MEL, R, DROP)

    bundles = {q: dk.prepare_bundle(p, prenet_ws, quantize=q) for q in (True, False)}
    variants = {
        "xla_bf16": (early_exit_run(plain(lambda: dscan.fused_weights(lstm, torch.bfloat16))),
                     None),
        "xla_int8": (early_exit_run(plain(lambda: dscan.quantize_fused(p))), None),
        "pallas_int8": (early_exit_run(kernel(bundles[True])), "int8"),
        "pallas_bf16": (early_exit_run(kernel(bundles[False])), "bf16"),
    }
    with torch.no_grad():
        for name, (run, mode) in variants.items():
            t0 = time.perf_counter()
            float(run())  # warm: the kernel's build and the packing of its weights
            print(f"{name}: warmed up in {time.perf_counter() - t0:.1f}s", flush=True)
            us = _timing.per_call_ms(run, dev) * 1e3 / T
            report[f"us_per_step_{name}"] = round(us, 2)
            line = f"{name}: {us:.1f} us/step"
            if mode is not None:
                kernel = dk.KERNELS[mode]
                before = kernel.launches
                float(run())
                groups = dk.kernel_row_groups(bundles[mode == "int8"], B, S, dev)
                report[f"launches_per_run_{name}"] = kernel.launches - before
                report[f"row_groups_{name}"] = [g.stop - g.start for g in groups]
                line += (f", {kernel.launches - before} kernel launches a run (row groups "
                         f"{report[f'row_groups_{name}']} at S {S})")
            print(line, flush=True)
    report["device"] = str(dev)
    report["card"] = _timing.card(dev)
    print("PROBE " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
