"""The serving-shape AR decode budget (port of the top-level
``tools/decode_probe.py``).

Times the production-width AR decode of ``demo/serving_ckpt_full.msgpack``
at the serving shape (B 8, bucketed tokens) on the card, without the
vocoder (``vocode=False, return_device=True``, the lengths fetched at the
end): the fixed-length decode (``early_exit=False``) against the chunked
early exit, for each decode the port has: ``f32`` (the checkpoint's own
plain loop, in its bf16 compute dtype) and ``int8`` (the plain loop with
weight-only int8 gates), as the JAX tool measures, and beyond them
``bf16_pallas`` and ``int8_pallas`` (the K-step decode kernel,
``csrc/decode.cu``). The early exit runs at a stop threshold of 1.5, out of
reach, so both loops time the same steps and the difference is the loop's
machinery.

    python -m multi_speaker_tts_tpu_torch.tools.decode_probe [-batch 8] [-steps 400] \\
        [-ckpt PATH] [-device cpu]

A measurement is a two-point slope (one and five calls, the best of three
each, the card synchronized around each). Prints a line a measurement, then
``PROBE {json}`` with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

from multi_speaker_tts_tpu_torch.tools import _timing

ROOT = pathlib.Path(__file__).resolve().parents[2]
TEXTS = [
    "the quick brown fox jumps over the lazy dog.",
    "she sells sea shells by the sea shore.",
    "a stitch in time saves nine.",
    "all that glitters is not gold.",
    "actions speak louder than words.",
    "the early bird catches the worm.",
    "practice makes perfect.",
    "better late than never.",
]
# Synthesizer(quantize=...) -> the report's tag.
MODES = ((None, "f32"), ("int8", "int8"), ("bf16_pallas", "bf16_pallas"),
         ("int8_pallas", "int8_pallas"))


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument("-batch", type=int, default=8)
    parser.add_argument("-steps", type=int, default=400)
    parser.add_argument("-ckpt", default=str(ROOT / "demo" / "serving_ckpt_full.msgpack"))
    parser.add_argument("-device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multi_speaker_tts_tpu_torch.inference import Synthesizer, resolve_device

    dev = resolve_device(args.device)
    texts = TEXTS[: args.batch]
    report: dict = {"batch": args.batch, "max_steps": args.steps}

    def decode_ms(synth, spk, early_exit: bool) -> float:
        def run():
            out = synth.synthesize(texts, spk, vocode=False, early_exit=early_exit,
                                   return_device=True, max_steps=args.steps)
            out["mel_lengths"].cpu()

        run()  # warm
        return _timing.per_call_ms(run, dev)

    spk = None
    for quant, tag in MODES:
        synth = Synthesizer.from_compact(args.ckpt, quantize=quant, device=dev)
        if spk is None:
            spk = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav"),
                                str(ROOT / "demo" / "enroll_spk0_utt1.wav")])
        n_scan = args.steps // int(synth.hp.Decoder.get("N_Frames_Per_Step", 1))
        for early_exit, mode in ((False, "fixed"), (True, "early_exit")):
            if early_exit:
                # The full bucket on the early-exit path too (the threshold
                # out of reach): both modes time the same step count.
                synth.hp = synth.hp.replace(Decoder={"Stop_Threshold": 1.5})
            ms = decode_ms(synth, spk, early_exit)
            key = f"decode_ms_{tag}_{mode}"
            report[key] = round(ms, 3)
            report[f"us_per_step_{tag}_{mode}"] = round(ms * 1e3 / n_scan, 2)
            print(f"{key}: {ms:.2f} ms ({ms * 1e3 / n_scan:.1f} us/step, "
                  f"{n_scan} scan steps)", flush=True)
        del synth
    report["device"] = str(dev)
    report["card"] = _timing.card(dev)
    print("PROBE " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
