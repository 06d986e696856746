"""Streamed against batch vocoding quality on a compact checkpoint (port of
the top-level ``tools/stream_quality.py``).

The streaming vocoder's one approximation against batch synthesis is
windowed Griffin-Lim (a phase a window, joined by a crossfade); mel and
linear are exactly the batch's. This tool measures that approximation by a
listener-proxy metric: each wav re-analysed through the model's own mel
front-end, L1 against the model's (normalized, post-postnet) mel over the
decoded frames. Three numbers a run:

  batch      the batch vocoder (the floor: Griffin-Lim's own error)
  stream     windowed Griffin-Lim, crossfade only (``gl_warm_start=False``)
  stream+ws  each window's Griffin-Lim started from the previous window's
             converged overlap (``gl_warm_start=True``)

    python -m multi_speaker_tts_tpu_torch.tools.stream_quality \\
        [-ckpt demo/serving_ckpt.msgpack] [-segment_steps 16] [-device cpu]

Streaming needs a Conv linear head or none: a CBHG checkpoint cannot stream
(the daemon's ``/stream`` answers 501), so the default is the small Conv-head
checkpoint. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

TEXTS = [
    "the quick brown fox jumps over the lazy dog",
    "she sells sea shells by the sea shore",
    "pack my box with five dozen liquor jugs",
    "how vexingly quick daft zebras jump",
]


def reanalyzed_l1(wav: np.ndarray, mel_ref: np.ndarray, synth) -> float:
    """L1 between the wav's re-analysed normalized mel and the model's own
    mel output over the decoded frames (``mel_ref`` is already trimmed)."""
    from multi_speaker_tts_tpu_torch.audio import dsp

    T = mel_ref.shape[0]
    need = (T - 1) * synth.dsp_cfg.hop + synth.dsp_cfg.n_fft
    w = np.zeros((need,), np.float32)
    w[: min(wav.shape[0], need)] = wav[:need]
    mel = dsp.melspectrogram(torch.from_numpy(w).to(synth.device), synth.dsp_cfg)
    return float(np.abs(mel.cpu().numpy()[:T] - mel_ref).mean())


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-ckpt", default="demo/serving_ckpt.msgpack")
    parser.add_argument("-segment_steps", type=int, default=16)
    parser.add_argument("-device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    from multi_speaker_tts_tpu_torch.inference import Synthesizer

    synth = Synthesizer.from_compact(args.ckpt, device=args.device)
    rng = np.random.default_rng(0)
    t = np.arange(24000, dtype=np.float32) / synth.dsp_cfg.sample_rate
    enroll = (0.25 * np.sin(2 * np.pi * 220.0 * t)
              * (1.0 + 0.1 * rng.normal(size=t.size))).astype(np.float32)
    spk = synth.enroll([enroll])

    out = synth.synthesize(TEXTS, spk)
    refs = [np.asarray(o["mel"]) for o in out]
    l1_batch = [reanalyzed_l1(np.asarray(o["wav"]), m, synth) for o, m in zip(out, refs)]

    def stream_l1(warm: bool) -> list[float]:
        chunks = list(synth.stream(TEXTS, spk, segment_steps=args.segment_steps,
                                   gl_warm_start=warm))
        wav = np.concatenate([c["wav_chunk"] for c in chunks], axis=1)
        return [reanalyzed_l1(wav[b], refs[b], synth) for b in range(len(TEXTS))]

    l1_stream = stream_l1(False)
    l1_ws = stream_l1(True)

    report = {
        "ckpt": args.ckpt,
        "device": str(synth.device),
        "segment_steps": args.segment_steps,
        "n_texts": len(TEXTS),
        "wav_mel_l1_batch": round(float(np.mean(l1_batch)), 5),
        "wav_mel_l1_stream_crossfade": round(float(np.mean(l1_stream)), 5),
        "wav_mel_l1_stream_warmstart": round(float(np.mean(l1_ws)), 5),
        "per_utt": {
            "batch": [round(x, 5) for x in l1_batch],
            "stream_crossfade": [round(x, 5) for x in l1_stream],
            "stream_warmstart": [round(x, 5) for x in l1_ws],
        },
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
