"""Offline pattern generation (port of
``multi_speaker_tts_tpu.data.pattern_generator``).

Walks LJSpeech / VCTK trees, resamples and trims each wav, extracts mel and
linear spectrograms with the numpy reference DSP (:mod:`..audio.oracle`),
and pickles one pattern file per utterance plus a metadata index for length
bucketing, in the JAX package's layout: each package reads the other's
patterns. A process pool over files is the only process boundary.
``generate_synthetic_dataset`` writes a deterministic speech-like corpus
that needs no download.

    python -m multi_speaker_tts_tpu_torch.data.pattern_generator -lj DIR -out DIR
"""

from __future__ import annotations

import multiprocessing as mp
import os
import pathlib
import pickle

import numpy as np

from multi_speaker_tts_tpu_torch import text as text_frontend
from multi_speaker_tts_tpu_torch.audio import oracle, wav_io

METADATA_FILE = "METADATA.PICKLE"


def lj_info_load(root: str | pathlib.Path):
    """LJSpeech-1.1 layout: metadata.csv + wavs/*.wav -> [(path, text, speaker)]."""
    root = pathlib.Path(root)
    items = []
    with open(root / "metadata.csv", encoding="utf-8") as f:
        for line in f:
            parts = line.strip().split("|")
            if len(parts) < 2:
                continue
            file_id, transcript = parts[0], parts[-1]
            wav = root / "wavs" / f"{file_id}.wav"
            if wav.exists():
                items.append((str(wav), transcript, "LJ"))
    return items


def vctk_info_load(root: str | pathlib.Path):
    """VCTK layout: wav48/<spk>/*.wav + txt/<spk>/*.txt -> [(path, text, speaker)].
    Only ``.wav`` files are listed: ``wav_io`` decodes WAV alone, so a
    ``.flac`` release (VCTK 0.92's ``wav48_silence_trimmed``) yields no item
    rather than one pattern failure per file; decode it to WAV first."""
    root = pathlib.Path(root)
    wav_root = next((root / d for d in ("wav48", "wav48_silence_trimmed", "wavs")
                     if (root / d).exists()), None)
    txt_root = root / "txt"
    if wav_root is None:
        raise FileNotFoundError(f"no VCTK wav directory under {root}")
    items = []
    for spk_dir in sorted(wav_root.iterdir()):
        if not spk_dir.is_dir():
            continue
        speaker = spk_dir.name
        for wav in sorted(spk_dir.glob("*.wav")):
            txt = txt_root / speaker / (wav.stem.split("_mic")[0] + ".txt")
            if txt.exists():
                items.append((str(wav), txt.read_text(encoding="utf-8").strip(), speaker))
    if not items and any(wav_root.glob("*/*.flac")):
        raise ValueError(f"{wav_root} holds .flac files only; wav_io reads WAV: decode them first")
    return items


def _process_one(args):
    wav_path, transcript, speaker, dataset, hp_dict, out_dir = args
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse

    hp = Recursive_Parse(hp_dict)
    try:
        wav, _ = wav_io.load_wav(wav_path, target_sr=hp.Sound.Sample_Rate)
        wav = oracle.trim_silence(wav, top_db=hp.Sound.Trim_Top_DB)
        peak = np.max(np.abs(wav))
        if peak < 1e-4 or len(wav) < hp.Sound.Frame_Length:
            return None
        wav = (wav / peak) * 0.99
        mel = oracle.melspectrogram(wav, hp)
        spect = oracle.spectrogram(wav, hp)
        tokens = text_frontend.encode_text(transcript, hp)
        if len(tokens) < 2:
            return None
        pattern = {
            "Mel": mel.astype(np.float32),
            "Spect": spect.astype(np.float32),
            "Text": transcript,
            "Tokens": tokens,
            "Speaker": speaker,
            "Dataset": dataset,
        }
        name = f"{dataset}.{speaker}.{pathlib.Path(wav_path).stem}.pickle"
        out_path = pathlib.Path(out_dir) / name
        with open(out_path, "wb") as f:
            pickle.dump(pattern, f, protocol=4)
        return {
            "File": name,
            "Mel_Length": mel.shape[0],
            "Token_Length": len(tokens),
            "Speaker": speaker,
            "Dataset": dataset,
        }
    except Exception as e:  # noqa: BLE001 - one bad file must not kill the run
        print(f"pattern generation failed for {wav_path}: {e}")
        return None


def generate_patterns(
    items: list[tuple[str, str, str]],
    hp,
    out_dir: str | pathlib.Path,
    dataset_name: str = "TTS",
    num_workers: int | None = None,
) -> dict:
    """Extract + pickle patterns for (wav, text, speaker) items; returns and
    writes the metadata index."""
    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    hp_dict = hp.to_dict()
    args = [(w, t, s, dataset_name, hp_dict, str(out_dir)) for (w, t, s) in items]

    if num_workers is None:
        num_workers = min(os.cpu_count() or 1, 8)
    if num_workers > 1 and len(args) > 1:
        with mp.get_context("spawn").Pool(num_workers) as pool:
            results = pool.map(_process_one, args)
    else:
        results = [_process_one(a) for a in args]

    entries = [r for r in results if r is not None]
    metadata = {
        "Files": [e["File"] for e in entries],
        "Mel_Lengths": np.asarray([e["Mel_Length"] for e in entries], np.int32),
        "Token_Lengths": np.asarray([e["Token_Length"] for e in entries], np.int32),
        "Speakers": [e["Speaker"] for e in entries],
        "Datasets": [e["Dataset"] for e in entries],
        "Mel_Dim": hp.Sound.Mel_Dim,
        "Spectrogram_Dim": hp.Sound.Spectrogram_Dim,
        "Sample_Rate": hp.Sound.Sample_Rate,
    }
    with open(out_dir / METADATA_FILE, "wb") as f:
        pickle.dump(metadata, f, protocol=4)
    return metadata


def generate_synthetic_dataset(
    hp,
    out_dir: str | pathlib.Path,
    n_speakers: int = 4,
    n_utterances: int = 8,
    seed: int = 0,
    num_workers: int = 1,
    voice: str = "legacy",
    speaker_offset: int = 0,
) -> dict:
    """Deterministic synthetic speech-like corpus (no LJSpeech/VCTK on this
    machine): per-speaker fundamental + harmonics with varying duration.
    Used by tests and the benchmark harness.

    ``voice="legacy"`` (default) keeps the original recipe bit-for-bit:
    f0 = 110 * 1.3^s, 3 fixed-decay harmonics — distinct up to ~8 speakers
    but f0 passes Nyquist beyond that. ``voice="rich"`` supports the
    32-64-speaker verification eval: each speaker draws
    a bounded-f0 + harmonic-timbre profile from its own seeded generator —
    log-spaced f0 in [85, 320] Hz with per-speaker jitter, 6 harmonics with
    per-speaker amplitude decay and two formant-like resonance bumps, and a
    per-speaker vibrato rate — so identity lives in timbre, not just pitch,
    and nearby-f0 speakers force the encoder to learn more than a pitch
    detector. ``speaker_offset`` shifts the speaker-profile indices (and
    names) so a held-out corpus has disjoint voices from a training one."""
    rng = np.random.default_rng(seed)
    out_dir = pathlib.Path(out_dir)
    wav_dir = out_dir / "wavs"
    wav_dir.mkdir(parents=True, exist_ok=True)
    sr = hp.Sound.Sample_Rate
    sentences = [
        "the quick brown fox jumps over the lazy dog.",
        "she sells sea shells by the sea shore.",
        "a stitch in time saves nine.",
        "all that glitters is not gold.",
        "actions speak louder than words.",
        "the early bird catches the worm.",
        "practice makes perfect.",
        "better late than never.",
    ]
    items = []
    for s_local in range(n_speakers):
        s = s_local + speaker_offset
        if voice == "rich":
            spk_rng = np.random.default_rng(10_000 + s)
            # Log-spaced base pitch over [85, 320] Hz, decorrelated from the
            # speaker index by jitter; wraps every 24 profiles.
            f0 = 85.0 * (320.0 / 85.0) ** (((s * 7) % 24) / 24.0)
            f0 *= float(spk_rng.uniform(0.96, 1.04))
            n_harm = 6
            decay = float(spk_rng.uniform(0.45, 0.75))
            amps = decay ** np.arange(n_harm)
            # Two formant-like resonances: boost harmonics nearest two
            # per-speaker center frequencies.
            for fc in spk_rng.uniform(300.0, 3200.0, size=2):
                amps *= 1.0 + 1.5 * np.exp(
                    -((f0 * np.arange(1, n_harm + 1) - fc) ** 2)
                    / (2 * 250.0**2)
                )
            amps /= amps.max()
            vib_rate = float(spk_rng.uniform(3.0, 7.0))
            vib_depth = float(spk_rng.uniform(0.005, 0.03))
        else:
            f0 = 110.0 * (1.3**s)  # distinct per-speaker fundamental
            n_harm = 3
            amps = 0.5 ** np.arange(n_harm)
            vib_rate = None  # legacy: utterance-indexed vibrato
            vib_depth = 0.02
        for u in range(n_utterances):
            dur = float(rng.uniform(0.4, 1.2))
            t = np.arange(int(dur * sr)) / sr
            rate = vib_rate if vib_rate is not None else (2 + u % 3)
            vib = 1.0 + vib_depth * np.sin(2 * np.pi * rate * t)
            wav = sum(
                amps[k] * np.sin(2 * np.pi * f0 * (k + 1) * vib * t)
                for k in range(n_harm)
            )
            env = np.minimum(1, 20 * t) * np.minimum(1, 20 * (t[-1] - t + 1e-6))
            wav = (0.4 * wav / max(np.abs(wav).max(), 1e-6) * env
                   ).astype(np.float32) if voice == "rich" else (
                0.4 * wav * env).astype(np.float32)
            path = wav_dir / f"spk{s}_utt{u}.wav"
            wav_io.save_wav(path, wav, sr)
            items.append((str(path), sentences[u % len(sentences)], f"SPK{s}"))
    return generate_patterns(items, hp, out_dir / "patterns", "SYN", num_workers)


def main(argv=None) -> None:
    """``-lj <path>`` and / or ``-vctk <path>`` -> train and eval pattern
    directories under ``-out``."""
    import argparse

    from multi_speaker_tts_tpu_torch.hparams import load_hyper_parameters

    parser = argparse.ArgumentParser(description="Offline pattern generation")
    parser.add_argument("-hp", "--hyper_parameters", default=None)
    parser.add_argument("-lj", default=None, help="LJSpeech root directory")
    parser.add_argument("-vctk", default=None, help="VCTK root directory")
    parser.add_argument("-out", default=None, help="pattern output directory")
    parser.add_argument("-workers", type=int, default=None)
    parser.add_argument("-eval_ratio", type=float, default=0.01,
                        help="fraction of utterances held out for eval")
    args = parser.parse_args(argv)

    hp = load_hyper_parameters(args.hyper_parameters)
    items: list[tuple[str, str, str]] = []
    if args.lj:
        items += lj_info_load(args.lj)
    if args.vctk:
        items += vctk_info_load(args.vctk)
    if not items:
        parser.error("pass -lj and/or -vctk")
    print(f"found {len(items)} utterances")

    rng = np.random.default_rng(0)
    idx = rng.permutation(len(items))
    n_eval = max(1, int(len(items) * args.eval_ratio))
    eval_items = [items[i] for i in idx[:n_eval]]
    train_items = [items[i] for i in idx[n_eval:]]

    out = pathlib.Path(args.out) if args.out else pathlib.Path(
        hp.Train.Train_Pattern.Path
    ).parent
    meta_train = generate_patterns(
        train_items, hp, out / "train", "TTS", args.workers
    )
    meta_eval = generate_patterns(eval_items, hp, out / "eval", "TTS", args.workers)
    print(
        f"wrote {len(meta_train['Files'])} train / {len(meta_eval['Files'])} "
        f"eval patterns under {out}"
    )


if __name__ == "__main__":
    main()
