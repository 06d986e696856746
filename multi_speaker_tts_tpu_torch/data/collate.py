"""Pad patterns to a training batch's static bucket shape (port of
``multi_speaker_tts_tpu.data.datasets.collate_tts``), in numpy.

A pattern is a dict with ``Tokens`` (int ids), ``Mel`` (T, mel) and,
optionally, ``Spect`` (T, spect) linear targets, ``Speaker_ID`` and
``Ref_Mel`` (the reference mel the GE2E crop is drawn from; ``Mel`` when
absent)."""

from __future__ import annotations

import numpy as np

from multi_speaker_tts_tpu_torch.text import PAD_ID


def collate_tts(patterns: list[dict], token_bucket: int, mel_bucket: int, mel_dim: int,
                n_frames_per_step: int = 1, ref_window: int | None = None,
                rng: np.random.Generator | list[np.random.Generator] | None = None,
                spect_dim: int | None = None) -> dict[str, np.ndarray]:
    """tokens (B, S) int32, token_lengths, mels (B, T, mel), mel_lengths
    (rounded down to a multiple of r), speaker_ids, and with ``ref_window`` a
    (B, window, mel) reference crop per item (a random window, or the clip
    wrap-padded when shorter), with ``spect_dim`` the linear targets.
    ``rng`` is one generator or one per item."""
    B = len(patterns)
    if mel_bucket % n_frames_per_step:
        raise ValueError(f"mel bucket {mel_bucket} is not a multiple of r = {n_frames_per_step}")
    tokens = np.full((B, token_bucket), PAD_ID, np.int32)
    mels = np.zeros((B, mel_bucket, mel_dim), np.float32)
    spects = np.zeros((B, mel_bucket, spect_dim), np.float32) if spect_dim else None
    token_lengths = np.zeros((B,), np.int32)
    mel_lengths = np.zeros((B,), np.int32)
    speaker_ids = np.zeros((B,), np.int32)
    refs = np.zeros((B, ref_window, mel_dim), np.float32) if ref_window else None
    rng = rng or np.random.default_rng()
    for i, p in enumerate(patterns):
        tk = p["Tokens"][:token_bucket]
        mel = p["Mel"][:mel_bucket]
        T = (mel.shape[0] // n_frames_per_step) * n_frames_per_step
        tokens[i, :len(tk)] = tk
        mels[i, :T] = mel[:T]
        if spects is not None:
            spects[i, :T] = p["Spect"][:T]
        token_lengths[i] = len(tk)
        mel_lengths[i] = T
        speaker_ids[i] = p.get("Speaker_ID", 0)
        if refs is not None:
            src = p.get("Ref_Mel", p["Mel"])
            r_i = rng[i] if isinstance(rng, list) else rng
            if src.shape[0] >= ref_window:
                start = int(r_i.integers(0, src.shape[0] - ref_window + 1))
                refs[i] = src[start:start + ref_window]
            else:
                refs[i] = np.pad(src, ((0, ref_window - src.shape[0]), (0, 0)), mode="wrap")
    batch = {"tokens": tokens, "token_lengths": token_lengths, "mels": mels,
             "mel_lengths": mel_lengths, "speaker_ids": speaker_ids}
    if refs is not None:
        batch["ref_mels"] = refs
    if spects is not None:
        batch["spects"] = spects
    return batch
