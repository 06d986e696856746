"""Batches of short texts for a synthesis cell, drawn from the run's seed.

The words are those of the training corpus: a frozen copy of the sentence
list of the port's synthetic corpus (``data/pattern_generator.py``), the
text the checkpoint was trained on. Batch ``i`` of a run is drawn from the
seed and ``i`` alone: its texts, their order and its speaker. Every batch
holds the same multiset of token counts (``batch`` counts spread evenly
over [``tokens_min``, ``tokens_max``], each count including the
end-of-sentence token), so every batch has the same buckets and every seed
asks for work of the same sizes. A text of n tokens is n - 1 characters of
the corpus's running words from a drawn start, cut there, a final space
made a period.
"""

from __future__ import annotations

import numpy as np

SENTENCES = [
    "the quick brown fox jumps over the lazy dog.",
    "she sells sea shells by the sea shore.",
    "a stitch in time saves nine.",
    "all that glitters is not gold.",
    "actions speak louder than words.",
    "the early bird catches the worm.",
    "practice makes perfect.",
    "better late than never.",
]
TIMED, WARMUP = 1, 2  # streams of a run's batches


def rng_for(seed: int, *keys: int) -> np.random.Generator:
    """A generator keyed by a seed of any size and further indices."""
    seed = int(seed)
    return np.random.default_rng([seed & 0xFFFFFFFF, (seed >> 32) & 0xFFFFFFFF, *keys])


def token_counts(params: dict) -> list[int]:
    lo, hi, n = params["tokens_min"], params["tokens_max"], params["batch"]
    return [int(round(lo + (hi - lo) * i / max(n - 1, 1))) for i in range(n)]


def one_text(rng: np.random.Generator, n_tokens: int) -> str:
    order = rng.permutation(len(SENTENCES))
    words = " ".join(SENTENCES[i] for i in np.concatenate([order] * (n_tokens // 20 + 2))).split()
    start = int(rng.integers(0, len(words) // 2))
    text = ""
    for w in words[start:]:
        text = w if not text else f"{text} {w}"
        if len(text) >= n_tokens - 1:
            break
    text = text[:n_tokens - 1]
    return text[:-1] + "." if text.endswith(" ") else text


def batch(seed: int, index: int, params: dict, stream: int = TIMED) -> dict:
    """Batch ``index`` of a run's ``stream`` -> {"texts": [...], "speaker":
    index into the cell's speakers}."""
    rng = rng_for(seed, stream, index)
    counts = rng.permutation(token_counts(params))
    return {"texts": [one_text(rng, int(n)) for n in counts],
            "speaker": int(rng.integers(params["speakers"]))}
