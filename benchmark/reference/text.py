"""The text front end the checkpoint was trained with: the keithito-style
English character set (pad, EOS, punctuation, lowercase letters), text ->
ids with an EOS appended. The benchmark's texts are lowercase words,
spaces and periods, so of the cleaners only lowercasing and collapsing
whitespace act on them; anything else is refused."""

from __future__ import annotations

import re

PAD, EOS = "_", "~"
SYMBOLS = [PAD, EOS] + list(" !'(),-.:;?") + list("abcdefghijklmnopqrstuvwxyz")
_ID = {s: i for i, s in enumerate(SYMBOLS)}
PAD_ID, EOS_ID = _ID[PAD], _ID[EOS]


def encode(text: str) -> list[int]:
    cleaned = re.sub(r"\s+", " ", text.lower()).strip()
    bad = sorted({c for c in cleaned if c not in _ID})
    if bad:
        raise ValueError(f"characters outside the plain symbol set: {bad}")
    return [_ID[c] for c in cleaned] + [EOS_ID]
