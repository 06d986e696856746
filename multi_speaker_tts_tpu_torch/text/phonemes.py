"""Phoneme front-end (the port's own copy of ``multi_speaker_tts_tpu.text.phonemes``;
numpy and ``re`` only): the ``Tokens.Use_Phoneme`` pipeline.

ARPAbet inventory (CMUdict convention): 39 phones, vowels carrying 0/1/2
stress markers. Text is phonemized word-by-word through

1. a user-supplied CMUdict-format lexicon (``Tokens.Phoneme_Lexicon`` path),
   the accurate path - the reference family relies on an external
   phonemizer, which is also data the user supplies; and
2. a compact deterministic letter-to-sound fallback for OOV words (digraph
   rules + single-letter defaults), so the pipeline never hard-fails on
   unseen vocabulary.

Punctuation and word boundaries are kept as their own symbols (space
comma/period etc.), mirroring keithito-style phoneme pipelines.
"""

from __future__ import annotations

import functools
import re

import numpy as np

PAD = "_"
EOS = "~"
_punctuation = list(" !'(),-.:;?")

_VOWELS = [
    "AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY", "IH", "IY",
    "OW", "OY", "UH", "UW",
]
_CONSONANTS = [
    "B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M", "N", "NG",
    "P", "R", "S", "SH", "T", "TH", "V", "W", "Y", "Z", "ZH",
]

arpabet: list[str] = [
    f"{v}{s}" for v in _VOWELS for s in (0, 1, 2)
] + _CONSONANTS

# Phoneme symbols are prefixed with '@' in the joint table so they can never
# collide with literal characters.
phoneme_symbols: list[str] = [PAD, EOS] + _punctuation + [f"@{p}" for p in arpabet]

_phoneme_to_id = {s: i for i, s in enumerate(phoneme_symbols)}

PAD_ID = _phoneme_to_id[PAD]
EOS_ID = _phoneme_to_id[EOS]


# --- rule-based letter-to-sound fallback (OOV words) -----------------------

# Multi-letter rules, longest-match-first within each starting letter.
_DIGRAPH_RULES: list[tuple[str, list[str]]] = [
    ("tion", ["SH", "AH0", "N"]),
    ("sion", ["ZH", "AH0", "N"]),
    ("ough", ["OW1"]),
    ("igh", ["AY1"]),
    ("dge", ["JH"]),
    ("tch", ["CH"]),
    ("eau", ["OW1"]),
    ("ai", ["EY1"]),
    ("ay", ["EY1"]),
    ("au", ["AO1"]),
    ("aw", ["AO1"]),
    ("ar", ["AA1", "R"]),
    ("ch", ["CH"]),
    ("ck", ["K"]),
    ("ea", ["IY1"]),
    ("ee", ["IY1"]),
    ("er", ["ER0"]),
    ("ew", ["UW1"]),
    ("gh", ["G"]),
    ("ir", ["ER1"]),
    ("kn", ["N"]),
    ("ng", ["NG"]),
    ("oa", ["OW1"]),
    ("oi", ["OY1"]),
    ("oo", ["UW1"]),
    ("or", ["AO1", "R"]),
    ("ou", ["AW1"]),
    ("ow", ["OW1"]),
    ("oy", ["OY1"]),
    ("ph", ["F"]),
    ("qu", ["K", "W"]),
    ("sh", ["SH"]),
    ("th", ["TH"]),
    ("ur", ["ER1"]),
    ("wh", ["W"]),
    ("wr", ["R"]),
]

_SINGLE_RULES: dict[str, list[str]] = {
    "a": ["AE1"], "b": ["B"], "c": ["K"], "d": ["D"], "e": ["EH1"],
    "f": ["F"], "g": ["G"], "h": ["HH"], "i": ["IH1"], "j": ["JH"],
    "k": ["K"], "l": ["L"], "m": ["M"], "n": ["N"], "o": ["AA1"],
    "p": ["P"], "q": ["K"], "r": ["R"], "s": ["S"], "t": ["T"],
    "u": ["AH1"], "v": ["V"], "w": ["W"], "x": ["K", "S"], "y": ["Y"],
    "z": ["Z"],
}


def g2p_fallback(word: str) -> list[str]:
    """Deterministic rule-based grapheme->phoneme for OOV words."""
    word = word.lower()
    # Final magic-e: lengthen the last vowel, drop the e (mate -> M EY1 T).
    magic_e = bool(re.search(r"[aeiou][bcdfgklmnprstvz]e$", word))
    if magic_e:
        word = word[:-1]
    phones: list[str] = []
    i = 0
    while i < len(word):
        for pat, out in _DIGRAPH_RULES:
            if word.startswith(pat, i):
                phones.extend(out)
                i += len(pat)
                break
        else:
            phones.extend(_SINGLE_RULES.get(word[i], []))
            i += 1
    if magic_e:
        long_of = {"AE1": "EY1", "IH1": "AY1", "AA1": "OW1", "EH1": "IY1",
                   "AH1": "UW1"}
        for j in range(len(phones) - 1, -1, -1):
            if phones[j] in long_of:
                phones[j] = long_of[phones[j]]
                break
    return phones


@functools.lru_cache(maxsize=4)
def load_lexicon(path: str) -> dict:
    """CMUdict-format lexicon: ``WORD  P1 P2 ...`` per line; ``WORD(2)``
    alternates are skipped (first pronunciation wins)."""
    lex: dict[str, list[str]] = {}
    with open(path, encoding="utf-8", errors="ignore") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith(";;;"):
                continue
            parts = line.split()
            word = parts[0].lower()
            if "(" in word:
                continue
            lex.setdefault(word, parts[1:])
    return lex


_word_re = re.compile(r"[a-z']+|[^a-z'\s]|\s")


def phonemize(text: str, lexicon: dict | None = None) -> list[str]:
    """Cleaned text -> symbol list: '@'-prefixed phones, plus punctuation
    and single spaces as word boundaries."""
    out: list[str] = []
    for tok in _word_re.findall(text):
        if tok.isspace():
            if out and out[-1] != " ":
                out.append(" ")
        elif re.fullmatch(r"[a-z']+", tok):
            word = tok.replace("'", "")
            phones = (lexicon or {}).get(word) or g2p_fallback(word)
            out.extend(f"@{p}" for p in phones if f"@{p}" in _phoneme_to_id)
        elif tok in _phoneme_to_id:
            out.append(tok)
    return out


def phoneme_text_to_sequence(
    text: str,
    cleaners=("english_cleaners",),
    lexicon_path: str | None = None,
    append_eos: bool = True,
) -> np.ndarray:
    """Raw text -> int32 phoneme token ids (the Use_Phoneme pipeline)."""
    from multi_speaker_tts_tpu_torch.text import clean_text

    cleaned = clean_text(text, cleaners)
    lexicon = load_lexicon(lexicon_path) if lexicon_path else None
    ids = [_phoneme_to_id[s] for s in phonemize(cleaned, lexicon)]
    if append_eos:
        ids.append(EOS_ID)
    return np.asarray(ids, dtype=np.int32)
