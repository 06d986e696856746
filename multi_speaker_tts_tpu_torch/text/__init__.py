"""Text front-end (the port's own copy of ``multi_speaker_tts_tpu.text``).

Symbol table + cleaners + text->token-id conversion: the keithito-style
character pipeline, and under ``Tokens.Use_Phoneme`` the phoneme pipeline
of :mod:`.phonemes`. The symbol inventory is the
classic English TTS set: pad, EOS, punctuation, and lowercase letters.
"""

from __future__ import annotations

import re

import numpy as np

PAD = "_"
EOS = "~"
_punctuation = " !'(),-.:;?"
_letters = "abcdefghijklmnopqrstuvwxyz"

symbols: list[str] = [PAD, EOS] + list(_punctuation) + list(_letters)

_symbol_to_id = {s: i for i, s in enumerate(symbols)}
_id_to_symbol = {i: s for i, s in enumerate(symbols)}

PAD_ID = _symbol_to_id[PAD]
EOS_ID = _symbol_to_id[EOS]


_abbreviations = [
    (re.compile(rf"\b{abbr}\.", re.IGNORECASE), expansion)
    for abbr, expansion in [
        ("mrs", "misess"),
        ("mr", "mister"),
        ("dr", "doctor"),
        ("st", "saint"),
        ("co", "company"),
        ("jr", "junior"),
        ("maj", "major"),
        ("gen", "general"),
        ("drs", "doctors"),
        ("rev", "reverend"),
        ("lt", "lieutenant"),
        ("hon", "honorable"),
        ("sgt", "sergeant"),
        ("capt", "captain"),
        ("esq", "esquire"),
        ("ltd", "limited"),
        ("col", "colonel"),
        ("ft", "fort"),
    ]
]

_whitespace_re = re.compile(r"\s+")

_units = [
    "zero", "one", "two", "three", "four", "five", "six", "seven", "eight",
    "nine", "ten", "eleven", "twelve", "thirteen", "fourteen", "fifteen",
    "sixteen", "seventeen", "eighteen", "nineteen",
]
_tens = [
    "", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
    "eighty", "ninety",
]


def _number_to_words(n: int) -> str:
    if n < 0:
        return "minus " + _number_to_words(-n)
    if n < 20:
        return _units[n]
    if n < 100:
        return _tens[n // 10] + ("" if n % 10 == 0 else " " + _units[n % 10])
    if n < 1000:
        rest = n % 100
        return (
            _units[n // 100] + " hundred" + ("" if rest == 0 else " " + _number_to_words(rest))
        )
    for value, name in [(10**9, "billion"), (10**6, "million"), (10**3, "thousand")]:
        if n >= value:
            rest = n % value
            return (
                _number_to_words(n // value)
                + f" {name}"
                + ("" if rest == 0 else " " + _number_to_words(rest))
            )
    return str(n)


_number_re = re.compile(r"\d+")


def expand_numbers(text: str) -> str:
    return _number_re.sub(lambda m: _number_to_words(int(m.group(0))), text)


def expand_abbreviations(text: str) -> str:
    for pattern, expansion in _abbreviations:
        text = pattern.sub(expansion, text)
    return text


def collapse_whitespace(text: str) -> str:
    return _whitespace_re.sub(" ", text).strip()


def basic_cleaners(text: str) -> str:
    return collapse_whitespace(text.lower())


def english_cleaners(text: str) -> str:
    """Lowercase, expand abbreviations and numbers, strip non-symbols."""
    text = text.lower()
    text = expand_abbreviations(text)
    text = expand_numbers(text)
    text = "".join(c for c in text if c in _symbol_to_id or c.isspace())
    return collapse_whitespace(text)


_CLEANERS = {
    "basic_cleaners": basic_cleaners,
    "english_cleaners": english_cleaners,
}


def clean_text(text: str, cleaners: list[str] | tuple[str, ...] = ("english_cleaners",)) -> str:
    for name in cleaners:
        if name not in _CLEANERS:
            raise ValueError(f"Unknown cleaner '{name}'; available: {sorted(_CLEANERS)}")
        text = _CLEANERS[name](text)
    return text


def text_to_sequence(
    text: str,
    cleaners: list[str] | tuple[str, ...] = ("english_cleaners",),
    append_eos: bool = True,
) -> np.ndarray:
    """Text -> int32 token ids (reference's ``Text_to_Token``)."""
    cleaned = clean_text(text, cleaners)
    ids = [_symbol_to_id[c] for c in cleaned if c in _symbol_to_id]
    if append_eos:
        ids.append(EOS_ID)
    return np.asarray(ids, dtype=np.int32)


def sequence_to_text(ids) -> str:
    return "".join(_id_to_symbol[int(i)] for i in ids if int(i) in _id_to_symbol)


# --- hp-driven dispatch: characters vs phonemes (Tokens.Use_Phoneme) -------

def vocab_size(hp) -> int:
    """Token-embedding vocabulary for the configured front-end."""
    if hp.Tokens.get("Use_Phoneme", False):
        from multi_speaker_tts_tpu_torch.text.phonemes import phoneme_symbols

        return len(phoneme_symbols)
    return len(symbols)


def encode_text(text: str, hp) -> np.ndarray:
    """Raw text -> token ids under hp's front-end config: characters, or
    with ``Tokens.Use_Phoneme`` ARPAbet phonemes (``Tokens.Phoneme_Lexicon``
    a CMUdict-format file, the rules for other words)."""
    cleaners = hp.Tokens.get("Cleaners", ("english_cleaners",))
    if hp.Tokens.get("Use_Phoneme", False):
        from multi_speaker_tts_tpu_torch.text.phonemes import phoneme_text_to_sequence

        return phoneme_text_to_sequence(text, cleaners, hp.Tokens.get("Phoneme_Lexicon"))
    return text_to_sequence(text, cleaners)
