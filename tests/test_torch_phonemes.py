"""The port's phoneme front-end (``text/phonemes.py`` and the
``Tokens.Use_Phoneme`` dispatch in ``text/__init__.py``) against the JAX
package's: the inventory, the CMUdict reader, the letter-to-sound rules,
``phonemize`` and ``phoneme_text_to_sequence`` on every entry of the demo
lexicon, out-of-vocabulary words and punctuation, and ``vocab_size`` /
``encode_text`` under ``Use_Phoneme: true``."""

import pathlib

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu import text as jax_text
from multi_speaker_tts_tpu.hparams import default_hparams as jax_default_hparams
from multi_speaker_tts_tpu.text import phonemes as jax_ph
from multi_speaker_tts_tpu_torch import text as port_text
from multi_speaker_tts_tpu_torch.hparams import default_hparams
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
from multi_speaker_tts_tpu_torch.text import phonemes as port_ph

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
LEXICON = str(ROOT / "demo" / "corpus_lexicon.dict")
ENTRIES = [line.split()[0] for line in pathlib.Path(LEXICON).read_text().splitlines()
           if line.strip() and not line.startswith(";;;")]
OOV = ["xylophone", "knight", "phantasmagoria", "quickest", "mate", "bite", "hope",
       "tune", "thorough", "wrestle", "zzz", "ai", "dodge", "bureau"]
SENTENCES = [
    "Hello, Dr. Smith: 42 apples!",
    "  the  QUICK brown fox; 1999 ",
    "Wait -- what?! (It's fine.) Don't worry...",
    "A quick test of the xylophone; knights' armour.",
    "",
]


def test_inventory_matches_the_jax_package():
    assert port_ph.phoneme_symbols == jax_ph.phoneme_symbols
    assert port_ph.arpabet == jax_ph.arpabet
    assert (port_ph.PAD_ID, port_ph.EOS_ID) == (jax_ph.PAD_ID, jax_ph.EOS_ID)


def test_lexicon_reader_matches():
    port_ph.load_lexicon.cache_clear()
    assert port_ph.load_lexicon(LEXICON) == jax_ph.load_lexicon(LEXICON)
    assert len(port_ph.load_lexicon(LEXICON)) >= 30


@pytest.mark.parametrize("entry", ENTRIES)
def test_every_lexicon_entry_matches(entry):
    """Each line of the lexicon (alternates ``WORD(n)`` included, which the
    reader skips): the word phonemized through the lexicon and the token ids
    of the word in a sentence."""
    word = entry.lower().split("(")[0]
    lex = port_ph.load_lexicon(LEXICON)
    assert port_ph.phonemize(word, lex) == jax_ph.phonemize(word, jax_ph.load_lexicon(LEXICON))
    text = f"{word.capitalize()}, {word}!"
    np.testing.assert_array_equal(port_ph.phoneme_text_to_sequence(text, lexicon_path=LEXICON),
                                  jax_ph.phoneme_text_to_sequence(text, lexicon_path=LEXICON))


@pytest.mark.parametrize("word", OOV)
def test_letter_to_sound_rules_match(word):
    assert port_ph.g2p_fallback(word) == jax_ph.g2p_fallback(word)
    assert port_ph.g2p_fallback(word), word  # every OOV word gets phones


@pytest.mark.parametrize("lexicon", [None, LEXICON])
@pytest.mark.parametrize("text", SENTENCES)
def test_sentences_with_punctuation_and_oov_match(text, lexicon):
    got = port_ph.phoneme_text_to_sequence(text, lexicon_path=lexicon)
    want = jax_ph.phoneme_text_to_sequence(text, lexicon_path=lexicon)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got[-1] == port_ph.EOS_ID


@pytest.mark.parametrize("lexicon", [None, LEXICON])
def test_use_phoneme_dispatch_matches(lexicon):
    tokens = {"Use_Phoneme": True, **({"Phoneme_Lexicon": lexicon} if lexicon else {})}
    hp, hp_j = default_hparams(Tokens=tokens), jax_default_hparams().replace(Tokens=tokens)
    assert port_text.vocab_size(hp) == jax_text.vocab_size(hp_j) == len(jax_ph.phoneme_symbols)
    for s in SENTENCES:
        np.testing.assert_array_equal(port_text.encode_text(s, hp), jax_text.encode_text(s, hp_j))
    # Characters stay the default.
    assert port_text.vocab_size(default_hparams()) == len(port_text.symbols)


def test_tacotron_embeds_the_phoneme_vocabulary():
    hp = default_hparams(Tokens={"Use_Phoneme": True})
    with torch.device("meta"):
        taco = Tacotron(hp)
    assert taco.encoder.embedding.shape[0] == len(port_ph.phoneme_symbols)
