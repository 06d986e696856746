"""One request gives one answer: the port's ``Synthesizer`` draws each
call's prenet keep masks from a generator seeded with its ``seed`` at the
start of that call, as the JAX ``Synthesizer`` hands the same key to every
call. On the committed small checkpoint with its trained prenet dropout
(0.5) on the CPU: two equal ``synthesize`` calls, and two equal ``stream``
calls, give equal mel lengths and equal mels; the JAX ``Synthesizer`` does
the same, which states the reference semantics."""

import pathlib

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.hparams import Recursive_Parse as JaxRecursiveParse
from multi_speaker_tts_tpu.inference import Synthesizer as JaxSynthesizer
from multi_speaker_tts_tpu.train.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.inference import Synthesizer, prenet_mask_sampler

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "demo" / "serving_ckpt.msgpack"
WAVS = [str(ROOT / "demo" / "enroll_spk0_utt0.wav")]
TEXTS = ["hello world."]


@pytest.fixture(scope="module")
def ckpt():
    params, batch_stats, meta = load_compact(CKPT)
    assert float(meta["hp"]["Decoder"]["Prenet"]["Dropout_Rate"]) > 0
    return params, batch_stats, meta


@pytest.fixture(scope="module")
def port(ckpt):
    params, batch_stats, meta = ckpt
    synth = Synthesizer(Recursive_Parse(meta["hp"]), params, batch_stats, device="cpu")
    return synth, synth.enroll(WAVS)


def _mels(items):
    return [item["mel"] for item in items], [item["mel_length"] for item in items]


def test_synthesize_repeats(port):
    synth, emb = port
    first = _mels(synth.synthesize(TEXTS, emb, vocode=False))
    second = _mels(synth.synthesize(TEXTS, emb, vocode=False))
    assert first[1] == second[1]
    for a, b in zip(first[0], second[0]):
        np.testing.assert_array_equal(a, b)


def test_stream_repeats(port):
    synth, emb = port
    runs = [list(synth.stream(TEXTS, emb, segment_steps=16, return_mel=True))
            for _ in range(2)]
    assert len(runs[0]) == len(runs[1]) >= 1
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a["mel_lengths"], b["mel_lengths"])
        np.testing.assert_array_equal(a["mel_chunk"], b["mel_chunk"])


def test_masks_differ_across_steps_and_seeds(ckpt, port):
    """Within a call the masks still change from step to step, and another
    seed draws other masks."""
    synth, _ = port
    draw = synth._prenet_masks(2)
    step0, step1 = draw(0), draw(1)
    assert any(not torch.equal(a, b) for a, b in zip(step0, step1))
    params, batch_stats, meta = ckpt
    other = Synthesizer(Recursive_Parse(meta["hp"]), params, batch_stats, seed=1, device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(step0, other._prenet_masks(2)(0)))
    assert all(torch.equal(a, b) for a, b in zip(step0, synth._prenet_masks(2)(0)))


def test_jax_synthesize_repeats(ckpt):
    """The reference: the JAX ``Synthesizer`` passes one key to every call."""
    params, batch_stats, meta = ckpt
    jax_synth = JaxSynthesizer(JaxRecursiveParse(meta["hp"]), params, batch_stats)
    emb = jax_synth.enroll(WAVS)
    first = _mels(jax_synth.synthesize(TEXTS, emb, vocode=False))
    second = _mels(jax_synth.synthesize(TEXTS, emb, vocode=False))
    assert first[1] == second[1]
    for a, b in zip(first[0], second[0]):
        np.testing.assert_array_equal(a, b)


def test_sampler_keeps_each_step_for_the_call():
    """``prenet_mask_sampler(...)(t)`` is step t's draw whatever the order of
    the calls: a repeated call and an out-of-order call return the same
    tensors, equal to in-order draws from a fresh generator of the seed."""
    hp = Recursive_Parse({"Decoder": {"Prenet": {"Dropout_Rate": 0.5, "Sizes": [8, 4]}}})
    masks = prenet_mask_sampler(hp, torch.device("cpu"), 3, 2)
    third = masks(2)  # out of order: steps 0 and 1 are drawn first
    first = masks(0)
    assert all(a is b for a, b in zip(masks(2), third))
    assert all(a is b for a, b in zip(masks(0), first))
    g = torch.Generator().manual_seed(3)
    for t in range(4):
        want = [torch.rand((2, s), generator=g) < 0.5 for s in (8, 4)]
        got = masks(t)
        assert [m.shape for m in got] == [(2, 8), (2, 4)]
        assert all(torch.equal(a, b) for a, b in zip(got, want)), t
