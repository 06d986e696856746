"""End to end: the port's ``Synthesizer(device="cpu")`` against the JAX
``Synthesizer`` on the committed small checkpoint, f32
(``Use_Mixed_Precision: false``) and with prenet dropout 0 on both sides, so
the comparison is deterministic: first mel-only (``Linear_Head.Use:
false``, the pseudo-inverse vocoder branch), then the checkpoint as it is
(Conv linear head on, the linear branch), plain and with ``quantize="int8"``
on both sides."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.audio import wav_io as jwav_io
from multi_speaker_tts_tpu.hparams import Recursive_Parse as JaxRecursiveParse
from multi_speaker_tts_tpu.inference import Synthesizer as JaxSynthesizer
from multi_speaker_tts_tpu.train.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.inference import Synthesizer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "demo" / "serving_ckpt.msgpack"
WAVS = [str(ROOT / "demo" / f) for f in ("enroll_spk0_utt0.wav", "enroll_spk0_utt1.wav")]
TEXTS = ["hello world.", "the quick brown fox", "a b c"]
OVERRIDES = dict(
    Linear_Head={"Use": False},
    Train={"Use_Mixed_Precision": False},
    Decoder={"Prenet": {"Dropout_Rate": 0.0}},
)
# f32 on both sides: the embedding and the decoded mel differ by summation
# order only (~1e-6 measured); Griffin-Lim's 60 iterations carry that to
# ~1e-4 of a peak of ~3 in the waveform.
EMB_TOL, MEL_TOL, WAV_REL_TOL = 1e-5, 1e-4, 1e-3


@pytest.fixture(scope="module")
def pair():
    params, batch_stats, meta = load_compact(CKPT)
    jax_synth = JaxSynthesizer(JaxRecursiveParse(meta["hp"]).replace(**OVERRIDES),
                               params, batch_stats)
    port = Synthesizer(Recursive_Parse(meta["hp"]).replace(**OVERRIDES),
                       params, batch_stats, device="cpu")
    return jax_synth, port


@pytest.fixture(scope="module")
def embeddings(pair):
    jax_synth, port = pair
    return jax_synth.enroll(WAVS), port.enroll(WAVS)


def test_ge2e_embed_utterance_matches(pair):
    """Windows, the true-length window mask and the tail-clamped window,
    on a mel whose padding the mask must ignore."""
    jax_synth, port = pair
    rng = np.random.default_rng(2)
    mel = rng.random((2, 120, 80)).astype(np.float32)
    true_frames = np.asarray([120, 70], np.int32)
    ge2e = jax_synth.models.ge2e
    want = np.asarray(ge2e.apply({"params": jax_synth.params["ge2e"]}, jnp.asarray(mel),
                                 48, 24, None, jnp.asarray(true_frames),
                                 method=ge2e.embed_utterance))
    with torch.no_grad():
        got = port.ge2e.embed_utterance(torch.from_numpy(mel), 48, 24,
                                        torch.from_numpy(true_frames)).numpy()
    assert got.shape == want.shape == (2, 64)
    assert np.abs(got - want).max() <= EMB_TOL


def test_enroll_matches(embeddings):
    want, got = embeddings
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= EMB_TOL
    assert abs(np.linalg.norm(got) - 1.0) < 1e-5


def test_enroll_accepts_arrays(pair, embeddings):
    _, port = pair
    wav = jwav_io.load_wav(WAVS[1], target_sr=22050)[0]
    np.testing.assert_allclose(port.enroll(wav), port.enroll(WAVS[1]), atol=1e-7)


@pytest.fixture(scope="module")
def outputs(pair, embeddings):
    jax_synth, port = pair
    emb = embeddings[0]
    want = jax_synth.synthesize(TEXTS, emb, return_linear=False, pcm16=False)
    got = port.synthesize(TEXTS, emb, pcm16=False)
    return want, got


def test_synthesize_mel_lengths_equal(outputs, pair):
    want, got = outputs
    assert [o["mel_length"] for o in got] == [o["mel_length"] for o in want]
    assert pair[1].last_decode_bucket == pair[0].last_decode_bucket


def test_synthesize_mel_and_alignment_match(outputs):
    for w, g in zip(*outputs):
        assert g["mel"].shape == w["mel"].shape
        assert np.abs(g["mel"] - w["mel"]).max() <= MEL_TOL
        assert g["alignment"].shape == w["alignment"].shape
        assert np.abs(g["alignment"] - w["alignment"]).max() <= MEL_TOL


def test_synthesize_wav_matches(outputs):
    for w, g in zip(*outputs):
        assert g["wav"].shape == w["wav"].shape and g["wav"].dtype == np.float32
        assert np.abs(g["wav"] - w["wav"]).max() <= WAV_REL_TOL * np.abs(w["wav"]).max()


def test_synthesize_pcm16(pair, embeddings, outputs):
    jax_synth, port = pair
    want = jax_synth.synthesize(TEXTS[:1], embeddings[0], return_linear=False, pcm16=True)
    got = port.synthesize(TEXTS[:1], embeddings[0], pcm16=True)
    assert got[0]["wav"].dtype == want[0]["wav"].dtype == np.int16
    assert got[0]["wav"].shape == want[0]["wav"].shape
    # One count of 16-bit PCM is 1/32767 = 3.1e-5; the float wavs of this
    # utterance agree to ~6e-5 (measured), so <= 5 counts leaves room for
    # 1e-4 of float difference plus one count of rounding.
    assert np.abs(got[0]["wav"].astype(int) - want[0]["wav"].astype(int)).max() <= 5


# -- the checkpoint as it is: Conv linear head on ------------------------------
HEAD_OVERRIDES = {k: v for k, v in OVERRIDES.items() if k != "Linear_Head"}
LINEAR_TOL = 1e-4  # f32 on both sides, as the mel
# int8 gates on both sides: equal integer sums, so steps differ by f32
# summation order until a last-bit difference flips an activation rounding;
# over the 10-33 decoded steps that stays within the K-step bound of the
# decode-segment tests (measured: mel 3.2e-4, linear 7.8e-5).
INT8_MEL_TOL = 3e-3


@pytest.fixture(scope="module", params=[None, "int8"], ids=["plain", "int8"])
def head_outputs(request, embeddings):
    params, batch_stats, meta = load_compact(CKPT)
    jax_synth = JaxSynthesizer(JaxRecursiveParse(meta["hp"]).replace(**HEAD_OVERRIDES),
                               params, batch_stats, quantize=request.param)
    port = Synthesizer(Recursive_Parse(meta["hp"]).replace(**HEAD_OVERRIDES),
                       params, batch_stats, device="cpu", quantize=request.param)
    assert port.tacotron.decoder.quantize_int8 == (request.param == "int8")
    emb = embeddings[0]
    return (request.param, jax_synth.synthesize(TEXTS, emb, pcm16=False),
            port.synthesize(TEXTS, emb, pcm16=False))


def test_synthesize_with_the_linear_head_matches(head_outputs):
    mode, want, got = head_outputs
    assert [o["mel_length"] for o in got] == [o["mel_length"] for o in want]
    mel_tol, lin_tol = (MEL_TOL, LINEAR_TOL) if mode is None else (INT8_MEL_TOL, INT8_MEL_TOL)
    for w, g in zip(want, got):
        assert g["mel"].shape == w["mel"].shape
        assert np.abs(g["mel"] - w["mel"]).max() <= mel_tol
        assert g["linear"].shape == w["linear"].shape == (w["mel_length"], 513)
        assert np.abs(g["linear"] - w["linear"]).max() <= lin_tol


def test_synthesize_wav_through_the_linear_branch_matches(head_outputs):
    mode, want, got = head_outputs
    # The int8 decodes' mels differ by up to INT8_MEL_TOL; Griffin-Lim's 60
    # iterations carry that to 1.2% of the waveform's peak (measured).
    rel = WAV_REL_TOL if mode is None else 5e-2
    for w, g in zip(want, got):
        assert g["wav"].shape == w["wav"].shape and g["wav"].dtype == np.float32
        assert np.abs(g["wav"] - w["wav"]).max() <= rel * np.abs(w["wav"]).max()


def test_return_linear_false_and_unknown_quantize(pair, embeddings):
    params, batch_stats, meta = load_compact(CKPT)
    hp = Recursive_Parse(meta["hp"]).replace(**HEAD_OVERRIDES)
    port = Synthesizer(hp, params, batch_stats, device="cpu")
    out = port.synthesize(TEXTS[:1], embeddings[0], return_linear=False)
    assert "linear" not in out[0] and out[0]["wav"].size > 0
    with pytest.raises(ValueError, match="unknown quantize mode"):
        Synthesizer(hp, params, batch_stats, device="cpu", quantize="int4")
    for mode, key, value in (("int8_pallas", "Pallas_Decode", True),
                             ("bf16_pallas", "Pallas_Decode", "bf16"),
                             ("int8", "Quantize_Int8", True)):
        synth = Synthesizer(hp, params, batch_stats, device="cpu", quantize=mode)
        assert synth.hp.Decoder.get(key) == value
