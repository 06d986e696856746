"""Streaming synthesis: the port's ``Synthesizer(device="cpu").stream``
against the JAX ``Synthesizer.stream`` on the committed small checkpoint
with its Conv linear head, f32, ``segment_steps=16`` (E = 32 frames at r = 2,
past the right halo Gr + Q + P = 3 + 2 + 6 = 11), with prenet dropout 0 and
once with dropout on and the JAX package's own keep masks handed to the
port; and the fused vocode, ``synthesize(split_vocode=False)``. The JAX
stream runs are module fixtures: their CPU compiles are the cost."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
WAVS = [str(ROOT / "demo" / "enroll_spk0_utt0.wav")]
TEXTS = ["hello world.", "the quick brown fox", "a b c"]
F32 = {"Train": {"Use_Mixed_Precision": False}}
NO_DROPOUT = dict(F32, Decoder={"Prenet": {"Dropout_Rate": 0.0}})
# f32 on both sides: mel blocks differ by summation order (~1e-6 measured);
# each window's 60 Griffin-Lim iterations carry that to below 1e-3 of the
# stream's peak (7.6e-4 of one chunk's peak measured, the first chunk). With
# the warm start each window starts from the previous window's converged
# audio, so the windows' differences chain: 2.0e-3 of the peak measured.
MEL_TOL, WAV_REL_TOL, WARM_WAV_REL_TOL = 1e-4, 1e-3, 5e-3
# The fused vocode runs Griffin-Lim over the whole 256-frame decode bucket
# (the split vocode over 64 frames): 1.35e-3 of the peak measured.
FUSED_WAV_REL_TOL = 3e-3


def _pair(overrides):
    params, batch_stats, meta = load_compact(CKPT)
    return (JaxSynthesizer(JaxRecursiveParse(meta["hp"]).replace(**overrides), params,
                           batch_stats),
            Synthesizer(Recursive_Parse(meta["hp"]).replace(**overrides), params, batch_stats,
                        device="cpu"))


@pytest.fixture(scope="module")
def pair():
    jax_synth, port = _pair(NO_DROPOUT)
    return jax_synth, port, jax_synth.enroll(WAVS)


@pytest.fixture(scope="module")
def streams(pair):
    """{warm start: (JAX chunks, port chunks)}."""
    jax_synth, port, emb = pair
    return {warm: (list(jax_synth.stream(TEXTS, emb, segment_steps=16, return_mel=True,
                                         gl_warm_start=warm)),
                   list(port.stream(TEXTS, emb, segment_steps=16, return_mel=True,
                                    gl_warm_start=warm)))
            for warm in (False, True)}


def _jax_keep_masks(jax_synth, batch):
    """The JAX stream's own prenet draws: the decoder's ``make_rng("prenet")``
    key under the synthesizer's rng, folded with the global step t and split
    per prenet layer (``decoder_scan.decoder_ar_segment``, ``prenet_apply``)."""
    taco = jax_synth.models.tacotron
    key = taco.apply({"params": jax_synth.params["tacotron"],
                      "batch_stats": jax_synth.batch_stats["tacotron"]},
                     method=lambda m: m.frame_decoder.make_rng("prenet"),
                     rngs={"prenet": jax_synth.rng})
    rate = float(jax_synth.hp.Decoder.Prenet.Dropout_Rate)
    sizes = list(jax_synth.hp.Decoder.Prenet.Sizes)

    @functools.lru_cache(maxsize=None)
    def masks(t):
        keys = jax.random.split(jax.random.fold_in(key, t), len(sizes))
        return [torch.from_numpy(np.array(jax.random.bernoulli(k, 1.0 - rate, (batch, s))))
                for k, s in zip(keys, sizes)]

    return masks


def _check_streams(want, got, wav_rel=WAV_REL_TOL):
    assert len(got) == len(want) >= 2
    peak = max(np.abs(c["wav_chunk"]).max() for c in want)
    for w, g in zip(want, got):
        assert g["frame_offset"] == w["frame_offset"] and g["done"] == w["done"]
        np.testing.assert_array_equal(g["mel_lengths"], w["mel_lengths"])
        assert g["mel_chunk"].shape == w["mel_chunk"].shape
        assert np.abs(g["mel_chunk"] - w["mel_chunk"]).max() <= MEL_TOL
        assert g["wav_chunk"].shape == w["wav_chunk"].shape and g["wav_chunk"].dtype == np.float32
        assert np.abs(g["wav_chunk"] - w["wav_chunk"]).max() <= wav_rel * peak


@pytest.mark.parametrize("warm", [False, True], ids=["crossfade", "warm_start"])
def test_stream_matches_jax(streams, warm):
    _check_streams(*streams[warm], wav_rel=WARM_WAV_REL_TOL if warm else WAV_REL_TOL)


def test_stream_mel_equals_synthesize(pair, streams):
    _, port, emb = pair
    chunks = streams[False][1]
    mel = np.concatenate([c["mel_chunk"] for c in chunks], axis=1)
    for b, item in enumerate(port.synthesize(TEXTS, emb)):
        T = item["mel_length"]
        assert chunks[-1]["mel_lengths"][b] == T
        np.testing.assert_array_equal(mel[b, :T], item["mel"])
        assert not mel[b, T:].any()  # past the decoded length the block is masked


def test_stream_with_jax_drawn_prenet_masks():
    """Prenet dropout on (the checkpoint's 0.5): the port's decode takes the
    JAX stream's own keep masks at each global step."""
    jax_synth, port = _pair(F32)
    emb = jax_synth.enroll(WAVS)
    want = list(jax_synth.stream(TEXTS, emb, segment_steps=16, return_mel=True))
    masks = _jax_keep_masks(jax_synth, 4)
    port._prenet_masks = lambda batch: masks
    got = list(port.stream(TEXTS, emb, segment_steps=16, return_mel=True))
    _check_streams(want, got)


def test_stream_pcm16_and_chunk_shapes(pair, streams):
    _, port, emb = pair
    chunks = list(port.stream(TEXTS[:1], emb, segment_steps=16, pcm16=True))
    assert all(c["wav_chunk"].dtype == np.int16 and c["wav_chunk"].shape == (1, 32 * 256)
               for c in chunks)
    assert all("mel_chunk" not in c for c in chunks)
    floats = streams[False][1]
    assert [c["frame_offset"] for c in floats] == [32 * i for i in range(len(floats))]


def test_stream_respects_max_steps_cap(pair):
    """The streaming bucket rounds up to whole segments; decoded lengths stay
    within the caller's max_steps (48 frames -> 24 steps, a 32-step bucket)."""
    _, port, emb = pair
    chunks = list(port.stream(TEXTS[1:2], emb, max_steps=48, segment_steps=16))
    assert chunks[-1]["done"] and chunks[-1]["mel_lengths"].max() <= 48
    assert port.last_decode_bucket == 48


def test_stream_under_the_decode_kernel_modes_matches_synthesize(pair):
    """``int8_pallas`` on the CPU: the decode kernel's plain version runs the
    segments, and the streamed mel equals the batched one."""
    params, batch_stats, meta = load_compact(CKPT)
    port = Synthesizer(Recursive_Parse(meta["hp"]).replace(**NO_DROPOUT), params, batch_stats,
                       device="cpu", quantize="int8_pallas")
    emb = pair[2]
    chunks = list(port.stream(TEXTS, emb, segment_steps=16, return_mel=True))
    mel = np.concatenate([c["mel_chunk"] for c in chunks], axis=1)
    for b, item in enumerate(port.synthesize(TEXTS, emb)):
        T = item["mel_length"]
        assert chunks[-1]["mel_lengths"][b] == T
        assert np.abs(mel[b, :T] - item["mel"]).max() <= 1e-5


def test_stream_refuses_cbhg_and_short_segments(pair):
    from multi_speaker_tts_tpu_torch.models.cbhg import CBHGHead

    _, port, emb = pair
    # The small checkpoint holds Conv head weights: a CBHG model without its
    # weights, as the JAX package's own test builds one.
    port_cbhg = Synthesizer.__new__(Synthesizer)
    port_cbhg.hp = port.hp.replace(Linear_Head={"Type": "CBHG"})
    port_cbhg.tacotron = torch.nn.Module()
    port_cbhg.tacotron.linear_head = CBHGHead.__new__(CBHGHead)
    with pytest.raises(NotImplementedError, match="CBHG"):
        next(port_cbhg.stream(["x"], emb))
    with pytest.raises(ValueError, match="segment too short"):
        next(port.stream(["hello"], emb, segment_steps=4))


def test_stream_postnet_linear_matches_jax(pair):
    """The boundary-masked postnet and Conv head on one window."""
    jax_synth, port, _ = pair
    rng = np.random.default_rng(6)
    win = rng.random((2, 40, 80)).astype(np.float32)
    bm = np.ones((2, 40), np.float32)
    bm[:, :7] = 0.0
    bm[1, 33:] = 0.0
    taco = jax_synth.models.tacotron
    want = taco.apply({"params": jax_synth.params["tacotron"],
                       "batch_stats": jax_synth.batch_stats["tacotron"]},
                      jnp.asarray(win), jnp.asarray(bm), method=taco.stream_postnet_linear)
    got = port.tacotron.stream_postnet_linear(torch.from_numpy(win), torch.from_numpy(bm))
    for w, g in zip(want, got):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4
    unmasked = port.tacotron.stream_postnet_linear(torch.from_numpy(win))[0]
    assert not torch.allclose(unmasked, got[0])


# -- fused vocode ---------------------------------------------------------------
def test_fused_vocode_matches_jax(pair):
    """``split_vocode=False`` vocodes the whole decode bucket, as JAX's fused
    program: equal lengths, wavs within FUSED_WAV_REL_TOL of their peak; and
    unlike the split vocode, whose Griffin-Lim sees a shorter bucket."""
    jax_synth, port, emb = pair
    want = jax_synth.synthesize(TEXTS, emb, split_vocode=False)
    got = port.synthesize(TEXTS, emb, split_vocode=False)
    split = port.synthesize(TEXTS, emb)
    for w, g, s in zip(want, got, split):
        assert g["mel_length"] == w["mel_length"]
        assert g["wav"].shape == w["wav"].shape == s["wav"].shape
        assert np.abs(g["wav"] - w["wav"]).max() <= FUSED_WAV_REL_TOL * np.abs(w["wav"]).max()
    assert any(not np.array_equal(g["wav"], s["wav"]) for g, s in zip(got, split))
    assert all("wav" not in item for item in port.synthesize(TEXTS[:1], emb, vocode=False))
