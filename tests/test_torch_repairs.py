"""Three repairs of the port against the JAX package, on the CPU.

- ``Synthesizer.synthesize`` and ``stream`` take their arguments in the JAX
  order: a positional call binds the same parameters in both packages, and
  the port runs it (``vocode`` fourth; ``sharded``, ``pad_batch`` and
  ``return_device`` in their places, each run past its default).
- ``dsp.melspectrogram_auto`` routes by the JAX rule: a batched wav whose
  length hop divides, with hop dividing n_fft, to the fused front-end (its
  kernel on the card, its plain version here); every other input to the
  FFT route, equal to the JAX package's rfft route within 1e-4. An eligible
  frame whose n_fft is not a power of two goes to the kernel's DFT route:
  ``mel_shape_reason`` takes every eligible frame of n_fft 256-4096.
- The decode kernel's wrapper takes any batch: groups of at most 16 rows,
  one launch each a chunk, their outputs joined in row order; with the
  launch replaced by the plain version the joined result equals one plain
  call over the whole batch.
"""

import inspect
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu import inference as jinference
from multi_speaker_tts_tpu.audio import dsp as jdsp
from multi_speaker_tts_tpu_torch import inference
from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.ops import mel_kernel
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("method, args", [
    ("synthesize", (["a b."], "EMB", 32, False, False, [1], True, True, False, True, False, False)),
    ("stream", (["a b."], "EMB", [1], 32, 8, 4, True, True, False)),
])
def test_positional_calls_bind_as_in_jax(method, args):
    port = inspect.signature(getattr(inference.Synthesizer, method)).bind(None, *args)
    jax_ = inspect.signature(getattr(jinference.Synthesizer, method)).bind(None, *args)
    assert dict(port.arguments) == dict(jax_.arguments)


@pytest.fixture(scope="module")
def synth():
    return inference.Synthesizer.from_compact(str(ROOT / "demo" / "serving_ckpt.msgpack"),
                                              device="cpu")


def test_positional_synthesize_runs_in_the_jax_order(synth):
    emb = synth.enroll(str(ROOT / "demo" / "enroll_spk0_utt0.wav"))
    out = synth.synthesize(["hello world."], emb, 24, False)[0]  # vocode=False
    assert "wav" not in out and out["mel_length"] > 0
    chunks = list(synth.stream(["hello world."], emb, None, 24, 8))
    assert chunks and all("wav_chunk" in c for c in chunks)
    # sharded (no mesh: nothing to shard), pad_batch and return_device in
    # their places: each runs, and decodes what the default call decodes.
    for pos, name in ((4, "sharded"), (7, "pad_batch"), (11, "return_device")):
        args = [["hello world."], emb, 24, False, False, None, True, True, True, False, True, False]
        args[pos] = not args[pos]
        got = synth.synthesize(*args)
        if name == "return_device":
            assert isinstance(got, dict) and got["mel_post"].shape[1] == 24
            assert int(got["mel_lengths"][0]) == out["mel_length"]
            np.testing.assert_array_equal(got["mel_post"][0, :out["mel_length"]].numpy(),
                                          out["mel"])
        else:
            assert got[0]["mel_length"] == out["mel_length"]
            np.testing.assert_array_equal(got[0]["mel"], out["mel"])


def _cfg(n_fft, hop):
    return dsp.DSPConfig(16000, n_fft, hop, 16, 0.0, None, 0.97, -100.0, 20.0, 1.5, 8)


@pytest.mark.parametrize("n_fft, hop, shape, route", [
    (256, 64, (2, 64 * 20), "fused"),
    (800, 200, (1, 200 * 9), "fused"),  # eligible; the kernel's DFT route (below)
    (256, 96, (2, 96 * 20), "fft"),  # hop does not divide n_fft
    (256, 64, (2, 64 * 20 + 5), "fft"),  # length not a multiple of hop
    (256, 64, (64 * 20,), "fft"),  # not batched
])
def test_mel_routing_follows_the_jax_rule(monkeypatch, n_fft, hop, shape, route):
    cfg = _cfg(n_fft, hop)
    wav = np.random.default_rng(0).normal(size=shape).astype(np.float32) * 0.3
    taken = []
    fused, fft = mel_kernel.melspectrogram_fused, dsp.melspectrogram
    monkeypatch.setattr(mel_kernel, "melspectrogram_fused",
                        lambda *a: taken.append("fused") or fused(*a))
    monkeypatch.setattr(dsp, "melspectrogram", lambda *a: taken.append("fft") or fft(*a))
    got = dsp.melspectrogram_auto(torch.from_numpy(wav), cfg)
    assert taken == [route]
    jcfg = jdsp.DSPConfig(**{f: getattr(cfg, f) for f in jdsp.DSPConfig.__dataclass_fields__})
    want = np.asarray(jdsp.melspectrogram(jnp.asarray(wav), jcfg))
    assert got.shape == want.shape and np.abs(got.numpy() - want).max() <= 1e-4
    if route == "fused":  # the kernel takes every eligible frame of n_fft 256-4096
        assert mel_kernel.mel_shape_reason(n_fft, hop) is None


@pytest.mark.parametrize("B, want", [(1, [1]), (16, [16]), (17, [16, 1]), (32, [16, 16]),
                                     (40, [16, 16, 8])])
def test_decode_row_groups(B, want):
    assert [g.stop - g.start for g in dk.row_groups(B)] == want
    assert dk.row_groups(B)[0].start == 0 and dk.row_groups(B)[-1].stop == B


def _decoder_case(B, seed=2, H=32, D=32, P=32, A=16, S=12, mel=8, r=2, K=6):
    rng = np.random.default_rng(seed)

    def w(*shape, s=0.1):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32))

    p = dscan.DecoderParams(
        lstm=(LSTMParams(w(P + D, 4 * H), w(H, 4 * H), w(4 * H)),
              LSTMParams(w(H + D, 4 * H), w(H, 4 * H), w(4 * H))),
        attention=dscan.AttentionParams(w(H, A), w(7, 2, 8, s=0.3), w(8, A, s=0.3), w(A, 1)),
        frame_proj=(w(H + D, mel * r), w(mel * r)), stop_proj=(w(H + D, 1), w(1)))
    bundle = dk.prepare_bundle(p, [(w(mel, P), w(P)), (w(P, P), w(P))], quantize=False)
    keys, memory = w(B, S, A, s=0.3), w(B, S, D, s=0.3)
    mask = (torch.arange(S)[None] < torch.tensor([S - (3 * b) % 7 for b in range(B)])[:, None])
    keep = [(torch.from_numpy(rng.random((K, B, P)) < 0.5).float() / 0.5) for _ in range(2)]
    carry = dscan.initial_carry(B, memory, 2, H)
    return bundle, (keys, memory, mask.float(), carry, torch.rand(B, mel), *keep, K, mel, r)


def test_decode_wrapper_launches_a_group_at_a_time(monkeypatch):
    """The grouped launch path with each launch replaced by the plain
    version: launches of 16, 16 and 8 rows at B 40, and the joined outputs
    equal one plain call over the 40 rows."""
    bundle, args = _decoder_case(40)
    sizes = []

    def launch(bundle_, keys, *rest):
        sizes.append(keys.shape[0])
        return dk.decode_segment_plain(bundle_, keys, *rest)

    monkeypatch.setattr(dk, "_launch", launch)
    got = dk.decode_segment_kernel(bundle, *args)
    want = dk.decode_segment_plain(bundle, *args)
    assert sizes == [16, 16, 8]
    flat = lambda out: [*out[0].h, *out[0].c, *out[0][2:], *out[1:]]  # noqa: E731
    for a, b in zip(flat(got), flat(want)):
        assert a.shape == b.shape and torch.allclose(a, b, atol=1e-6, rtol=0)


def test_decode_wrapper_refuses_inputs_that_disagree_on_the_rows():
    bundle, (keys, memory, mask, *rest) = _decoder_case(17)
    with pytest.raises(ValueError, match="batch rows"):
        dk.decode_segment_kernel(bundle, keys, memory, mask[:16], *rest)
