"""The port's AR decode against ``decoder_ar_early_exit`` with prenet
dropout ON: the keep masks are drawn in this test from the JAX package's
own stream (``split(fold_in(rng, t), n_layers)`` -> ``bernoulli``, as
``decoder_scan.py`` and ``layers.prenet_apply`` draw them) and handed to
the port, so both decodes see identical dropout."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.models.layers import prenet_apply as jax_prenet_apply
from multi_speaker_tts_tpu.ops import decoder_scan as jdscan
from multi_speaker_tts_tpu.ops.lstm import LSTMParams as JaxLSTMParams
from multi_speaker_tts_tpu.train.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.models.layers import prenet_apply
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.weights import load_into, params_from_jax

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
N_STEPS, R, MEL = 48, 2, 80
# f32 on both sides; equal keep masks. Frames differ by summation order
# (~1e-6); the AR feedback keeps that below 1e-4 over 48 steps.
FRAME_TOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    params, batch_stats, meta = load_compact(ROOT / "demo" / "serving_ckpt.msgpack")
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False},
                                             Train={"Use_Mixed_Precision": False})
    taco = Tacotron(hp)
    load_into(taco, params_from_jax(params, batch_stats, hp), "tacotron.")
    # Memory from the port's own encoder on real text, so attention moves and
    # the stop token fires; one PAD-like short row.
    tokens = torch.tensor([[20, 17, 24, 24, 27, 2, 35, 27, 30, 24, 16, 1],
                           [22, 17, 28, 28, 27, 1, 0, 0, 0, 0, 0, 0]])
    lengths = torch.tensor([12, 6])
    rng = np.random.default_rng(7)
    spk = rng.standard_normal((2, 64)).astype(np.float32)
    spk /= np.linalg.norm(spk, axis=-1, keepdims=True)
    with torch.no_grad():
        memory, mask = taco.build_memory(tokens, lengths, torch.from_numpy(spk))
        keys = taco.decoder.memory_layer(memory)
    return params["tacotron"]["decoder"], taco, memory, mask, keys


def _jax_params(dec):
    cell = dec["cell"]
    att = cell["attention"]
    return jdscan.DecoderScanParams(
        lstm=tuple(JaxLSTMParams(jnp.asarray(cell[f"lstm_{i}"]["w_ih"]),
                                 jnp.asarray(cell[f"lstm_{i}"]["w_hh"]),
                                 jnp.asarray(cell[f"lstm_{i}"]["b"])) for i in range(2)),
        attention=jdscan.AttentionParams(
            jnp.asarray(att["query_layer"]["kernel"]),
            jnp.asarray(att["location_conv"]["kernel"]),
            jnp.asarray(att["location_layer"]["kernel"]),
            jnp.asarray(att["v"]["kernel"])),
    )


def _jax_keep_masks(rng, batch, sizes, rate, n_steps):
    """The JAX decode's own draws: step t folds t into the prenet rng and
    splits one key per prenet layer."""
    out = []
    for t in range(n_steps):
        keys = jax.random.split(jax.random.fold_in(rng, t), len(sizes))
        out.append([np.array(jax.random.bernoulli(k, 1.0 - rate, (batch, s)))
                    for k, s in zip(keys, sizes)])
    return out


@pytest.mark.parametrize("stopped_row1", [False, True])
def test_ar_decode_matches_with_jax_drawn_masks(setup, stopped_row1):
    dec, taco, memory, mask, keys = setup
    rate = 0.5
    ws = [(jnp.asarray(dec["prenet"][f"dense_{i}"]["kernel"]),
           jnp.asarray(dec["prenet"][f"dense_{i}"]["bias"])) for i in range(2)]
    fw, sw = dec["frame_proj"], dec["stop_proj"]

    def project_fn(x):
        frames = jnp.dot(x, fw["kernel"]) + fw["bias"]
        return frames, (jnp.dot(x, sw["kernel"]) + sw["bias"])[..., 0]

    rng = jax.random.PRNGKey(3)
    stopped_init = np.asarray([False, stopped_row1])
    frames_j, stops_j, aligns_j, len_j = jdscan.decoder_ar_early_exit(
        _jax_params(dec), lambda f, k: jax_prenet_apply(ws, f, rate, k), project_fn,
        jnp.asarray(keys.numpy()), jnp.asarray(memory.numpy()), jnp.asarray(mask.numpy()),
        N_STEPS, 0.5, rng, MEL, stopped_init=jnp.asarray(stopped_init), chunk=16,
    )
    masks = _jax_keep_masks(rng, 2, [64, 64], rate, N_STEPS)
    pws = [(d.kernel, d.bias) for d in taco.decoder.prenet]

    def prenet_fn(frame, t):
        return prenet_apply(pws, frame, rate, [torch.from_numpy(m) for m in masks[t]])

    with torch.no_grad():
        frames_t, stops_t, aligns_t, len_t = dscan.decoder_ar_early_exit(
            taco.decoder.params(), keys, memory, mask, N_STEPS, 0.5, prenet_fn, MEL,
            torch.float32, stopped_init=torch.from_numpy(stopped_init), chunk=16,
        )
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert 0 < int(len_t[0]) < N_STEPS, "the stop token should fire inside the bucket"
    if stopped_row1:
        assert int(len_t[1]) == 0
    n = int(np.asarray(len_j).max())
    assert np.abs(frames_t.numpy()[:n] - np.asarray(frames_j)[:n]).max() <= FRAME_TOL
    assert np.abs(aligns_t.numpy()[:n] - np.asarray(aligns_j)[:n]).max() <= FRAME_TOL
    # Steps never run keep the filler stop logit on both sides.
    ran = int(np.ceil(n / 16) * 16)
    np.testing.assert_array_equal(stops_t.numpy()[ran:], np.asarray(stops_j)[ran:])


def test_chunk_is_the_largest_divisor():
    assert dscan.chunk_size(48, 16) == 16
    assert dscan.chunk_size(50, 16) == 10
    assert dscan.chunk_size(7, 16) == 7
    assert dscan.chunk_size(13, 4) == 1


def test_location_conv_matches_lax_conv():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, 2)).astype(np.float32)
    for K in (31, 4):
        k = rng.standard_normal((K, 2, 5)).astype(np.float32)
        want = np.asarray(jdscan._location_conv(jnp.asarray(x), jnp.asarray(k)))
        got = dscan.location_conv(torch.from_numpy(x), torch.from_numpy(k)).numpy()
        np.testing.assert_allclose(got, want, atol=1e-5)
