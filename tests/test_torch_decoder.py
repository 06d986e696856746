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
from multi_speaker_tts_tpu.ops import decode_pallas as jdk
from multi_speaker_tts_tpu.ops import decoder_scan as jdscan
from multi_speaker_tts_tpu.ops.lstm import LSTMParams as JaxLSTMParams
from multi_speaker_tts_tpu.train.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.models.layers import prenet_step
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
    masks = [[torch.from_numpy(m) for m in step]
             for step in _jax_keep_masks(rng, 2, [64, 64], rate, N_STEPS)]
    with torch.no_grad():
        frames_t, stops_t, aligns_t, len_t = dscan.decoder_ar_early_exit(
            taco.decoder.params(), keys, memory, mask, N_STEPS, 0.5,
            _body(taco, masks, "plain", rate), MEL, stopped_init=torch.from_numpy(stopped_init),
            chunk=16,
        )
    np.testing.assert_array_equal(len_t.numpy(), np.asarray(len_j))
    assert 0 < int(len_t[0]) < N_STEPS, "the stop token should fire inside the bucket"
    if stopped_row1:
        assert int(len_t[1]) == 0
    # Each row over its own decoded steps; past the chunk it stopped in, the
    # port decodes the row no further and keeps the filler there.
    assert_rows_match_then_filler((frames_t, stops_t, aligns_t), len_t, 16,
                                  (frames_j, None, aligns_j))
    # Steps no row ran keep the filler stop logit on both sides.
    ran = int(np.ceil(int(np.asarray(len_j).max()) / 16) * 16)
    np.testing.assert_array_equal(stops_t.numpy()[ran:], np.asarray(stops_j)[ran:])


def assert_rows_match_then_filler(got, lengths, K, want, tol=FRAME_TOL):
    """``got`` = (frames, stops, aligns) (n_steps, B, ...) of the early-exit
    loop: each row's first ``lengths[b]`` steps within ``tol`` of ``want``'s
    (a None entry is not compared), and from the end of the chunk of K
    steps that row stopped in, zero frames and alignments and stop logits
    of exactly -1e4."""
    n_steps = got[0].shape[0]
    for b, n in enumerate(int(x) for x in lengths):
        for g, w in zip(got, want):
            if w is not None:
                assert np.abs(g.numpy()[:n, b] - np.asarray(w)[:n, b]).max(initial=0) <= tol, b
        end = min(-(-n // K) * K, n_steps)
        assert not got[0][end:, b].any() and not got[2][end:, b].any(), b
        assert bool((got[1][end:, b] == -1e4).all()), b


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


# Texts whose stops fall in different chunks of ROW_K steps (10 to 38 steps
# on the demo checkpoint), then one PAD row.
ROW_TEXTS = ["hello world.", "a b c", "she sells sea shells by the sea shore.", "pack my box.",
             "the quick brown fox jumps over the lazy dog."]
ROW_K = 4
BF16_TOL = 5e-3  # the bf16 Pallas kernel's bound in the JAX package's tests


@pytest.fixture(scope="module")
def rows_setup(setup):
    from multi_speaker_tts_tpu_torch.text import encode_text

    _, taco, *_ = setup
    hp = Recursive_Parse(load_compact(ROOT / "demo" / "serving_ckpt.msgpack")[2]["hp"])
    seqs = [encode_text(t, hp) for t in ROW_TEXTS] + [[1]]
    tokens = torch.zeros(len(seqs), max(len(s) for s in seqs), dtype=torch.long)
    for i, s in enumerate(seqs):
        tokens[i, :len(s)] = torch.tensor(s)
    lengths = torch.tensor([len(s) for s in seqs])
    g = torch.Generator().manual_seed(7)
    spk = torch.nn.functional.normalize(torch.randn(len(seqs), 64, generator=g), dim=-1)
    with torch.no_grad():
        memory, mask = taco.build_memory(tokens, lengths, spk)
        keys = taco.decoder.memory_layer(memory)
    masks = [[torch.rand(len(seqs), 64, generator=g) < 0.5 for _ in range(2)]
             for _ in range(N_STEPS)]
    pad = torch.zeros(len(seqs), dtype=torch.bool)
    pad[-1] = True
    return taco, keys, memory, mask, masks, pad


def _body(taco, masks, route, rate):
    """The chunk body of ``route`` over ``masks`` (their keep masks a step):
    the plain loop in f32 (``plain``) or with weight-only int8 gates
    (``int8``), or the kernel's, bf16, on CPU tensors its plain version
    (``kernel_body``)."""
    from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk

    pws = [(d.kernel, d.bias) for d in taco.decoder.prenet]
    p = taco.decoder.params()
    if route == "kernel_body":
        return dk.kernel_body(dk.prepare_bundle(p, pws, quantize=False), masks.__getitem__,
                              MEL, R, rate)
    fused = (dscan.quantize_fused(p) if route == "int8"
             else dscan.fused_weights(p.lstm, torch.float32))
    return dscan.plain_body(p, fused, prenet_step(pws, rate, masks.__getitem__), MEL,
                            torch.float32)


def _decode_rows(taco, keys, memory, mask, masks, stopped, route, rate, fixed=False):
    """The early-exit loop over the given rows (``masks``: their keep masks
    a step) through the chunk body of ``route`` (:func:`_body`); ``fixed``:
    the fixed-length scan through it instead, every row in every chunk."""
    body = _body(taco, masks, route, rate)
    p = taco.decoder.params()
    with torch.no_grad():
        if fixed:
            return dscan.decoder_ar_scan(p, keys, memory, mask, N_STEPS, body, MEL, chunk=ROW_K)
        return dscan.decoder_ar_early_exit(p, keys, memory, mask, N_STEPS, 0.5, body, MEL,
                                           stopped_init=stopped, chunk=ROW_K)


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("route", ["plain", "int8"])
def test_plain_scan_in_chunks_equals_one_segment(rows_setup, route, chunk):
    """The fixed-length scan runs the plain body in chunks of K: its frames,
    stop logits and alignments are bit-equal to ``decoder_ar_segment`` over
    every step at once (the same state passes from step to step)."""
    taco, keys, memory, mask, masks, _ = rows_setup
    B, p = mask.shape[0], taco.decoder.params()
    body = _body(taco, masks, route, 0.5)
    with torch.no_grad():
        got = dscan.decoder_ar_scan(p, keys, memory, mask, N_STEPS, body, MEL, chunk=chunk)
        carry = dscan.initial_carry(B, memory, len(p.lstm), p.lstm[0].hidden_size)
        *_, frames, stops, aligns = body(
            keys, memory, mask, carry, memory.new_zeros((B, MEL)), 0,
            torch.zeros(B, dtype=torch.bool), torch.zeros(B, dtype=torch.int32), N_STEPS, 0.5)
    assert got[0].shape == (N_STEPS, B, MEL * R)
    for g, w in zip(got, (frames, stops, aligns)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("route", ["plain", "int8", "kernel_body"])
def test_compacted_rows_decode_as_each_row_alone(rows_setup, route, rate):
    """The loop drops rows as they stop (the longest row's last chunks run
    it alone): each row of a batch whose stops fall in different chunks
    (and a PAD row) decodes as it does alone under its own mask rows, to
    the same length; past the chunk it stopped in its outputs are the
    filler."""
    taco, keys, memory, mask, masks, pad = rows_setup
    got = _decode_rows(taco, keys, memory, mask, masks, pad, route, rate)
    lengths = got[3]
    assert int(lengths[-1]) == 0
    chunks = {-(-int(n) // ROW_K) for n in lengths[:-1]}
    assert len(chunks) >= 4 and max(chunks) * ROW_K < N_STEPS, lengths
    for b in range(len(ROW_TEXTS)):
        alone = _decode_rows(taco, keys[b:b + 1], memory[b:b + 1], mask[b:b + 1],
                             [[m[b:b + 1] for m in step] for step in masks], None, route, rate)
        assert int(alone[3][0]) == int(lengths[b]), b
        n = int(lengths[b])
        for g, w in zip(got[:3], alone[:3]):
            gap = (g[:n, b] - w[:n, 0]).abs().max().item()
            assert gap <= FRAME_TOL, (b, gap)
    assert_rows_match_then_filler(got[:3], lengths, ROW_K, (None, None, None))


@pytest.mark.parametrize("rate", [0.0, 0.5])
@pytest.mark.parametrize("route", ["plain", "int8", "kernel_body"])
def test_compacted_rows_match_jax(setup, rows_setup, route, rate):
    """The compaction held against the JAX package, which runs every row of
    the batch in every chunk: the batch of ``rows_setup`` (stops in
    different chunks, one PAD row) under the JAX package's own keep masks,
    through the XLA loop against the plain body and through the Pallas
    kernel (interpret mode, bf16) against the kernel body. Equal lengths;
    each row's frames and alignments over its own decoded steps; past the
    chunk it stopped in, the filler. The bf16 operands round apart on the
    two sides now and then, and the feedback carries that on (the same
    gaps with every row run in every chunk), so the kernel body is held to
    the JAX package's own bf16 bound, and to its own run of every row in
    every chunk within FRAME_TOL."""
    dec = setup[0]
    taco, keys, memory, mask, _, pad = rows_setup
    B = len(pad)
    ws = [(jnp.asarray(dec["prenet"][f"dense_{i}"]["kernel"]),
           jnp.asarray(dec["prenet"][f"dense_{i}"]["bias"])) for i in range(2)]
    fw, sw = dec["frame_proj"], dec["stop_proj"]

    def project_fn(x):
        frames = jnp.dot(x, fw["kernel"]) + fw["bias"]
        return frames, (jnp.dot(x, sw["kernel"]) + sw["bias"])[..., 0]

    segment_fn = None
    if route == "kernel_body":
        bundle = jdk.prepare_bundle(_jax_params(dec), ws, (fw["kernel"], fw["bias"]),
                                    (sw["kernel"], sw["bias"]), MEL, R, quantize=False)

        def segment_fn(keys_, mem_, mask_, carry, prev, t0, stopped, lengths, k, th, rng_):
            return jdk.decoder_ar_segment_pallas(
                bundle, keys_, mem_, mask_, carry, prev, t0, stopped, lengths, k, th, rng_,
                MEL, R, prenet_dropout=rate, interpret=True)

    rng = jax.random.PRNGKey(11)
    want = jdscan.decoder_ar_early_exit(
        _jax_params(dec), lambda f, k: jax_prenet_apply(ws, f, rate, k), project_fn,
        *(jnp.asarray(x.numpy()) for x in (keys, memory, mask)), N_STEPS, 0.5, rng, MEL,
        stopped_init=jnp.asarray(pad.numpy()), chunk=ROW_K, segment_fn=segment_fn,
        fused=jdscan.quantize_fused(_jax_params(dec)) if route == "int8" else None)
    masks = [[torch.from_numpy(m) for m in step]
             for step in _jax_keep_masks(rng, B, [64, 64], rate, N_STEPS)]
    got = _decode_rows(taco, keys, memory, mask, masks, pad, route, rate)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert len({-(-int(n) // ROW_K) for n in got[3][:-1]}) >= 4, got[3]
    tol = FRAME_TOL if route == "plain" else BF16_TOL
    assert_rows_match_then_filler(got[:3], got[3], ROW_K, (want[0], None, want[2]), tol)
    if route == "kernel_body":
        every = _decode_rows(taco, keys, memory, mask, masks, pad, route, rate, fixed=True)
        assert_rows_match_then_filler(got[:3], got[3], ROW_K, every)
