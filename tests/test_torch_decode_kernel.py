"""The port's decode segment (``ops/decode_kernel.py``, plain version on the
CPU) and its int8 reference (``ops/decoder_scan.py``) against the JAX
package: the Pallas decode kernel in interpret mode and the XLA int8
segment, at the sizes of ``tests/test_decode_pallas.py``. Inputs come from
numpy and go to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.models.layers import prenet_apply as jax_prenet_apply
from multi_speaker_tts_tpu.ops import decode_pallas as jdk
from multi_speaker_tts_tpu.ops import decoder_scan as jdscan
from multi_speaker_tts_tpu.ops.lstm import LSTMParams as JaxLSTMParams
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.models.layers import prenet_step
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

H, D, P, A, S, MEL, R, B, K = 128, 128, 128, 64, 24, 16, 2, 3, 8
CONV_K, CONV_C = 7, 8
# One step from equal state: the int8 quanta are decided by equal inputs, so
# only f32 summation order remains. Over K steps last-bit differences flip
# activation roundings and the feedback compounds them (the JAX package's
# own bounds, tests/test_decode_pallas.py).
STEP_TOL, SEG_TOL, BF16_TOL = 1e-5, 3e-3, 5e-3


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    w = lambda *shape: (rng.standard_normal(shape) * 0.15).astype(np.float32)  # noqa: E731
    lstm = [(w(P + D, 4 * H), w(H, 4 * H), w(4 * H)), (w(H + D, 4 * H), w(H, 4 * H), w(4 * H))]
    att = (w(H, A), w(CONV_K, 2, CONV_C), w(CONV_C, A), w(A, 1))
    prenet = [(w(MEL, P), w(P)), (w(P, P), w(P))]
    frame, stop = (w(H + D, MEL * R), w(MEL * R)), (w(H + D, 1), w(1))
    keys = (rng.standard_normal((B, S, A)) * 0.3).astype(np.float32)
    memory = (rng.standard_normal((B, S, D)) * 0.3).astype(np.float32)
    mask = (np.arange(S)[None, :] < np.array([S, S - 5, 7])[:, None]).astype(np.float32)

    jp = jdscan.DecoderScanParams(
        lstm=tuple(JaxLSTMParams(*map(jnp.asarray, q)) for q in lstm),
        attention=jdscan.AttentionParams(*map(jnp.asarray, att)))
    tp = dscan.DecoderParams(
        lstm=tuple(LSTMParams(*map(_t, q)) for q in lstm),
        attention=dscan.AttentionParams(*map(_t, att)),
        frame_proj=tuple(map(_t, frame)), stop_proj=tuple(map(_t, stop)))
    j = dict(p=jp, prenet=[tuple(map(jnp.asarray, q)) for q in prenet],
             frame=tuple(map(jnp.asarray, frame)), stop=tuple(map(jnp.asarray, stop)),
             keys=jnp.asarray(keys), memory=jnp.asarray(memory), mask=jnp.asarray(mask))
    t = dict(p=tp, prenet=[tuple(map(_t, q)) for q in prenet],
             keys=_t(keys), memory=_t(memory), mask=_t(mask))
    return j, t


def _jax_project(j):
    def project_fn(x):
        return (jnp.dot(x, j["frame"][0]) + j["frame"][1],
                (jnp.dot(x, j["stop"][0]) + j["stop"][1])[..., 0])
    return project_fn


RNG = jax.random.PRNGKey(9)


def _jax_xla(j, state, t0, k=K, threshold=0.5, dropout=0.0, int8=True, cd=jnp.float32):
    """The XLA segment: int8 gates (``quantize_fused``) or the compute-dtype
    gates."""
    carry, prev, stopped, lengths = state
    return jdscan.decoder_ar_segment(
        j["p"], lambda f, key: jax_prenet_apply(j["prenet"], f, dropout, key), _jax_project(j),
        j["keys"], j["memory"], j["mask"], carry, prev, jnp.int32(t0), stopped, lengths, k,
        threshold, RNG, MEL, cd, fused=jdscan.quantize_fused(j["p"]) if int8 else None)


def _jax_pallas(j, state, t0, k=K, threshold=0.5, dropout=0.0, quantize=True):
    carry, prev, stopped, lengths = state
    bundle = jdk.prepare_bundle(j["p"], j["prenet"], j["frame"], j["stop"], MEL, R,
                                quantize=quantize)
    return jdk.decoder_ar_segment_pallas(
        bundle, j["keys"], j["memory"], j["mask"], carry, prev, jnp.int32(t0), stopped,
        lengths, k, threshold, RNG, MEL, R, prenet_dropout=dropout, interpret=True)


def _jax_state0(j, stopped=(False, False, False)):
    return (jdscan.initial_carry(B, j["memory"], 2, H), jnp.zeros((B, MEL), jnp.float32),
            jnp.asarray(stopped), jnp.zeros((B,), jnp.int32))


def _to_torch_state(state):
    carry, prev, stopped, lengths = state
    c = dscan.DecoderCarry(tuple(map(_t, carry.h)), tuple(map(_t, carry.c)), _t(carry.weights),
                           _t(carry.cum_weights), _t(carry.context))
    return c, _t(prev), _t(stopped), _t(lengths)


def _jax_masks(t0, k, dropout):
    """The JAX decode's own keep masks: step t folds t into the prenet rng
    and splits one key per prenet layer."""
    def draw(t):
        keys = jax.random.split(jax.random.fold_in(RNG, t), 2)
        return [_t(np.array(jax.random.bernoulli(kk, 1.0 - dropout, (B, P)))) for kk in keys]
    return draw


def _port(t, state, t0, k=K, threshold=0.5, dropout=0.0, quantize=True):
    carry, prev, stopped, lengths = _to_torch_state(state)
    bundle = dk.prepare_bundle(t["p"], t["prenet"], quantize=quantize)
    return dk.decoder_ar_segment_kernel(
        bundle, t["keys"], t["memory"], t["mask"], carry, prev, t0, stopped, lengths, k,
        threshold, _jax_masks(t0, k, dropout), MEL, R, dropout)


def _leaves(out):
    carry, prev, stopped, lengths, f, s, w = out
    return [*carry.h, *carry.c, carry.weights, carry.cum_weights, carry.context, prev,
            stopped, lengths, f, s, w]


def _assert_close(got, want, tol, what):
    names = ["h0", "h1", "c0", "c1", "w", "cum", "ctx", "prev", "stopped", "lengths",
             "frames", "stops", "aligns"]
    for name, a, b in zip(names, _leaves(got), _leaves(want)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, (what, name)
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=f"{what}: {name}")


def test_quantize_w_and_fused_equal_the_jax_ones(setup):
    j, t = setup
    for (jq, js), (tq, ts), q in zip(jdscan.quantize_fused(j["p"]), dscan.quantize_fused(t["p"]),
                                     t["p"].lstm):
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))  # bit for bit
        assert np.abs(ts.numpy() - np.asarray(js)).max() <= 1e-7
        jq2, js2 = jdk.quantize_w(jnp.concatenate([jnp.asarray(q.w_ih.numpy()),
                                                   jnp.asarray(q.w_hh.numpy())]))
        tq2, ts2 = dscan.quantize_w(torch.cat([q.w_ih, q.w_hh]))
        np.testing.assert_array_equal(tq2.numpy(), np.asarray(jq2))
        assert np.abs(ts2.numpy() - np.asarray(js2)[0]).max() <= 1e-7
    assert dscan.quantize_fused(t["p"])[0][0] is dscan.quantize_fused(t["p"])[0][0]  # cached


def test_int8_gates_match(setup):
    j, t = setup
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, P + D)).astype(np.float32)
    h = (rng.standard_normal((B, H)) * 0.5).astype(np.float32)
    want = jdscan._gates(jdscan.quantize_fused(j["p"])[0], j["p"].lstm[0].b, jnp.asarray(x),
                         jnp.asarray(h), jnp.float32)
    got = dscan._gates(dscan.quantize_fused(t["p"])[0], t["p"].lstm[0].b, _t(x), _t(h),
                       torch.float32)
    # Equal integer sums; the dequantizing product is f32 on both sides.
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def test_int8_product_is_exact_beyond_f32():
    """Sums of 2816 products near 127^2 pass 2^24, where an f32 accumulation
    rounds; the plain product must equal the s32 sum, rounded once."""
    rng = np.random.default_rng(3)
    xq = rng.integers(100, 128, (4, 2816))
    wq = rng.integers(100, 128, (2816, 64))
    want = (xq.astype(np.int64) @ wq.astype(np.int64))
    assert want.min() > 2 ** 24
    got = dscan.int8_product(_t(xq.astype(np.float32)), _t(wq.astype(np.int8)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def test_single_step_from_zero_state(setup):
    j, t = setup
    state = _jax_state0(j)
    got = _port(t, state, 0, k=1)
    _assert_close(got, _jax_pallas(j, state, 0, k=1), STEP_TOL, "vs Pallas (interpret)")
    _assert_close(got, _jax_xla(j, state, 0, k=1), STEP_TOL, "vs XLA int8")


@pytest.fixture(scope="module")
def xla_segment_1(setup):
    j, _ = setup
    return _jax_xla(j, _jax_state0(j), 0)


def test_segment_from_zero_state(setup, xla_segment_1):
    j, t = setup
    state = _jax_state0(j)
    got = _port(t, state, 0)
    _assert_close(got, _jax_pallas(j, state, 0), SEG_TOL, "vs Pallas (interpret)")
    _assert_close(got, xla_segment_1, SEG_TOL, "vs XLA int8")


def test_segment_from_midstream_state(setup, xla_segment_1):
    """The carry load / store paths with non-zero state: segment 2 from the
    XLA reference's state after segment 1."""
    j, t = setup
    state = xla_segment_1[:4]
    got = _port(t, state, K)
    _assert_close(got, _jax_pallas(j, state, K), SEG_TOL, "vs Pallas (interpret)")
    _assert_close(got, _jax_xla(j, state, K), SEG_TOL, "vs XLA int8")


def test_segment_with_dropout_masks_from_the_jax_stream(setup):
    """Always-on prenet dropout: the wrapper turns the caller's keep masks
    (here the JAX stream's own draws, from step 3 on) into scale masks, so
    all three decodes follow one trajectory."""
    j, t = setup
    state = _jax_state0(j)
    got = _port(t, state, 3, dropout=0.5)
    _assert_close(got, _jax_pallas(j, state, 3, dropout=0.5), SEG_TOL, "vs Pallas (interpret)")
    _assert_close(got, _jax_xla(j, state, 3, dropout=0.5), SEG_TOL, "vs XLA int8")


def test_bf16_segment(setup):
    """bf16 gate operands, f32 accumulation, f32 everything else, against
    the Pallas kernel's bf16 mode and the XLA bf16 segment."""
    j, t = setup
    state = _jax_state0(j)
    got = _port(t, state, 0, quantize=False)
    assert dk.prepare_bundle(t["p"], t["prenet"], quantize=False)["w0"].dtype == torch.bfloat16
    _assert_close(got, _jax_pallas(j, state, 0, quantize=False), BF16_TOL,
                  "vs Pallas bf16 (interpret)")
    _assert_close(got, _jax_xla(j, state, 0, int8=False, cd=jnp.bfloat16), BF16_TOL,
                  "vs XLA bf16")


def test_stopped_lengths_bookkeeping(setup):
    """A negative threshold stops every row at its first step; a row that
    arrives stopped counts nothing."""
    j, t = setup
    state = _jax_state0(j, stopped=(False, True, False))
    got = _port(t, state, 0, threshold=-1.0)
    want = _jax_pallas(j, state, 0, threshold=-1.0)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    assert got[3].tolist() == [1, 0, 1] and got[3].dtype == torch.int32


def test_bookkeeping_equals_the_step_loop_on_random_logits():
    rng = np.random.default_rng(2)
    s_k = _t(rng.standard_normal((K, 5)).astype(np.float32) * 2)
    stopped = torch.tensor([False, True, False, False, False])
    lengths = torch.tensor([3, 0, 1, 2, 0], dtype=torch.int32)
    want_s, want_l = stopped.clone(), lengths.clone()
    for k in range(K):
        want_l = want_l + (~want_s).to(torch.int32)
        want_s = want_s | (torch.sigmoid(s_k[k]) > 0.8)

    def fake_segment(bundle, keys, memory, mask, carry, prev, m1, m2, k, mel, r):
        return carry, prev, None, s_k, None

    orig, dk.decode_segment = dk.decode_segment, fake_segment
    try:
        _, _, got_s, got_l, *_ = dk.decoder_ar_segment_kernel(
            None, None, None, None, None, None, 0, stopped, lengths, K, 0.8, None, MEL, R, 0.0)
    finally:
        dk.decode_segment = orig
    assert torch.equal(got_s, want_s) and torch.equal(got_l, want_l)


@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_early_exit_with_the_segment_hook_equals_the_plain_loop(setup, dropout):
    """``decoder_ar_early_exit`` through the kernel's chunk body
    (``kernel_body``, int8 decode segment) against it through the plain
    loop's with int8 gates (``plain_body`` over ``quantize_fused``), same
    masks: equal lengths, and frames within the K-step bound over the steps
    both ran."""
    _, t = setup
    p, n_steps = t["p"], 24
    masks = _jax_masks(0, 0, dropout)
    plain_body = dscan.plain_body(p, dscan.quantize_fused(p),
                                  prenet_step(t["prenet"], dropout, masks), MEL, torch.float32)
    # A threshold every row's stop logit crosses before step 20 of the bucket.
    probe = dscan.decoder_ar_scan(p, t["keys"], t["memory"], t["mask"], n_steps, plain_body,
                                  MEL)
    probs = torch.sigmoid(probe[1])
    th = float(probs[:20].max(dim=0).values.min()) * 0.999
    common = dict(stop_threshold=th, mel_dim=MEL, stopped_init=torch.tensor([False, False, True]),
                  chunk=K)
    plain = dscan.decoder_ar_early_exit(p, t["keys"], t["memory"], t["mask"], n_steps,
                                        body=plain_body, **common)
    kernel_body = dk.kernel_body(dk.prepare_bundle(p, t["prenet"]), masks, MEL, R, dropout)
    hooked = dscan.decoder_ar_early_exit(p, t["keys"], t["memory"], t["mask"], n_steps,
                                         body=kernel_body, **common)
    assert torch.equal(hooked[3], plain[3])
    assert int(plain[3][2]) == 0 and 0 < int(plain[3][:2].max()) < n_steps
    for a, b in zip(hooked[:3], plain[:3]):
        assert a.shape == b.shape and (a - b).abs().max().item() <= SEG_TOL


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_fixed_length_decode_under_a_kernel_mode_runs_the_segment(monkeypatch, mode):
    """``Decoder.Pallas_Decode`` with ``early_exit=False``: every step goes
    through the decode segment (here its plain version, on CPU tensors),
    never through the plain loop's cell step, and the frames inside each
    decoded length equal the early-exit loop's under the same mode."""
    from multi_speaker_tts_tpu.hparams import tiny_test_hparams

    hp = Recursive_Parse(tiny_test_hparams().to_dict()).replace(
        Decoder={"Early_Exit_Chunk": 4, "Pallas_Decode": True if mode == "int8" else "bf16"},
        Speaker_Embedding={"Type": None})
    torch.manual_seed(1)
    model = Tacotron(hp)
    for name, value in model.state_dict().items():
        value.copy_(torch.rand_like(value) + 0.5 if name.endswith("bn_var")
                    else torch.randn_like(value) * 0.3)

    def boom(*a, **k):
        raise AssertionError("the plain decode step ran under a kernel mode")

    monkeypatch.setattr(dscan, "decoder_cell_step", boom)
    segments = []
    plain = dk.decode_segment_plain
    monkeypatch.setattr(dk, "decode_segment_plain",
                        lambda *a, **k: segments.append(a[8]) or plain(*a, **k))
    tokens = torch.tensor([[3, 9, 4, 7, 12, 5, 2, 8], [6, 3, 11, 1, 0, 0, 0, 0]])
    lengths = torch.tensor([8, 4])

    def masks(seed):
        g = torch.Generator().manual_seed(seed)
        sizes = tuple(hp.Decoder.Prenet.Sizes)
        return lambda t: tuple(torch.rand(2, n, generator=g) >= hp.Decoder.Prenet.Dropout_Rate
                               for n in sizes)

    fixed = model.infer(tokens, lengths, None, 16, 2.0, prenet_masks=masks(0),
                        early_exit=False)
    assert segments == [4, 4, 4, 4]  # 16 steps (r = 1) in chunks of 4
    assert fixed["mel_lengths"].tolist() == [16, 16]  # no stop logit crosses 2.0
    probs = torch.sigmoid(fixed["stop_logits"])
    th = float(probs[:, :6].max(dim=1).values.min()) * 0.999
    early = model.infer(tokens, lengths, None, 16, th, prenet_masks=masks(0))
    fixed = model.infer(tokens, lengths, None, 16, th, prenet_masks=masks(0),
                        early_exit=False)
    assert torch.equal(early["mel_lengths"], fixed["mel_lengths"])
    for i, n in enumerate(early["mel_lengths"].tolist()):
        assert torch.equal(early["mel_pre"][i, :n], fixed["mel_pre"][i, :n])


def test_fixed_length_decode_matches_early_exit_inside_each_length():
    """``Tacotron.infer(early_exit=False)``: lengths from the first stop
    logit over the threshold, and the same ``mel_post`` and ``linear`` inside
    each decoded length as the early-exit loop (f32, dropout 0)."""
    from multi_speaker_tts_tpu.hparams import tiny_test_hparams

    hp = Recursive_Parse(tiny_test_hparams().to_dict()).replace(
        Decoder={"Prenet": {"Dropout_Rate": 0.0}, "Early_Exit_Chunk": 4},
        Speaker_Embedding={"Type": None})
    torch.manual_seed(0)
    model = Tacotron(hp)
    for name, value in model.state_dict().items():
        value.copy_(torch.rand_like(value) + 0.5 if name.endswith("bn_var")
                    else torch.randn_like(value) * 0.3)
    tokens = torch.tensor([[3, 9, 4, 7, 12, 5, 2, 8], [6, 3, 11, 1, 0, 0, 0, 0]])
    lengths = torch.tensor([8, 4])
    probs = torch.sigmoid(model.infer(tokens, lengths, None, 16, 2.0)["stop_logits"])
    th = float(probs[:, :12].max(dim=1).values.min()) * 0.999  # crossed by step 12
    early = model.infer(tokens, lengths, None, 16, th)
    fixed = model.infer(tokens, lengths, None, 16, th, early_exit=False)
    assert torch.equal(early["mel_lengths"], fixed["mel_lengths"])
    assert 0 < int(early["mel_lengths"].min()) and int(early["mel_lengths"].max()) < 16
    for i, n in enumerate(early["mel_lengths"].tolist()):
        for key in ("mel_post", "linear"):
            assert (early[key][i, :n] - fixed[key][i, :n]).abs().max().item() <= 1e-5, key


def test_supported_and_refusals(setup):
    _, t = setup
    p = t["p"]
    assert dk.supported(p, (P, P), D, S, MEL)
    three = p._replace(lstm=p.lstm + p.lstm[:1])
    assert not dk.supported(three, (P, P), D, S, MEL)
    assert not dk.supported(p, (P,), D, S, MEL)
    assert not dk.supported(p, (P, P), D + 7, S, MEL)  # off the kernel's 16-element grid
    assert not dk.supported(p, (P + 2, P), D, S, MEL)  # off its 4-element grid
    # The kernel's own limit on memory positions: one row a launch in an
    # H100's shared memory.
    limit = dk.max_positions(dk.Widths(H, D, P, P, A, MEL, CONV_K, CONV_C), True, *dk.H100)
    assert limit > 256 and dk.supported(p, (P, P), D, limit, MEL)
    assert not dk.supported(p, (P, P), D, limit + 1, MEL)
    assert str(limit) in dk.unsupported_reason(p, (P, P), D, limit + 1, MEL)
    assert "16" in dk.unsupported_reason(p, (P, P), D + 7, S, MEL)
    with pytest.raises(ValueError, match="2-layer"):
        dk.prepare_bundle(three, t["prenet"])
    with pytest.raises(ValueError, match="2-layer"):
        dk.prepare_bundle(p, t["prenet"][:1])


def test_cpu_segment_never_counts_a_launch(setup):
    j, t = setup
    before = {m: k.launches for m, k in dk.KERNELS.items()}
    _port(t, _jax_state0(j), 0, k=2)
    _port(t, _jax_state0(j), 0, k=2, quantize=False)
    assert {m: k.launches for m, k in dk.KERNELS.items()} == before


# The kernel's host-side layout: the grid ops/decode_kernel.py mirrors from
# csrc/decode.cu and the packed gate rows.
@pytest.mark.parametrize("H, n_sm, want", [
    (1024, 132, {"U": 8, "nblk": 128, "grid": 132, "mt": 2}),  # production decoder, H100
    (256, 132, {"U": 2, "nblk": 128, "grid": 132, "mt": 1}),   # the small demo checkpoint
    (128, 132, {"U": 1, "nblk": 128, "grid": 132, "mt": 1}),
    (1024, 114, {"U": 10, "nblk": 103, "grid": 107, "mt": 3}),  # too wide for two m-tiles
])
def test_decode_layout(H, n_sm, want):
    assert dk.decode_layout(H, n_sm) == want


@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16], ids=["int8", "bf16"])
@pytest.mark.parametrize("H, K", [(1024, 2048), (1024, 2816), (128, 384), (256, 600)])
def test_gate_weight_packing_unpacks_exactly(dtype, H, K):
    """Each block's 4U gate rows, depth padded to whole windows, lane by
    lane: unpacked, the bytes are the plain (4H, K) rows, pad rows zero."""
    lay = dk.decode_layout(H, 132)
    U, nblk, mt = lay["U"], lay["nblk"], lay["mt"]
    g = torch.Generator().manual_seed(H + K)
    w = torch.randn((4 * H, K), generator=g)
    w = (w * 40).clamp(-127, 127).to(torch.int8) if dtype == torch.int8 else w.to(dtype)
    packed = dk.pack_gate_weights(w, H, U, nblk, mt)
    esize = w.element_size()
    win = 64 // esize
    Kp = -(-K // win) * win
    assert packed.shape == (nblk, mt, Kp // win, 2, 32, 16) and packed.dtype == torch.uint8
    rows = packed.reshape(nblk, mt, Kp // win, 2, 8, 4, 16).permute(0, 1, 3, 4, 2, 5, 6)
    rows = rows.reshape(nblk, 16 * mt, Kp * esize).contiguous()
    rows = rows.view(torch.int16 if esize == 2 else torch.int8)
    assert not rows[..., K:].any()
    idx = dk.gate_rows(H, U, nblk, mt)
    plain = w.view(torch.int16) if esize == 2 else w
    assert torch.equal(rows[..., :K][idx >= 0], plain[idx[idx >= 0]])
    assert not rows[idx < 0].any()
    # Block j's local row g U + u is gate g of unit j U + u.
    assert idx[1, 0].item() == U and idx[0, U].item() == H


def test_shape_rule_accepts_the_served_decoders_and_names_what_it_refuses():
    assert dk._shape_reason(1024, 768, (256, 256), 48, 128, 80, 32) is None
    assert dk._shape_reason(256, 256, (128, 128), 256, 512, 80, 32) is None
    assert "16" in dk._shape_reason(1024, 776, (256, 256), 48, 128, 80, 32)
    # S up to the kernel's one-row limit (3,788 in int8 at these widths on an
    # H100), not the JAX package's 256.
    assert dk._shape_reason(1024, 768, (256, 256), 257, 128, 80, 32) is None
    assert "3788 memory positions" in dk._shape_reason(1024, 768, (256, 256), 3789, 128, 80, 32)
    # Wide attention and gate products deeper than a staging piece (4,096)
    # are taken; past 16 units a gate block (H 2048 on an H100) int8 in
    # passes, bf16 not.
    assert dk._shape_reason(1024, 768, (256, 256), 48, 516, 80, 32) is None
    assert dk._shape_reason(1664, 784, (256, 256), 48, 128, 80, 32) is None
    assert dk._shape_reason(2064, 512, (256, 256), 48, 128, 80, 32) is None
    assert "64 gate rows a block" in dk._shape_reason(2064, 512, (256, 256), 48, 128, 80, 32,
                                                      quantized=False)
