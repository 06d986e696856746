"""The decode kernel at every text length, on the CPU: the Python copy of
``csrc/decode.cu``'s shared-memory layout (``decode_kernel.layout_bytes``)
at the production widths of ``demo/serving_ckpt_full.msgpack`` on an H100,
the row groups it sizes, the kernel's own limit on memory positions, and
the AR decode's route past that limit (the plain loop, where the JAX
package routes to XLA) held against the JAX package's XLA decode at S 272.
The card holds the layout copy against the kernel's own
(``tests/test_torch_cuda.py``)."""

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
from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
from multi_speaker_tts_tpu_torch.ops import decode_kernel as dk
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams
from multi_speaker_tts_tpu_torch.text import encode_text
from multi_speaker_tts_tpu_torch.weights import load_into, params_from_jax

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
# demo/serving_ckpt_full.msgpack: H 1024, memory 768, prenet 256 / 256,
# attention 128, mel 80, location conv 31 x 32.
FULL = dk.Widths(H=1024, D=768, P1=256, P2=256, A=128, mel=80, conv_k=31, conv_c=32)
# The largest S (a multiple of 16) at which a launch over 1, 4, 8, 12, 14, 15
# and 16 rows fits an H100 (132 SMs, 232,448 bytes of opt-in shared memory a
# block): the card's own mstts_decode_layout agrees at every S from 16 to
# 6000 and every row count from 1 to 16.
TABLE = {
    "bf16": {1: 5312, 4: 5280, 8: 3952, 12: 2032, 14: 1072, 15: 592, 16: 112},
    "int8": {1: 3776, 4: 3232, 8: 2336, 12: 1440, 14: 992, 15: 768, 16: 544},
}


@pytest.mark.parametrize("mode, rows, S", [(m, b, s) for m, t in TABLE.items()
                                           for b, s in t.items()])
def test_layout_copy_gives_the_table(mode, rows, S):
    q = mode == "int8"
    assert dk.layout_bytes(rows, S, FULL, q, *dk.H100)["fits"]
    assert not dk.layout_bytes(rows, S + 16, FULL, q, *dk.H100)["fits"]
    assert S <= dk.max_positions(FULL, q, *dk.H100, rows=rows) < S + 16


def test_one_row_limit_is_the_kernels_limit():
    """The kernel's limit on memory positions is its own (one row a launch),
    not the JAX package's 256: about 5,300 in bf16 and 3,800 in int8."""
    for q, (lo, hi) in ((False, (5312, 5328)), (True, (3776, 3792))):
        limit = dk.max_positions(FULL, q, *dk.H100)
        assert lo <= limit < hi
        reason = dk._shape_reason(1024, 768, (256, 256), limit + 1, 128, 80, 32, 31, q)
        assert reason is not None and str(limit) in reason
        assert dk._shape_reason(1024, 768, (256, 256), limit, 128, 80, 32, 31, q) is None
    # Whether a launch fits falls with rows and with S (the bytes grow with
    # both, but the location weights leave shared memory where they would
    # not fit, which drops the total once): the fitting row counts at an S
    # are 1 .. group_rows, the fitting S at a row count 1 .. the limit.
    for q in (False, True):
        for S in (16, 208, 600, 1008, 2048, 3776):
            fit = [dk.layout_bytes(b, S, FULL, q, *dk.H100)["fits"] for b in range(1, 17)]
            assert fit == [b <= dk.group_rows(S, FULL, q, *dk.H100) for b in range(1, 17)]
        for b in (1, 8, 16):
            limit = dk.max_positions(FULL, q, *dk.H100, rows=b)
            assert all(dk.layout_bytes(b, S, FULL, q, *dk.H100)["fits"] == (S <= limit)
                       for S in range(16, 6001, 16))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("S", [16, 112, 128, 208, 560, 1008, 2048, 3776, 4000, 5312])
def test_row_groups_fit_and_cover_every_row(quantized, S):
    limit = dk.max_positions(FULL, quantized, *dk.H100)
    rows = dk.group_rows(S, FULL, quantized, *dk.H100)
    if S > limit:
        assert rows == 0
        return
    assert 1 <= rows <= dk.MAX_B
    assert rows == dk.MAX_B or not dk.layout_bytes(rows + 1, S, FULL, quantized,
                                                   *dk.H100)["fits"]
    for B in (1, 4, 9, 15, 16, 17, 32, 40):
        groups = dk.row_groups(B, rows)
        assert [i for g in groups for i in range(B)[g]] == list(range(B))
        assert all(dk.layout_bytes(g.stop - g.start, S, FULL, quantized, *dk.H100)["fits"]
                   for g in groups)
        assert len(groups) == -(-B // rows)


def _bundle_of(w: dk.Widths, quantized: bool) -> dict:
    """A bundle with these widths, as ``widths_of`` reads it."""
    z = torch.zeros
    return {"b0": z(4 * w.H), "ck": z(w.conv_k, 2, w.conv_c), "wproj": z(161, w.H + w.D),
            "wp1": z(w.P1, w.mel), "wp2": z(w.P2, w.P1), "wq": z(w.H, w.A),
            "quantized": quantized}


@pytest.mark.parametrize("quantized", [False, True])
def test_kernel_row_groups_at_the_main_paths_lengths(quantized):
    """16 texts at S 208 and one at S 1008 (the long-text cell); past the
    one-row limit the wrapper raises with the limit."""
    bundle = _bundle_of(FULL, quantized)
    assert dk.widths_of(bundle) == FULL
    want16 = [16] if quantized else [15, 1]  # 15 rows fit at S 208 in bf16
    assert [g.stop - g.start for g in dk.kernel_row_groups(bundle, 16, 208, "cpu")] == want16
    assert len(dk.kernel_row_groups(bundle, 1, 1008, "cpu")) == 1
    limit = dk.max_positions(FULL, quantized, *dk.H100)
    assert len(dk.kernel_row_groups(bundle, 1, limit, "cpu")) == 1
    with pytest.raises(ValueError, match=f"at most {limit} memory positions"):
        dk.kernel_row_groups(bundle, 1, limit + 1, "cpu")


def _full_params(H=1024, D=768, P=256, A=128, conv_k=31, conv_c=32):
    """Decoder parameters at these widths, for the shape gates only
    (broadcast zeros: no memory)."""
    z = lambda *s: torch.zeros(()).expand(*s)  # noqa: E731
    lstm = (LSTMParams(z(P + D, 4 * H), z(H, 4 * H), z(4 * H)),
            LSTMParams(z(H + D, 4 * H), z(H, 4 * H), z(4 * H)))
    return dscan.DecoderParams(lstm, dscan.AttentionParams(z(H, A), z(conv_k, 2, conv_c),
                                                           z(conv_c, A), z(A, 1)),
                               (z(H + D, 160), z(160)), (z(H + D, 1), z(1)))


def _jax_full_params(H=1024, D=768, P=256, A=128, conv_k=31, conv_c=32):
    z = lambda *s: np.broadcast_to(np.float32(0), s)  # noqa: E731
    return jdscan.DecoderScanParams(
        lstm=(JaxLSTMParams(z(P + D, 4 * H), z(H, 4 * H), z(4 * H)),
              JaxLSTMParams(z(H + D, 4 * H), z(H, 4 * H), z(4 * H))),
        attention=jdscan.AttentionParams(z(H, A), z(conv_k, 2, conv_c), z(conv_c, A), z(A, 1)))


@pytest.mark.parametrize("mode", ["int8", "bf16"])
def test_route_to_the_plain_loop_only_where_jax_refuses_too(mode):
    """Over S 16-6000 at production width: wherever the port routes the
    decode to the plain loop (S past its kernel's one-row limit), the JAX
    package's ``decode_pallas.supported`` is False too, so both packages
    decode that text on their plain paths."""
    q = mode == "int8"
    limit = dk.position_limit(_full_params(), (256, 256), 768, 80, q, dk.H100)
    assert limit == dk.max_positions(FULL, q, *dk.H100)
    jp = _jax_full_params()
    routed = 0
    for S in range(16, 6001, 16):
        if S > limit:
            routed += 1
            assert not jdk.supported(jp, 256, 768, S, mode=mode)
            assert not dk.supported(_full_params(), (256, 256), 768, S, 80, q)
        else:
            assert dk.supported(_full_params(), (256, 256), 768, S, 80, q)
    assert routed > 0
    # The JAX gate's own limit is 256: the port's kernel takes S past it.
    assert jdk.supported(jp, 256, 768, 256, mode=mode)
    assert not jdk.supported(jp, 256, 768, 272, mode=mode)
    # A width the kernel refuses is no limit on positions: it raises at launch.
    assert dk.position_limit(_full_params(D=776), (256, 256), 776, 80, q, dk.H100) is None
    # More than 16 units a gate block: refused in bf16, taken in passes in int8.
    too_wide = 16 * (dk.MAX_UNITS * (132 - dk.PRENET_BLOCKS) // 16 + 1)
    limit = dk.position_limit(_full_params(H=too_wide, D=256, P=256), (256, 256), 256, 80, q,
                              dk.H100)
    assert limit is None if not q else limit >= 256


# -- the route at S 272 against the JAX package's XLA decode -------------------

N_STEPS, MEL = 48, 80
# f32 on both sides, equal keep masks: frames differ by summation order.
FRAME_TOL = 1e-4


@pytest.fixture(scope="module")
def long_text():
    params, batch_stats, meta = load_compact(ROOT / "demo" / "serving_ckpt.msgpack")
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False},
                                             Train={"Use_Mixed_Precision": False})
    taco = Tacotron(hp)
    load_into(taco, params_from_jax(params, batch_stats, hp), "tacotron.")
    text = ("the quick brown fox jumps over the lazy dog. she sells sea shells by the sea "
            "shore. ") * 4
    seq = list(encode_text(text, hp)[:272])
    assert len(seq) == 272
    tokens = torch.tensor([seq, seq[:200] + [0] * 72])
    lengths = torch.tensor([272, 200])
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


@pytest.mark.parametrize("mode", ["bf16", True])
def test_route_past_the_limit_matches_jax_at_s272(long_text, mode, monkeypatch, capsys):
    """At S 272 the JAX package's kernel gate refuses (its limit is 256) and
    it decodes on XLA. The port, on a card whose shared memory puts its
    kernel's one-row limit between 256 and 271, routes the same decode to
    the plain loop: the kernel's chunk body never runs; equal lengths, mel
    within 1e-4."""
    dec, taco, memory, mask, keys = long_text
    quantized = mode is True
    w = dk.Widths(256, memory.shape[-1], 64, 64, 64, MEL, 31, 32)
    lo, hi = 0, 1 << 20  # the least shared memory a block that takes S 256 at one row
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (lo, mid) if dk.max_positions(w, quantized, 132, mid) >= 256 else (mid, hi)
    card = (132, hi)
    limit = dk.max_positions(w, quantized, *card)
    assert 256 <= limit < 272
    monkeypatch.setattr(dk, "card_limits", lambda device: card)
    monkeypatch.setattr(taco.decoder, "pallas_decode", mode)

    def boom(*a, **k):
        raise AssertionError("the kernel's chunk ran past its limit")

    monkeypatch.setattr(dk, "decoder_ar_segment_kernel", boom)
    rate = 0.5
    ws = [(jnp.asarray(dec["prenet"][f"dense_{i}"]["kernel"]),
           jnp.asarray(dec["prenet"][f"dense_{i}"]["bias"])) for i in range(2)]
    fw, sw = dec["frame_proj"], dec["stop_proj"]

    def project_fn(x):
        frames = jnp.dot(x, fw["kernel"]) + fw["bias"]
        return frames, (jnp.dot(x, sw["kernel"]) + sw["bias"])[..., 0]

    rng = jax.random.PRNGKey(3)
    jp = _jax_params(dec)
    assert not jdk.supported(jp, 64, memory.shape[-1], 272, mode="bf16" if mode == "bf16"
                             else "int8")
    frames_j, stops_j, _, len_j = jdscan.decoder_ar_early_exit(
        jp, lambda f, k: jax_prenet_apply(ws, f, rate, k), project_fn,
        jnp.asarray(keys.numpy()), jnp.asarray(memory.numpy()), jnp.asarray(mask.numpy()),
        N_STEPS, 0.5, rng, MEL, chunk=16,
    )
    masks = _jax_keep_masks(rng, 2, [64, 64], rate, N_STEPS)
    dsp._DISPATCH_LOGGED.discard(("decode", "plain"))
    with torch.no_grad():
        mel, stops, _, lengths = taco.decoder.infer(
            memory, mask, N_STEPS * 2, 0.5, None,
            lambda t: [torch.from_numpy(m) for m in masks[t]], torch.float32)
    assert "[dispatch] decode" not in capsys.readouterr().out  # printed on the card only
    np.testing.assert_array_equal(lengths.numpy(), np.asarray(len_j))
    want = np.asarray(frames_j).transpose(1, 0, 2).reshape(2, N_STEPS * 2, MEL)
    stops_j = np.asarray(stops_j).T
    K = dscan.chunk_size(N_STEPS, taco.decoder.early_exit_chunk)
    # Each row over its own decoded steps; past the chunk it stopped in, the
    # port decodes the row no further and keeps the filler there.
    for b, n in enumerate(int(x) for x in lengths):
        assert np.abs(mel.numpy()[b, :n * 2] - want[b, :n * 2]).max(initial=0) <= FRAME_TOL
        assert np.abs(stops.numpy()[b, :n] - stops_j[b, :n]).max(initial=0) <= FRAME_TOL
        end = min(-(-n // K) * K, N_STEPS)
        assert not mel[b, end * 2:].any() and bool((stops[b, end:] == -1e4).all()), b


def test_under_the_limit_the_kernel_chunk_runs(long_text, monkeypatch):
    """At S 272 on an H100 the kernel takes the small checkpoint's decoder
    (its one-row limit is far above): the chunk body is the kernel's."""
    _, taco, memory, mask, _ = long_text
    monkeypatch.setattr(taco.decoder, "pallas_decode", "bf16")
    calls = []
    real = dk.decoder_ar_segment_kernel
    monkeypatch.setattr(dk, "decoder_ar_segment_kernel",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        taco.decoder.infer(memory, mask, 8, 0.5, None,
                           lambda t: [torch.ones(2, 64, dtype=torch.bool)] * 2, torch.float32)
    assert calls
