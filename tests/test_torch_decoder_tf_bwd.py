"""The teacher-forced decoder scan's hand-written backward (the port's
``decoder_tf_scan``, an autograd Function) against the JAX package's
``decoder_tf_scan`` custom VJP, on the same numpy inputs.

Every gradient (each layer's w_ih, w_hh, b; wq, the location conv, wloc,
v; the prenet-ed frames, the keys and the memory) of a loss that weights
both outputs (the [h, context] rows and the alignments) by seeded
cotangents, with padded memory positions, for one and two decoder layers:
within 1e-4 of each gradient's peak in f32, and 1e-2 in bf16 compute, where
both sides keep bf16 residuals and emit bf16 gate gradients (they round at
the same places; f32 sums in another order move a rounding now and then).
Then the Function against the port's own autograd loop
(``decoder_tf_scan_ref``) in f32, and the train step calling the Function.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.ops import decoder_scan as jdscan
from multi_speaker_tts_tpu.ops import lstm as jlstm
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

TOL = {"f32": 1e-4, "bf16": 1e-2}
T, B, S, P, DM, H, A, K, C = 7, 3, 10, 16, 24, 32, 16, 7, 4
CASES = [("f32", 1), ("f32", 2), ("bf16", 1), ("bf16", 2)]


def _inputs(n_layers: int, seed: int):
    rng = np.random.default_rng(seed)

    def a(*shape, scale=0.15):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    lstm = [[a(P + DM, 4 * H), a(H, 4 * H), a(4 * H)]]
    lstm += [[a(H + DM, 4 * H), a(H, 4 * H), a(4 * H)] for _ in range(n_layers - 1)]
    att = [a(H, A, scale=0.3), a(K, 2, C, scale=0.3), a(C, A, scale=0.3), a(A, 1, scale=0.3)]
    seqs = [a(T, B, P, scale=1.0), a(B, S, A, scale=0.5), a(B, S, DM, scale=0.5)]
    # Rows of 10, 7 and 4 valid memory positions: the last two padded.
    mask = (np.arange(S)[None] < np.array([S, 7, 4])[:, None]).astype(np.float32)
    cotangents = (a(T, B, H + DM, scale=1.0), a(T, B, S, scale=1.0))
    return lstm, att, seqs, mask, cotangents


def _jax_grads(lstm, att, seqs, mask, cotangents, cd):
    px, pw = cotangents

    def loss(lp, ap, pre, keys, mem):
        p = jdscan.DecoderScanParams(tuple(jlstm.LSTMParams(*q) for q in lp),
                                     jdscan.AttentionParams(*ap))
        xs, ws = jdscan.decoder_tf_scan(p, pre, keys, mem, jnp.asarray(mask), cd)
        return (xs * px).sum() + (ws * pw).sum()

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3, 4)))(
        [tuple(map(jnp.asarray, q)) for q in lstm], tuple(map(jnp.asarray, att)),
        *map(jnp.asarray, seqs))
    return [np.asarray(x) for q in g[0] for x in q] + [np.asarray(x) for x in g[1]] + \
        [np.asarray(x) for x in g[2:]]


def _port_grads(fn, lstm, att, seqs, mask, cotangents, cd):
    n = len(lstm)
    leaves = [torch.tensor(x, requires_grad=True)
              for x in [w for q in lstm for w in q] + att + seqs]
    p = dscan.DecoderParams(tuple(LSTMParams(*leaves[3 * i:3 * i + 3]) for i in range(n)),
                            dscan.AttentionParams(*leaves[3 * n:3 * n + 4]), None, None)
    xs, ws = fn(p, *leaves[-3:], torch.from_numpy(mask), cd)
    px, pw = (torch.from_numpy(c) for c in cotangents)
    return [g.numpy() for g in torch.autograd.grad((xs * px).sum() + (ws * pw).sum(), leaves)]


def _rel(want, got) -> float:
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-9))


@pytest.fixture(scope="module")
def reference():
    """The JAX custom VJP's gradients for every case, computed once."""
    out = {}
    for cd_name, n in CASES:
        case = _inputs(n, seed=31 + n)
        cd = jnp.float32 if cd_name == "f32" else jnp.bfloat16
        out[(cd_name, n)] = (case, _jax_grads(*case, cd))
    return out


@pytest.mark.parametrize("cd_name, n_layers", CASES)
def test_function_gradients_match_the_custom_vjp(reference, cd_name, n_layers):
    case, want = reference[(cd_name, n_layers)]
    cd = torch.float32 if cd_name == "f32" else torch.bfloat16
    got = _port_grads(dscan.decoder_tf_scan, *case, cd)
    assert len(got) == len(want) == 3 * n_layers + 4 + 3
    for w, g in zip(want, got):
        assert w.shape == g.shape and _rel(w, g) <= TOL[cd_name]


@pytest.mark.parametrize("n_layers", [1, 2])
def test_function_matches_the_autograd_loop(n_layers):
    case = _inputs(n_layers, seed=7)
    want = _port_grads(dscan.decoder_tf_scan_ref, *case, torch.float32)
    got = _port_grads(dscan.decoder_tf_scan, *case, torch.float32)
    for w, g in zip(want, got):
        assert _rel(w, g) <= 1e-5


def test_forward_equals_the_autograd_loop_and_the_alignment_cotangent_counts():
    """Bit-equal forward outputs, with and without a graph; a cotangent on
    the alignments alone
    reaches every attention weight and the keys (the backward routes the
    cumulative weights' chain)."""
    lstm, att, seqs, mask, (px, pw) = _inputs(2, seed=5)
    for cd in (torch.float32, torch.bfloat16):
        p = dscan.DecoderParams(tuple(LSTMParams(*map(torch.tensor, q)) for q in lstm),
                                dscan.AttentionParams(*map(torch.tensor, att)), None, None)
        args = (*map(torch.tensor, seqs), torch.from_numpy(mask), cd)
        a = dscan.decoder_tf_scan(p, *args)
        b = dscan.decoder_tf_scan_ref(p, *args)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        with torch.no_grad():  # evaluation: the same outputs, no graph, nothing kept
            c = dscan.decoder_tf_scan(p, *args)
        assert all(torch.equal(x, y) and x.grad_fn is None for x, y in zip(c, b))
    zero = np.zeros_like(px)
    want = _port_grads(dscan.decoder_tf_scan_ref, lstm, att, seqs, mask, (zero, pw),
                       torch.float32)
    got = _port_grads(dscan.decoder_tf_scan, lstm, att, seqs, mask, (zero, pw), torch.float32)
    for w, g in zip(want[6:10] + want[-2:-1], got[6:10] + got[-2:-1]):
        assert np.abs(w).max() > 0 and _rel(w, g) <= 1e-5


def test_the_train_step_calls_the_function(monkeypatch):
    """Tacotron.forward reaches the scan through the Function, never the
    autograd loop."""
    from multi_speaker_tts_tpu_torch.hparams import tiny_test_hparams
    from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
    from multi_speaker_tts_tpu_torch.weights import random_init

    def boom(*a, **k):
        raise AssertionError("the train step ran the autograd loop")

    monkeypatch.setattr(dscan, "decoder_tf_scan_ref", boom)
    calls = []
    apply = dscan._TFScan.apply
    monkeypatch.setattr(dscan._TFScan, "apply", lambda *a: calls.append(1) or apply(*a))
    hp = tiny_test_hparams().replace(Speaker_Embedding={"Type": None})
    taco = Tacotron(hp, torch.float32)
    random_init(hp, torch.Generator().manual_seed(0), tacotron=taco)
    tokens = torch.randint(1, 20, (2, 9))
    out = taco(tokens, torch.tensor([9, 6]), torch.rand(2, 12, hp.Sound.Mel_Dim), train=True,
               generator=torch.Generator().manual_seed(1))
    out["mel_post"].sum().backward()
    assert calls == [1] and taco.decoder.lstm[0].w_ih.grad.abs().max() > 0
