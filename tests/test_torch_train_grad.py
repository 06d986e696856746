"""Gradients of the port's recurrence Functions and of its teacher-forced
decoder scan against the JAX package, on the same numpy inputs.

- The three recurrences with a backward kernel (GE2E LSTM stack, text-
  encoder BiLSTM, CBHG BiGRU) in bf16: the port's autograd Functions on the
  CPU (their plain forward with residuals and plain backward, through the
  same residual layout and deferred products as the card) against
  ``jax.grad`` of the Pallas functions in interpret mode, by the JAX tests'
  own measure (max |diff| / max |reference|) and limits: 2e-2 for the
  stack, 3e-2 for BiLSTM and BiGRU (bf16 residuals and dG on both sides,
  rounded at different places by f32 sums in another order).
- The same Functions in f32 against ``jax.grad`` of the XLA references:
  no rounding anywhere, so 1e-4.
- The residual outputs of the forward kernels' plain versions against the
  Pallas kernels' ``save_residuals=True`` outputs, and the GE2E layer's
  plain backward against ``lstm_seq_layer_bwd`` on identical residuals.
- The teacher-forced scan (autograd through the Python loop) against
  ``decoder_tf_scan`` (the hand-written custom VJP) in f32: 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.ops import birnn_pallas, lstm_pallas
from multi_speaker_tts_tpu.ops import decoder_scan as jdscan
from multi_speaker_tts_tpu.ops import gru as jgru
from multi_speaker_tts_tpu.ops import lstm as jlstm
from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
from multi_speaker_tts_tpu_torch.ops.gru import GRUParams
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

LSTM_STACK_TOL = 2e-2  # tests/test_lstm_pallas.py's gradient gate
BIRNN_TOL = 3e-2  # tests/test_birnn_pallas.py's gradient gates
F32_TOL = 1e-4


def _rel(a, b) -> float:
    """The JAX tests' measure: max |a - b| over max |a|, a the reference."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-9))


def _arrays(rng, shapes, scale=0.15):
    return [(rng.normal(size=s) * (0.1 if len(s) == 1 else scale)).astype(np.float32)
            for s in shapes]


def _leaf(a, requires_grad=True):
    return torch.tensor(a, requires_grad=requires_grad)


def _probe(shape, fn=np.cos):
    return fn(np.arange(int(np.prod(shape))).reshape(shape) * 0.01).astype(np.float32)


# -- GE2E LSTM stack -----------------------------------------------------------


def _stack(rng, D, H, L):
    out, d = [], D
    for _ in range(L):
        out.append(_arrays(rng, [(d, 4 * H), (H, 4 * H), (4 * H,)]))
        d = H
    return out


def _stack_grads(layers, x, dtype, jax_fn):
    """(JAX grads, port grads) of sum(h_T * cos) + sum(ys * sin): the
    cotangents of both outputs, so the last layer's per-step path runs."""
    B, T, _ = x.shape
    H = layers[-1][1].shape[0]
    ph, py = _probe((B, H)), _probe((B, T, H), np.sin)

    def jloss(ls, xx):
        ys, h = jax_fn([jlstm.LSTMParams(*p) for p in ls], xx)
        return (h * ph).sum() + (ys * py).sum()

    jg = jax.grad(jloss, argnums=(0, 1))([tuple(map(jnp.asarray, p)) for p in layers],
                                         jnp.asarray(x))
    tl = [[_leaf(a) for a in p] for p in layers]
    tx = _leaf(x)
    ys, h = lstm_kernel.lstm_stack_seq([LSTMParams(*p) for p in tl], tx, dtype)
    ((h * torch.from_numpy(ph)).sum() + (ys * torch.from_numpy(py)).sum()).backward()
    return jg, ([[a.grad for a in p] for p in tl], tx.grad)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_lstm_stack_function_grads(dtype):
    rng = np.random.default_rng(11)
    B, T, D, H = 8, 12, 80, 128
    layers = _stack(rng, D, H, 3)
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    if dtype == "bf16":
        fn, tdt, tol = (lambda ls, xx: lstm_pallas.lstm_stack_seq_pallas(ls, xx, interpret=True),
                        torch.bfloat16, LSTM_STACK_TOL)
    else:
        fn, tdt, tol = lambda ls, xx: jlstm.lstm_stack_wavefront(ls, xx), torch.float32, F32_TOL
    (jl, jx), (tl, tx) = _stack_grads(layers, x, tdt, fn)
    for jp, tp in zip(jl, tl):
        for a, b in zip(jp, tp):
            assert _rel(a, b.numpy()) < tol
    assert _rel(jx, tx.numpy()) < tol


def test_lstm_layer_residuals_and_backward_match_pallas():
    """Residual mode and the reverse kernel's plain version, each on the
    Pallas kernel's own inputs."""
    rng = np.random.default_rng(12)
    T, B, D, H = 10, 8, 128, 128
    w_ih, w_hh, b = _arrays(rng, [(D, 4 * H), (H, 4 * H), (4 * H,)])
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    jp = jlstm.LSTMParams(jnp.asarray(w_ih), jnp.asarray(w_hh), jnp.asarray(b))
    outs = lstm_pallas.lstm_seq_layer_fwd(jp, jnp.asarray(x, jnp.bfloat16),
                                          save_residuals=True, interpret=True)
    tp = LSTMParams(torch.from_numpy(w_ih), torch.from_numpy(w_hh), torch.from_numpy(b))
    got = lstm_kernel.lstm_seq_layer_plain(tp, torch.from_numpy(x).to(torch.bfloat16),
                                           torch.bfloat16, save_residuals=True)
    assert len(got) == len(outs) == 5
    for j, t in zip(outs, got):  # ys, h_T, c_T, gates, c_prev
        assert t.shape == j.shape
        assert _rel(np.asarray(j, np.float32), t.float().numpy()) <= 1e-2
    gates, c_prev = outs[3], outs[4]
    d_hT = rng.normal(size=(B, H)).astype(np.float32)
    d_ys = rng.normal(size=(T, B, H)).astype(np.float32)
    want = lstm_pallas.lstm_seq_layer_bwd(jnp.asarray(w_hh), gates, c_prev, jnp.asarray(d_hT),
                                          jnp.asarray(d_ys), interpret=True)
    dG = lstm_kernel.lstm_seq_layer_bwd_plain(
        torch.from_numpy(w_hh), torch.from_numpy(np.asarray(gates, np.float32)).to(torch.bfloat16),
        torch.from_numpy(np.asarray(c_prev, np.float32)).to(torch.bfloat16),
        torch.from_numpy(d_hT), torch.from_numpy(d_ys), torch.bfloat16)
    assert dG.dtype == torch.bfloat16 and dG.shape == want.shape
    # bf16 dG from the same bf16 residuals: only the f32 sums of the carried
    # dh differ in order, and a rounding may flip where they do.
    assert _rel(np.asarray(want, np.float32), dG.float().numpy()) <= 1e-2


# -- BiLSTM and BiGRU ---------------------------------------------------------------


def _bi_grads(fwd, bwd, x, params_cls, jax_fn, port_fn, dtype, probe_fn):
    B, T, _ = x.shape
    H = fwd[1].shape[0]
    probe = _probe((B, T, 2 * H), probe_fn)

    def jloss(ps, xx):
        return (jax_fn(ps[0], ps[1], xx) * probe).sum()

    jcls = {LSTMParams: jlstm.LSTMParams, GRUParams: jgru.GRUParams}[params_cls]
    jg = jax.grad(jloss, argnums=(0, 1))(
        (jcls(*map(jnp.asarray, fwd)), jcls(*map(jnp.asarray, bwd))), jnp.asarray(x))
    tf, tb, tx = [_leaf(a) for a in fwd], [_leaf(a) for a in bwd], _leaf(x)
    out = port_fn(params_cls(*tf), params_cls(*tb), tx, dtype)
    (out * torch.from_numpy(probe)).sum().backward()
    return jg, ([a.grad for a in tf], [a.grad for a in tb], tx.grad)


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_bilstm_function_grads(dtype):
    rng = np.random.default_rng(21)
    B, T, D, H = 8, 11, 72, 128
    fwd, bwd = (_arrays(rng, [(D, 4 * H), (H, 4 * H), (4 * H,)]) for _ in range(2))
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    if dtype == "bf16":
        fn = lambda f, b, xx: birnn_pallas.bilstm_pallas(f, b, xx, interpret=True)  # noqa: E731
        tdt, tol = torch.bfloat16, BIRNN_TOL
    else:
        fn, tdt, tol = jlstm.bilstm_fused, torch.float32, F32_TOL
    (jp, jx), (tf, tb, tx) = _bi_grads(fwd, bwd, x, LSTMParams, fn, birnn_kernel.bilstm, tdt,
                                       np.cos)
    for jd, td in zip(jp, (tf, tb)):
        for a, b in zip(jd, td):
            assert _rel(a, b.numpy()) < tol
    assert _rel(jx, tx.numpy()) < tol


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
def test_bigru_function_grads(dtype):
    rng = np.random.default_rng(22)
    B, T, D, H = 8, 13, 72, 128
    fwd, bwd = (_arrays(rng, [(D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,)]) for _ in range(2))
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    if dtype == "bf16":
        fn = lambda f, b, xx: birnn_pallas.bigru_pallas(f, b, xx, interpret=True)  # noqa: E731
        tdt, tol = torch.bfloat16, BIRNN_TOL
    else:
        fn, tdt, tol = jgru.bigru_fused, torch.float32, F32_TOL
    (jp, jx), (tf, tb, tx) = _bi_grads(fwd, bwd, x, GRUParams, fn, birnn_kernel.bigru, tdt,
                                       np.sin)
    for jd, td in zip(jp, (tf, tb)):
        for a, b in zip(jd, td):  # w_ih, w_hh, b_ih, b_hh: the biases apart
            assert _rel(a, b.numpy()) < tol
    assert _rel(jx, tx.numpy()) < tol


def test_birnn_residuals_match_pallas():
    """The plain forward's residuals against the Pallas kernels' own
    (``save_residuals=True``) on the same hoisted bf16 gates."""
    rng = np.random.default_rng(23)
    T, B, H = 9, 8, 128
    whf, whb = _arrays(rng, [(H, 4 * H), (H, 4 * H)])
    gxf, gxb = (rng.normal(size=(T, B, 4 * H)).astype(np.float32) for _ in range(2))
    jl = lambda w: jlstm.LSTMParams(None, jnp.asarray(w), None)  # noqa: E731
    want = birnn_pallas._bilstm_fwd_impl(jl(whf), jl(whb), jnp.asarray(gxf, jnp.bfloat16),
                                         jnp.asarray(gxb, jnp.bfloat16), True, True)
    got = birnn_kernel.bilstm_recurrence_plain(
        *(torch.from_numpy(g).to(torch.bfloat16) for g in (gxf, gxb)),
        torch.from_numpy(whf), torch.from_numpy(whb), torch.bfloat16, save_residuals=True)
    assert len(got) == len(want) == 6  # ysf, ysb, gf, cf, gb, cb
    for j, t in zip(want, got):
        assert t.shape == j.shape and _rel(np.asarray(j, np.float32), t.float().numpy()) <= 1e-2

    gw = _arrays(rng, [(H, 3 * H), (3 * H,), (H, 3 * H), (3 * H,)])
    gx3 = [rng.normal(size=(T, B, 3 * H)).astype(np.float32) for _ in range(2)]
    jg = [jgru.GRUParams(None, jnp.asarray(gw[i]), None, jnp.asarray(gw[i + 1]))
          for i in (0, 2)]
    want = birnn_pallas._bigru_fwd_impl(*jg, *(jnp.asarray(g, jnp.bfloat16) for g in gx3),
                                        True, True)
    tg = [GRUParams(None, torch.from_numpy(gw[i]), None, torch.from_numpy(gw[i + 1]))
          for i in (0, 2)]
    got = birnn_kernel.bigru_recurrence_plain(
        *(torch.from_numpy(g).to(torch.bfloat16) for g in gx3), *tg, torch.bfloat16,
        save_residuals=True)
    assert len(got) == len(want) == 6  # ysf, ysb, ghf, hpf, ghb, hpb
    for j, t in zip(want, got):
        assert t.shape == j.shape and _rel(np.asarray(j, np.float32), t.float().numpy()) <= 1e-2


# -- the teacher-forced decoder scan -----------------------------------------------


def test_decoder_tf_scan_grads_match_custom_vjp():
    rng = np.random.default_rng(31)
    T, B, S, P, Dm, H, A, K, C = 7, 3, 10, 16, 24, 32, 16, 7, 4
    lstm = [_arrays(rng, [(P + Dm, 4 * H), (H, 4 * H), (4 * H,)]),
            _arrays(rng, [(H + Dm, 4 * H), (H, 4 * H), (4 * H,)])]
    att = _arrays(rng, [(H, A), (K, 2, C), (C, A), (A, 1)], scale=0.3)
    pre = rng.normal(size=(T, B, P)).astype(np.float32)
    keys = (rng.normal(size=(B, S, A)) * 0.5).astype(np.float32)
    memory = (rng.normal(size=(B, S, Dm)) * 0.5).astype(np.float32)
    mask = (np.arange(S)[None] < np.array([S, 7, 4])[:, None]).astype(np.float32)
    px = _probe((T, B, H + Dm))
    pw = _probe((T, B, S), np.sin)

    def jloss(lp, ap, pre_, keys_, mem_):
        p = jdscan.DecoderScanParams(tuple(jlstm.LSTMParams(*q) for q in lp),
                                     jdscan.AttentionParams(*ap))
        xs, ws = jdscan.decoder_tf_scan(p, pre_, keys_, mem_, jnp.asarray(mask))
        return (xs * px).sum() + (ws * pw).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        [tuple(map(jnp.asarray, q)) for q in lstm], tuple(map(jnp.asarray, att)),
        *map(jnp.asarray, (pre, keys, memory)))

    tlstm = [[_leaf(a) for a in q] for q in lstm]
    tatt = [_leaf(a) for a in att]
    tpre, tkeys, tmem = _leaf(pre), _leaf(keys), _leaf(memory)
    p = dscan.DecoderParams(tuple(LSTMParams(*q) for q in tlstm), dscan.AttentionParams(*tatt),
                            frame_proj=None, stop_proj=None)
    xs, ws = dscan.decoder_tf_scan(p, tpre, tkeys, tmem, torch.from_numpy(mask))
    ((xs * torch.from_numpy(px)).sum() + (ws * torch.from_numpy(pw)).sum()).backward()

    got = [[a.grad for a in q] for q in tlstm]
    for jq, tq in zip(jg[0], got):
        for a, b in zip(jq, tq):
            assert _rel(a, b.numpy()) <= F32_TOL
    for a, b in zip(jg[1], tatt):
        assert _rel(a, b.grad.numpy()) <= F32_TOL
    for a, b in zip(jg[2:], (tpre, tkeys, tmem)):
        assert _rel(a, b.grad.numpy()) <= F32_TOL
