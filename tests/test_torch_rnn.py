"""Plain versions of the two LSTM kernels (GE2E layer, text-encoder
BiLSTM) against the JAX package's Pallas kernels in interpret mode and its
XLA scans, on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.ops import birnn_pallas, lstm_pallas
from multi_speaker_tts_tpu.ops import lstm as jlstm
from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
from multi_speaker_tts_tpu_torch.ops import lstm as lstm_ops
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

# KERNEL_PARITY.json's lstm_stack_pallas_vs_wavefront / bilstm_pallas_vs_fused
# gates: bf16 operands, f32 accumulation, outputs stored bf16; only the
# order of the f32 sums differs.
BF16_TOL = 5e-3
# f32 everywhere: the two frameworks' f32 matmuls differ only in summation
# order over a few hundred terms.
F32_TOL = 1e-5


def _params(rng, D, H, scale=0.15):
    return (rng.normal(size=(D, 4 * H)) * scale, rng.normal(size=(H, 4 * H)) * scale,
            rng.normal(size=(4 * H,)) * 0.1)


def _jax(p):
    return jlstm.LSTMParams(*(jnp.asarray(a, jnp.float32) for a in p))


def _torch(p):
    return LSTMParams(*(torch.from_numpy(np.asarray(a, np.float32)) for a in p))


@pytest.fixture(scope="module")
def layer():
    rng = np.random.default_rng(11)
    T, B, D, H = 12, 8, 128, 128
    x = rng.normal(size=(T, B, D)).astype(np.float32)
    return _params(rng, D, H), x


def test_ge2e_layer_plain_matches_pallas_interpret(layer):
    p, x = layer
    x_bf = jnp.asarray(x, jnp.bfloat16)
    ys_j, h_j, c_j = lstm_pallas.lstm_seq_layer_fwd(_jax(p), x_bf, interpret=True)
    ys_t, h_t, c_t = lstm_kernel.lstm_seq_layer_plain(
        _torch(p), torch.from_numpy(x).to(torch.bfloat16), torch.bfloat16)
    assert ys_t.dtype == torch.bfloat16 and ys_t.shape == ys_j.shape
    assert np.abs(ys_t.float().numpy() - np.asarray(ys_j, np.float32)).max() <= BF16_TOL
    assert np.abs(h_t.numpy() - np.asarray(h_j)).max() <= BF16_TOL
    assert np.abs(c_t.numpy() - np.asarray(c_j)).max() <= BF16_TOL


def test_ge2e_stack_matches_pallas_stack_interpret():
    rng = np.random.default_rng(3)
    B, T, D, H = 5, 10, 80, 128  # odd rows and a non-lane input width
    ps = [_params(rng, D, H), _params(rng, H, H), _params(rng, H, H)]
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    ys_j, last_j = lstm_pallas.lstm_stack_seq_pallas(
        [_jax(p) for p in ps], jnp.asarray(x), interpret=True)
    ys_t, last_t = lstm_kernel.lstm_stack_seq([_torch(p) for p in ps],
                                              torch.from_numpy(x), torch.bfloat16)
    assert np.abs(ys_t.numpy() - np.asarray(ys_j)).max() <= BF16_TOL
    assert np.abs(last_t.numpy() - np.asarray(last_j)).max() <= BF16_TOL


def test_ge2e_stack_f32_matches_wavefront():
    rng = np.random.default_rng(4)
    B, T, D, H = 3, 9, 16, 32
    ps = [_params(rng, D, H), _params(rng, H, H)]
    x = rng.normal(size=(B, T, D)).astype(np.float32)
    ys_j, last_j = jlstm.lstm_stack_wavefront([_jax(p) for p in ps], jnp.asarray(x))
    ys_t, last_t = lstm_kernel.lstm_stack_seq([_torch(p) for p in ps],
                                              torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=F32_TOL)
    np.testing.assert_allclose(last_t.numpy(), np.asarray(last_j), atol=F32_TOL)


@pytest.fixture(scope="module")
def bi():
    rng = np.random.default_rng(21)
    B, T, D, H = 3, 16, 96, 128
    return _params(rng, D, H), _params(rng, D, H), rng.normal(size=(B, T, D)).astype(np.float32)


def test_bilstm_plain_matches_pallas_interpret(bi):
    pf, pb, x = bi
    want = np.asarray(birnn_pallas.bilstm_pallas(
        _jax(pf), _jax(pb), jnp.asarray(x), compute_dtype=jnp.bfloat16, interpret=True))
    got = birnn_kernel.bilstm(_torch(pf), _torch(pb), torch.from_numpy(x), torch.bfloat16)
    assert got.shape == want.shape == (3, 16, 256)
    assert np.abs(got.numpy() - want).max() <= BF16_TOL


def test_bilstm_f32_matches_fused_scan(bi):
    pf, pb, x = bi
    want = np.asarray(jlstm.bilstm_fused(_jax(pf), _jax(pb), jnp.asarray(x)))
    got = birnn_kernel.bilstm(_torch(pf), _torch(pb), torch.from_numpy(x), torch.float32)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_f32_matches_jax_lstm(bi, reverse):
    pf, _, x = bi
    ys_j, (h_j, c_j) = jlstm.lstm(_jax(pf), jnp.asarray(x), reverse=reverse)
    ys_t, (h_t, c_t) = lstm_ops.lstm(_torch(pf), torch.from_numpy(x), reverse=reverse)
    np.testing.assert_allclose(ys_t.numpy(), np.asarray(ys_j), atol=F32_TOL)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), atol=F32_TOL)
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j), atol=F32_TOL)


def test_bilstm_directions_are_independent(bi):
    """The backward direction reads time reversed: reversing the input
    swaps the roles of the two outputs when both directions share weights."""
    pf, _, x = bi
    p = _torch(pf)
    xt = torch.from_numpy(x)
    y = birnn_kernel.bilstm(p, p, xt, torch.float32)
    y_rev = birnn_kernel.bilstm(p, p, xt.flip(1), torch.float32)
    H = y.shape[-1] // 2
    np.testing.assert_allclose(y[..., :H].numpy(), y_rev[..., H:].flip(1).numpy(), atol=1e-6)


@pytest.mark.parametrize("fn", ["lstm", "bilstm"])
def test_wrappers_refuse_f32_on_the_card(fn, monkeypatch):
    """On a CUDA tensor a wrapper launches its kernel or raises; the
    kernels compute in bf16 only, so f32 compute raises rather than taking
    the plain path."""
    x = torch.zeros(2, 2, 8)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    p = LSTMParams(torch.zeros(8, 32), torch.zeros(8, 32), torch.zeros(32))
    with pytest.raises(NotImplementedError, match="bf16"):
        if fn == "lstm":
            lstm_kernel.lstm_seq_layer_fwd(p, x, torch.float32)
        else:
            birnn_kernel.bilstm_recurrence(x.repeat(1, 1, 4), x.repeat(1, 1, 4),
                                           p.w_hh, p.w_hh, torch.float32)
