"""The staged Griffin-Lim kernel's plain version and the GEMM Griffin-Lim
against the JAX package (interpret-mode Pallas, XLA) on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.audio import dsp as jdsp
from multi_speaker_tts_tpu.ops import stft_matmul as jstft
from multi_speaker_tts_tpu.ops.griffin_lim_staged import (
    _staged_operands,
    griffin_lim_staged as jax_staged,
)
from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as staged
from multi_speaker_tts_tpu_torch.ops import stft_matmul

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

N_FFT, HOP = 1024, 256


@pytest.fixture(scope="module")
def mag():
    rng = np.random.default_rng(0)
    return (rng.random((2, 16, N_FFT // 2 + 1)).astype(np.float32)) ** 2


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-9)


def test_staged_operands_match(mag):
    fwd, inv, win, syn, perm = _staged_operands("float32")
    ops = staged._operands(torch.device("cpu"), torch.float32)
    for g in range(5):
        for a, b in zip(fwd[g], ops["fwd"][g]):
            np.testing.assert_array_equal(b.numpy(), a)
        for a, b in zip(inv[g], ops["inv"][g]):
            np.testing.assert_array_equal(b.numpy(), a)
    np.testing.assert_array_equal(ops["win"].numpy(), win)
    np.testing.assert_array_equal(ops["syn"].numpy(), syn)
    np.testing.assert_array_equal(ops["perm"].numpy(), perm)


@pytest.mark.parametrize("n_iter", [0, 3])
def test_staged_plain_matches_pallas_interpret_f32(mag, n_iter):
    """Same fixed-point map, f32 leaf products on both sides: agreement to
    f32 rounding (the JAX staged-vs-dense test's 1e-4 relative bound)."""
    want = np.asarray(jax_staged(jnp.asarray(mag), N_FFT, HOP, n_iter,
                                 interpret=True, compute_dtype="float32"))
    got = staged.griffin_lim_staged(torch.from_numpy(mag), N_FFT, HOP, n_iter,
                                    compute_dtype=torch.float32).numpy()
    assert got.shape == want.shape == (2, HOP * 15)
    assert _rel(got, want) < 1e-4


def test_staged_plain_bf16_tracks_pallas_interpret_bf16(mag):
    """bf16 leaf operands and stored magnitudes on both sides; operand
    roundings flip where the two f32 sums differ in their last bit, and
    three iterations amplify that to below 1% of the peak."""
    want = np.asarray(jax_staged(jnp.asarray(mag), N_FFT, HOP, 3, interpret=True))
    got = staged.griffin_lim_staged(torch.from_numpy(mag), N_FFT, HOP, 3).numpy()
    assert _rel(got, want) < 1e-2


def test_griffin_lim_matmul_matches_jax(mag):
    length = HOP * (mag.shape[1] - 1)
    want = np.asarray(jstft.griffin_lim_matmul(jnp.asarray(mag), N_FFT, HOP, 4, length))
    got = stft_matmul.griffin_lim_matmul(torch.from_numpy(mag), N_FFT, HOP, 4, length).numpy()
    assert _rel(got, want) < 1e-4


def test_griffin_lim_auto_is_the_matmul_path_on_cpu(mag):
    length = HOP * (mag.shape[1] - 1)
    a = stft_matmul.griffin_lim_auto(torch.from_numpy(mag), N_FFT, HOP, 2, length)
    b = stft_matmul.griffin_lim_matmul(torch.from_numpy(mag), N_FFT, HOP, 2, length)
    assert torch.equal(a, b)


def test_staged_converges_like_the_gemm_path():
    """The staged iteration re-frames the uncropped signal rows, the GEMM
    path the reflect-padded crop: not elementwise equal, but equally
    converged (the JAX package's 5% spectral-convergence gap)."""
    rng = np.random.default_rng(1)
    T = 24
    mag = rng.random((2, T, N_FFT // 2 + 1)).astype(np.float32) ** 2
    length = HOP * (T - 1)
    m = torch.from_numpy(mag)
    wav_st = staged.griffin_lim_staged(m, N_FFT, HOP, 12, compute_dtype=torch.float32)
    wav_mm = stft_matmul.griffin_lim_matmul(m, N_FFT, HOP, 12, length)

    def sc(w):
        D = np.abs(np.asarray(jdsp.stft(jnp.asarray(w.numpy()), N_FFT, HOP)))[:, :T]
        return np.linalg.norm(D - mag) / np.linalg.norm(mag)

    sc_st, sc_mm = sc(wav_st), sc(wav_mm)
    assert abs(sc_st - sc_mm) / sc_mm <= 0.05, (sc_st, sc_mm)


def test_gl_batch_cap_keeps_working_set_in_l2():
    assert stft_matmul.gl_max_batch(128) >= 4
    assert stft_matmul.gl_max_batch(10**6) == 1
    per_row = 128 * (2 * 640 * 4 + 1024 * 4 + 640 * 2)
    assert stft_matmul.gl_max_batch(128) * per_row <= stft_matmul.GL_L2_BUDGET_BYTES <= 40 << 20


@pytest.mark.parametrize("kwargs, match", [
    (dict(n_fft=512, hop=256, n_iter=1), "n_fft=1024"),
    (dict(n_fft=1024, hop=200, n_iter=1), "128-multiple"),
    (dict(n_fft=1024, hop=256, n_iter=1, momentum=0.99), "momentum"),
])
def test_staged_refuses_what_it_does_not_take(mag, kwargs, match):
    with pytest.raises(NotImplementedError, match=match):
        staged.griffin_lim_staged(torch.from_numpy(mag), **kwargs)
