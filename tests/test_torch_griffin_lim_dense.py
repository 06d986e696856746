"""The dense Griffin-Lim kernel's plain version against the JAX package's
``griffin_lim_pallas`` in interpret mode, on the same seeded magnitudes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.audio import oracle
from multi_speaker_tts_tpu.ops import griffin_lim_kernel as jgk
from multi_speaker_tts_tpu_torch.ops import griffin_lim_kernel as gk

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

SHAPES = [(256, 64, 33), (512, 128, 20)]  # n_fft, hop, T


def _mag(n_fft, T, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((2, T, n_fft // 2 + 1)) ** 2).astype(np.float32)


def _rel(a, b, peak=None):
    return np.abs(a - b).max() / max(np.abs(b if peak is None else peak).max(), 1e-9)


def _jax(mag, n_fft, hop, n_iter, dtype, momentum):
    return np.asarray(jgk.griffin_lim_pallas(jnp.asarray(mag), n_fft, hop, n_iter,
                                             interpret=True, compute_dtype=dtype,
                                             momentum=momentum))


@pytest.mark.parametrize("n_fft, hop", [(256, 64), (512, 128), (1024, 256)])
def test_operands_bit_equal_to_jax(n_fft, hop):
    want = jgk._gl_operands(n_fft, hop, "float32")
    got = gk._gl_operands(n_fft, hop)
    assert got[-1] == want[-1]
    for a, b in zip(got[:-1], want[:-1]):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    T = 20
    rows_pad = jgk._round_up(T + n_fft // hop - 1, 8)
    np.testing.assert_array_equal(gk._wsum_rows(n_fft, hop, T, rows_pad),
                                  jgk._wsum_rows(n_fft, hop, T, rows_pad))


@pytest.mark.parametrize("momentum", [0.0, 0.99])
@pytest.mark.parametrize("n_fft, hop, T", SHAPES)
def test_plain_matches_pallas_interpret_f32(n_fft, hop, T, momentum):
    """The same iteration, f32 products on both sides: agreement to f32
    summation order."""
    mag = _mag(n_fft, T)
    want = _jax(mag, n_fft, hop, 4, "float32", momentum)
    got = gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 4,
                               compute_dtype=torch.float32, momentum=momentum).numpy()
    assert got.shape == want.shape == (2, hop * (T - 1))
    assert _rel(got, want) <= 1e-4


@pytest.mark.parametrize("momentum", [0.0, 0.99])
@pytest.mark.parametrize("n_fft, hop, T", SHAPES)
def test_plain_bf16_tracks_pallas_interpret_bf16(n_fft, hop, T, momentum):
    """bf16 matrices and operands on both sides: operand roundings flip
    where the two f32 sums differ in their last bit; within 5% of the f32
    result's peak (the JAX package's own bf16 quality gate)."""
    mag = _mag(n_fft, T, seed=1)
    want = _jax(mag, n_fft, hop, 4, "bfloat16", momentum)
    peak = _jax(mag, n_fft, hop, 4, "float32", momentum)
    got = gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 4,
                               momentum=momentum).numpy()
    assert _rel(got, want, peak) <= 5e-2


def test_reconstructs_nyquist_energy():
    """The port of the JAX package's ``test_gl_kernel_reconstructs_nyquist_energy``:
    all the energy in the Nyquist bin, which rides outside the products."""
    n_fft, hop, T = 256, 64, 33
    mag = np.full((1, T, n_fft // 2 + 1), 1e-3, np.float32)
    mag[..., -1] = 1.0
    y = gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 8,
                             compute_dtype=torch.float32).numpy()[0]
    rec = np.abs(oracle.stft(y, n_fft, hop))[:T - 2]
    assert rec[2:, -1].mean() > 0.5, rec[2:, -1].mean()
    assert rec[2:, -1].mean() > 10 * rec[2:, :-1].mean()


def test_momentum_converges_tighter():
    """Accelerated Griffin-Lim reaches better spectral consistency at the
    same iteration count (the JAX package's ``test_momentum_gl_converges_tighter``)."""
    n_fft, hop, T = 256, 64, 33
    t = np.arange(hop * (T - 1)) / 16000.0
    wav = (np.sin(2 * np.pi * 220 * t) + 0.5 * np.sin(2 * np.pi * 1330 * t)) * np.hanning(t.size)
    mag = np.abs(oracle.stft(wav.astype(np.float32), n_fft, hop))[None, :T].astype(np.float32)

    def consistency(y):
        rec = np.abs(oracle.stft(y, n_fft, hop))[:T]
        return np.abs(rec - mag[0]).mean() / np.abs(mag[0]).mean()

    plain, fast = (consistency(gk.griffin_lim_dense(torch.from_numpy(mag), n_fft, hop, 12,
                                                    compute_dtype=torch.float32,
                                                    momentum=m).numpy()[0])
                   for m in (0.0, 0.99))
    assert fast < plain, (fast, plain)


def test_odd_ratio_raises():
    with pytest.raises(ValueError, match="even"):
        gk.griffin_lim_dense(torch.zeros(1, 8, 97), 192, 64, 2)
    with pytest.raises(ValueError, match="bins"):
        gk.griffin_lim_dense(torch.zeros(1, 8, 100), 256, 64, 2)


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    mag = torch.from_numpy(_mag(256, 9))
    before = gk.KERNEL.launches
    gk.griffin_lim_dense(mag, 256, 64, 1)
    assert gk.KERNEL.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        gk.griffin_lim_dense_kernel(*gk.split_magnitude(mag, 256), 256, 64, 1)
    assert gk.KERNEL.launches == before
