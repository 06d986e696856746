"""Torch port of the audio front-end and the mel kernel's plain version,
held against the JAX package on the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.signal import lfilter

from multi_speaker_tts_tpu.audio import dsp as jdsp
from multi_speaker_tts_tpu.hparams import default_hparams
from multi_speaker_tts_tpu.ops.mel_kernel import melspectrogram_pallas
from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.ops import mel_kernel

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

# The JAX package's own front-end budget (README "Mel parity <= 1e-4").
MEL_TOL = 1e-4


@pytest.fixture(scope="module")
def cfgs():
    hp = default_hparams()
    return jdsp.DSPConfig.from_hp(hp), dsp.DSPConfig.from_hp(hp)


@pytest.fixture(scope="module")
def wav(speech_like_wav):
    hop = 256
    w = speech_like_wav[: (len(speech_like_wav) // hop) * hop]
    rng = np.random.default_rng(5)
    return np.stack([w, 0.3 * rng.standard_normal(len(w)).astype(np.float32)])


def test_dsp_config_and_basis_match(cfgs):
    jcfg, cfg = cfgs
    assert cfg.n_fft == jcfg.n_fft and cfg.hop == jcfg.hop
    np.testing.assert_array_equal(cfg.mel_basis, jcfg.mel_basis)


def test_mel_plain_matches_jax_rfft_path(cfgs, wav):
    jcfg, cfg = cfgs
    want = np.asarray(jdsp.melspectrogram(jnp.asarray(wav), jcfg))
    got = mel_kernel.melspectrogram_fused(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (2, 1 + wav.shape[-1] // cfg.hop, cfg.n_mels)
    assert np.abs(got - want).max() <= MEL_TOL


def test_mel_plain_matches_pallas_interpret(cfgs, wav):
    jcfg, cfg = cfgs
    short = wav[:, : 32 * cfg.hop]
    want = np.asarray(melspectrogram_pallas(jnp.asarray(short), jcfg, interpret=True))
    got = dsp.melspectrogram_auto(torch.from_numpy(short), cfg).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= MEL_TOL


def test_fft_melspectrogram_matches_jax(cfgs, wav):
    jcfg, cfg = cfgs
    want = np.asarray(jdsp.melspectrogram(jnp.asarray(wav), jcfg))
    got = dsp.melspectrogram(torch.from_numpy(wav), cfg).numpy()
    assert np.abs(got - want).max() <= MEL_TOL


def test_front_end_rejects_ragged_lengths(cfgs, wav):
    _, cfg = cfgs
    with pytest.raises(ValueError, match="multiple of hop"):
        mel_kernel.melspectrogram_fused(torch.from_numpy(wav[:, :1000]), cfg)


@pytest.mark.parametrize("n", [1, 200, 256, 257, 70000])
def test_inv_preemphasis_is_the_exact_iir(n):
    """Against scipy's f64 IIR; 70000 samples take three block levels."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((2, n)).astype(np.float32)
    want = lfilter([1.0], [1.0, -0.97], x.astype(np.float64), axis=-1)
    got = dsp.inv_preemphasis(torch.from_numpy(x), 0.97).numpy()
    # f32 blocks: rounding at the 1e-6 relative level of the output.
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
    back = dsp.preemphasis(torch.from_numpy(got), 0.97).numpy()
    np.testing.assert_allclose(back, x, atol=2e-4 * np.abs(want).max())


def test_normalize_db_round_trip():
    x = torch.linspace(1e-4, 10.0, 50)
    db = dsp.amp_to_db(x) - 20.0
    back = dsp.db_to_amp(dsp.denormalize(dsp.normalize(db, -100.0), -100.0) + 20.0)
    np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-4)
