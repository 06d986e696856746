"""Slaney-style mel filterbank, librosa-compatible, in pure numpy.

The port's own copy of ``multi_speaker_tts_tpu.audio.mel_filterbank``:
``librosa.filters.mel`` (htk=False, norm='slaney') reimplemented from the
Slaney Auditory Toolbox formulas, so both packages build the same basis.
"""

from __future__ import annotations

import numpy as np


def _hz_to_mel_slaney(frequencies: np.ndarray) -> np.ndarray:
    frequencies = np.asarray(frequencies, dtype=np.float64)
    f_min = 0.0
    f_sp = 200.0 / 3
    mels = (frequencies - f_min) / f_sp
    # Log-scale region above 1 kHz.
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = frequencies >= min_log_hz
    mels = np.where(
        log_region,
        min_log_mel + np.log(np.maximum(frequencies, min_log_hz) / min_log_hz) / logstep,
        mels,
    )
    return mels


def _mel_to_hz_slaney(mels: np.ndarray) -> np.ndarray:
    mels = np.asarray(mels, dtype=np.float64)
    f_min = 0.0
    f_sp = 200.0 / 3
    freqs = f_min + f_sp * mels
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    log_region = mels >= min_log_mel
    freqs = np.where(
        log_region,
        min_log_hz * np.exp(logstep * (np.maximum(mels, min_log_mel) - min_log_mel)),
        freqs,
    )
    return freqs


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    f_min: float = 0.0,
    f_max: float | None = None,
    dtype=np.float32,
) -> np.ndarray:
    """Triangular mel filterbank, shape ``(n_mels, n_fft // 2 + 1)``.

    Matches ``librosa.filters.mel(sr, n_fft, n_mels, fmin, fmax)`` defaults:
    Slaney mel scale, Slaney area normalization (2 / bandwidth).
    """
    if f_max is None:
        f_max = sample_rate / 2.0

    n_freqs = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_freqs, dtype=np.float64)

    mel_min = _hz_to_mel_slaney(np.array([f_min]))[0]
    mel_max = _hz_to_mel_slaney(np.array([f_max]))[0]
    mel_pts = np.linspace(mel_min, mel_max, n_mels + 2)
    hz_pts = _mel_to_hz_slaney(mel_pts)  # (n_mels + 2,)

    fdiff = np.diff(hz_pts)  # (n_mels + 1,)
    ramps = hz_pts[:, None] - fft_freqs[None, :]  # (n_mels + 2, n_freqs)

    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_freqs)

    # Slaney normalization: constant filter energy per band.
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    weights *= enorm[:, None]

    return weights.astype(dtype)
