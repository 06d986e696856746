"""Numpy / scipy reference DSP (the port's own copy of
``multi_speaker_tts_tpu.audio.oracle``): preemphasis, a centered STFT with a
periodic Hann window, the mel projection, 20 log10 dB compression with a
-100 dB floor, [0, 1] normalization, Griffin-Lim and an energy-based silence
trim. The offline pattern generator computes its features with it, so that
both packages write the same patterns.
"""

from __future__ import annotations

import numpy as np
from scipy import signal as sps

from multi_speaker_tts_tpu_torch.audio.mel_filterbank import mel_filterbank

_AMP_FLOOR = 1e-5  # keithito/Tacotron-style amp_to_db floor


def hann_window(win_length: int, dtype=np.float64) -> np.ndarray:
    """Periodic Hann window (scipy ``get_window('hann', N, fftbins=True)``)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(dtype)


def preemphasis(wav: np.ndarray, coef: float = 0.97) -> np.ndarray:
    """y[n] = x[n] - coef * x[n-1] (FIR, as in the reference front-end)."""
    return sps.lfilter([1.0, -coef], [1.0], wav).astype(wav.dtype)


def inv_preemphasis(wav: np.ndarray, coef: float = 0.97) -> np.ndarray:
    """Exact IIR inverse of ``preemphasis``."""
    return sps.lfilter([1.0], [1.0, -coef], wav).astype(wav.dtype)


def frame_signal(wav: np.ndarray, n_fft: int, hop: int, center: bool = True) -> np.ndarray:
    """Slice a 1-D signal into overlapping frames, shape (n_frames, n_fft)."""
    if center:
        wav = np.pad(wav, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(wav) - n_fft) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(n_fft)[None, :]
    return wav[idx]


def stft(wav: np.ndarray, n_fft: int, hop: int, center: bool = True) -> np.ndarray:
    """Complex STFT, shape (n_frames, n_fft // 2 + 1). Librosa-centered."""
    frames = frame_signal(np.asarray(wav, dtype=np.float64), n_fft, hop, center)
    win = hann_window(n_fft)
    return np.fft.rfft(frames * win[None, :], axis=-1)


def istft(spec: np.ndarray, n_fft: int, hop: int, length: int | None = None,
          center: bool = True) -> np.ndarray:
    """Inverse STFT via windowed overlap-add with window-square normalization."""
    frames = np.fft.irfft(spec, n=n_fft, axis=-1)  # (n_frames, n_fft)
    win = hann_window(n_fft)
    n_frames = frames.shape[0]
    out_len = n_fft + hop * (n_frames - 1)
    out = np.zeros(out_len, dtype=np.float64)
    win_sum = np.zeros(out_len, dtype=np.float64)
    wsq = win * win
    for t in range(n_frames):
        start = t * hop
        out[start : start + n_fft] += frames[t] * win
        win_sum[start : start + n_fft] += wsq
    out = out / np.maximum(win_sum, 1e-11)
    if center:
        out = out[n_fft // 2 :]
    if length is None and center:
        # Default to hop * (n_frames - 1) samples so a centered re-STFT
        # produces exactly n_frames again (Griffin-Lim round-trip invariant).
        length = hop * (n_frames - 1)
    if length is not None:
        out = out[:length]
    return out


def amp_to_db(x: np.ndarray) -> np.ndarray:
    return 20.0 * np.log10(np.maximum(_AMP_FLOOR, x))


def db_to_amp(x: np.ndarray) -> np.ndarray:
    return np.power(10.0, x * 0.05)


def normalize(S_db: np.ndarray, min_level_db: float = -100.0) -> np.ndarray:
    """[0,1] normalization via min_level_db."""
    return np.clip((S_db - min_level_db) / (-min_level_db), 0.0, 1.0)


def denormalize(S_norm: np.ndarray, min_level_db: float = -100.0) -> np.ndarray:
    return np.clip(S_norm, 0.0, 1.0) * (-min_level_db) + min_level_db


def spectrogram(wav: np.ndarray, hp) -> np.ndarray:
    """Normalized linear spectrogram, shape (n_frames, Spectrogram_Dim)."""
    y = preemphasis(np.asarray(wav, dtype=np.float64), hp.Sound.Preemphasis)
    D = np.abs(stft(y, hp.Sound.Frame_Length, hp.Sound.Frame_Shift))
    S = amp_to_db(D) - hp.Sound.Ref_Level_DB
    return normalize(S, hp.Sound.Min_Level_DB).astype(np.float32)


def melspectrogram(wav: np.ndarray, hp) -> np.ndarray:
    """Normalized log-mel spectrogram, shape (n_frames, Mel_Dim)."""
    y = preemphasis(np.asarray(wav, dtype=np.float64), hp.Sound.Preemphasis)
    D = np.abs(stft(y, hp.Sound.Frame_Length, hp.Sound.Frame_Shift))
    basis = mel_filterbank(
        hp.Sound.Sample_Rate,
        hp.Sound.Frame_Length,
        hp.Sound.Mel_Dim,
        hp.Sound.Mel_F_Min,
        hp.Sound.get("Mel_F_Max"),
        dtype=np.float64,
    )
    M = D @ basis.T
    S = amp_to_db(M) - hp.Sound.Ref_Level_DB
    return normalize(S, hp.Sound.Min_Level_DB).astype(np.float32)


def griffin_lim(magnitude: np.ndarray, n_fft: int, hop: int, n_iter: int,
                length: int | None = None) -> np.ndarray:
    """Phase recovery from magnitude (n_frames, n_fft//2+1), zero init phase."""
    angles = np.ones_like(magnitude, dtype=np.complex128)
    y = istft(magnitude * angles, n_fft, hop, length)
    for _ in range(n_iter):
        D = stft(y, n_fft, hop)
        D = D[: magnitude.shape[0]]
        phase = D / np.maximum(np.abs(D), 1e-11)
        y = istft(magnitude * phase, n_fft, hop, length)
    return y


def inv_spectrogram(S_norm: np.ndarray, hp) -> np.ndarray:
    """Normalized linear spectrogram -> waveform (Griffin-Lim + de-preemphasis)."""
    S_db = denormalize(np.asarray(S_norm, dtype=np.float64), hp.Sound.Min_Level_DB)
    mag = db_to_amp(S_db + hp.Sound.Ref_Level_DB)
    wav = griffin_lim(
        mag ** hp.Sound.Power,
        hp.Sound.Frame_Length,
        hp.Sound.Frame_Shift,
        hp.Sound.Griffin_Lim_Iter,
    )
    return inv_preemphasis(wav, hp.Sound.Preemphasis).astype(np.float32)


def trim_silence(wav: np.ndarray, top_db: float = 60.0, frame_length: int = 2048,
                 hop: int = 512) -> np.ndarray:
    """Energy-based leading/trailing silence trim (librosa.effects.trim)."""
    wav = np.asarray(wav)
    if len(wav) < frame_length:
        return wav
    n_frames = 1 + (len(wav) - frame_length) // hop
    idx = np.arange(n_frames)[:, None] * hop + np.arange(frame_length)[None, :]
    rms = np.sqrt(np.mean(wav[idx].astype(np.float64) ** 2, axis=-1))
    threshold = rms.max() * (10.0 ** (-top_db / 20.0))
    keep = np.nonzero(rms > threshold)[0]
    if len(keep) == 0:
        return wav
    start = keep[0] * hop
    end = min(len(wav), keep[-1] * hop + frame_length)
    return wav[start:end]
