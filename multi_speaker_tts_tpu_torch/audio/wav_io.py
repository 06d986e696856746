"""WAV read/write + resampling with scipy only (no librosa/soundfile).

The port's own copy of ``multi_speaker_tts_tpu.audio.wav_io``:
scipy.io.wavfile plus a polyphase resampler.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy import signal as sps


def load_wav(path, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim > 1:
        wav = wav.mean(axis=1)
    if target_sr is not None and target_sr != sr:
        wav = resample(wav, sr, target_sr)
        sr = target_sr
    return wav, sr


def save_wav(path, wav: np.ndarray, sample_rate: int) -> None:
    """Write a float waveform as 16-bit PCM, peak-normalized if clipping.
    int16 input (e.g. ``synthesize(..., pcm16=True)``) is written as-is."""
    wav = np.asarray(wav)
    if wav.dtype == np.int16:
        wavfile.write(path, sample_rate, wav)
        return
    wav = wav.astype(np.float32)
    peak = np.max(np.abs(wav)) if wav.size else 0.0
    if peak > 1.0:
        wav = wav / peak
    wavfile.write(path, sample_rate, (wav * 32767.0).astype(np.int16))


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling (scipy), e.g. VCTK 48 kHz -> model rate."""
    if orig_sr == target_sr:
        return wav
    g = np.gcd(int(orig_sr), int(target_sr))
    return sps.resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)
