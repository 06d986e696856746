"""Plain signal processing of the reference: the normalized log-mel in
float32, the transform as a product with an explicit DFT table (built in
float64) so that the control rounds its operands (:mod:`.lowp`).

The conventions are the configuration's (``Sound``): pre-emphasis 0.97,
centred frames reflect-padded by n_fft / 2, a periodic Hann window, the
magnitude, a Slaney mel basis (librosa's ``filters.mel`` defaults), 20
log10 with an amplitude floor of 1e-5, minus ``Ref_Level_DB``, normalized
over ``Min_Level_DB``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.lowp import FULL, Arith

AMP_FLOOR = 1e-5


def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz,
                    min_log_hz / f_sp + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep,
                    f / f_sp)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel,
                    min_log_hz * np.exp(logstep * (np.maximum(m, min_log_mel) - min_log_mel)),
                    f_sp * m)


@functools.lru_cache(maxsize=4)
def mel_basis(sample_rate: int, n_fft: int, n_mels: int, f_min: float = 0.0,
              f_max: float | None = None) -> np.ndarray:
    """(n_mels, n_fft // 2 + 1) Slaney-scale, Slaney-normalized triangles."""
    f_max = sample_rate / 2.0 if f_max is None else f_max
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(f_min), _hz_to_mel(f_max), n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    w = np.maximum(0.0, np.minimum(-ramps[:-2] / fdiff[:-1, None], ramps[2:] / fdiff[1:, None]))
    w *= (2.0 / (hz[2:n_mels + 2] - hz[:n_mels]))[:, None]
    return w.astype(np.float32)


def hann(n: int) -> np.ndarray:
    k = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * k / n)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _tables(n_fft: int, device: str):
    """The real DFT's (n_fft, F) cos and -sin tables, and the window."""
    n = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(n, np.arange(n_fft // 2 + 1, dtype=np.float64)) / n_fft
    to = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    return to(np.cos(ang)), to(-np.sin(ang)), to(hann(n_fft))


def preemphasis(x: torch.Tensor, coef: float) -> torch.Tensor:
    return x - coef * F.pad(x[..., :-1], (1, 0))


def frames(y: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centred frames (..., 1 + L // hop, n_fft), reflect-padded."""
    lead = y.shape[:-1]
    padded = F.pad(y.reshape(-1, 1, y.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
    padded = padded.reshape(*lead, -1)
    return padded.unfold(-1, n_fft, hop)[..., :1 + y.shape[-1] // hop, :]


def stft(y: torch.Tensor, n_fft: int, hop: int, ar: Arith = FULL):
    cos, msin, win = _tables(n_fft, str(y.device))
    fr = frames(y, n_fft, hop) * win
    return ar.mm(fr, cos), ar.mm(fr, msin)


def melspectrogram(wav: torch.Tensor, cfg: dict, ar: Arith = FULL) -> torch.Tensor:
    """(B, L) -> (B, 1 + L // hop, n_mels) normalized log-mel."""
    re, im = stft(preemphasis(wav, cfg["Preemphasis"]), cfg["Frame_Length"],
                  cfg["Frame_Shift"], ar)
    mag = torch.sqrt(re * re + im * im)
    basis = torch.from_numpy(mel_basis(cfg["Sample_Rate"], cfg["Frame_Length"], cfg["Mel_Dim"],
                                       float(cfg["Mel_F_Min"]), cfg["Mel_F_Max"])).to(wav.device)
    M = ar.mm(mag, basis.T)
    db = 20.0 * torch.log10(torch.clamp(M, min=AMP_FLOOR)) - cfg["Ref_Level_DB"]
    return torch.clamp((db - cfg["Min_Level_DB"]) / -cfg["Min_Level_DB"], 0.0, 1.0)


def linear_magnitude(linear: torch.Tensor, cfg: dict) -> torch.Tensor:
    """A normalized linear spectrogram -> the magnitude Griffin-Lim inverts:
    denormalized over ``Min_Level_DB``, plus ``Ref_Level_DB``, from dB to
    amplitude, raised to ``Power``."""
    db = torch.clamp(linear, 0.0, 1.0) * -cfg["Min_Level_DB"] + cfg["Min_Level_DB"]
    return torch.pow(10.0, (db + cfg["Ref_Level_DB"]) * 0.05) ** cfg["Power"]


@functools.lru_cache(maxsize=8)
def _inverse_tables(n_fft: int, device: str):
    """The inverse real DFT's (F, n_fft) cos and -sin tables, 1 / n_fft and
    the doubled inner bins folded in."""
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(k, np.arange(n_fft, dtype=np.float64)) / n_fft
    w = np.where((k == 0) | (k == n_fft // 2), 1.0, 2.0)[:, None] / n_fft
    to = functools.partial(torch.tensor, dtype=torch.float32, device=device)
    return to(w * np.cos(ang)), to(-w * np.sin(ang))


def griffin_lim_step(x: torch.Tensor, mag: torch.Tensor, n_fft: int, hop: int,
                     ar: Arith = FULL) -> torch.Tensor:
    """One Griffin-Lim iteration from the waveform ``x`` (R, (T - 1) hop):
    its centred frames (zeros past its ends) under a periodic Hann window,
    their spectra projected onto the magnitudes ``mag`` (R, T, F) as
    ``mag X / sqrt(|X|^2 + 1e-12)``, then windowed overlap-add over the
    window's squares, cropped as ``x``. A sample is one iteration of the map
    only where every frame over it lies inside ``x`` and has its magnitude
    in ``mag``."""
    cos, msin, win = _tables(n_fft, str(x.device))
    icos, imsin = _inverse_tables(n_fft, str(x.device))
    T = mag.shape[1]
    fr = F.pad(x, (n_fft // 2, n_fft // 2)).unfold(-1, n_fft, hop)[:, :T] * win
    re, im = ar.mm(fr, cos), ar.mm(fr, msin)
    scale = mag * torch.rsqrt(re * re + im * im + 1e-12)
    out = (ar.mm(re * scale, icos) + ar.mm(im * scale, imsin)) * win  # (R, T, n_fft)
    n = (T - 1) * hop + n_fft
    ola = F.fold(out.transpose(1, 2), (1, n), (1, n_fft), stride=(1, hop))[:, 0, 0]
    wsq = F.fold((win * win).expand(1, T, n_fft).transpose(1, 2), (1, n), (1, n_fft),
                 stride=(1, hop))[:, 0, 0]
    y = ola / torch.clamp(wsq, min=1e-11)
    return y[:, n_fft // 2:n_fft // 2 + (T - 1) * hop]


def inv_preemphasis(x: torch.Tensor, coef: float, block: int = 256) -> torch.Tensor:
    """y[n] = x[n] + coef y[n - 1] over the last axis of (R, n), in float64,
    a block of ``block`` samples a product."""
    x = x.double()
    R_, n = x.shape
    xb = F.pad(x, (0, (-n) % block)).reshape(R_, -1, block)
    k = torch.arange(block, device=x.device, dtype=torch.float64)
    within = xb @ torch.tril(coef ** (k[:, None] - k[None, :])).T
    carry = coef ** (k + 1)
    out, prev = torch.empty_like(within), x.new_zeros(R_)
    for b in range(xb.shape[1]):
        out[:, b] = within[:, b] + prev[:, None] * carry
        prev = out[:, b, -1]
    return out.reshape(R_, -1)[:, :n]


def pcm16(y: torch.Tensor) -> torch.Tensor:
    """A waveform in [-1, 1] -> 16-bit steps, clipped at full scale."""
    return torch.clamp(torch.round(y * 32767.0), -32768.0, 32767.0)
