"""Batched DSP in PyTorch: the port of ``multi_speaker_tts_tpu.audio.dsp``.

Same functions and the same numerics contract as the JAX module
(normalized log-mel within 1e-4 of the numpy oracle). The fused mel
front-end kernel lives in :mod:`..ops.mel_kernel`; :func:`melspectrogram_auto`
sends CUDA tensors there and keeps CPU tensors on the kernel's plain
version. :func:`griffin_lim` is the FFT route of the vocoder (``torch.fft``,
as the JAX module uses ``jnp.fft`` outside any kernel): what a
configuration whose hop does not divide n_fft vocodes with.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from multi_speaker_tts_tpu_torch.audio.mel_filterbank import mel_filterbank

_AMP_FLOOR = 1e-5


@dataclass(frozen=True)
class DSPConfig:
    """Static DSP parameters derived from hp.Sound."""

    sample_rate: int
    n_fft: int
    hop: int
    n_mels: int
    f_min: float
    f_max: float | None
    preemphasis: float
    min_level_db: float
    ref_level_db: float
    power: float
    griffin_lim_iter: int
    griffin_lim_momentum: float = 0.0

    @classmethod
    def from_hp(cls, hp) -> "DSPConfig":
        return cls(
            sample_rate=hp.Sound.Sample_Rate,
            n_fft=hp.Sound.Frame_Length,
            hop=hp.Sound.Frame_Shift,
            n_mels=hp.Sound.Mel_Dim,
            f_min=float(hp.Sound.Mel_F_Min),
            f_max=hp.Sound.get("Mel_F_Max"),
            preemphasis=float(hp.Sound.Preemphasis),
            min_level_db=float(hp.Sound.Min_Level_DB),
            ref_level_db=float(hp.Sound.Ref_Level_DB),
            power=float(hp.Sound.Power),
            griffin_lim_iter=int(hp.Sound.Griffin_Lim_Iter),
            griffin_lim_momentum=float(hp.Sound.get("Griffin_Lim_Momentum", 0.0)),
        )

    @functools.cached_property
    def mel_basis(self) -> np.ndarray:
        """(n_mels, n_fft//2 + 1), float32."""
        return mel_filterbank(
            self.sample_rate, self.n_fft, self.n_mels, self.f_min, self.f_max
        )

    def num_frames(self, num_samples: int) -> int:
        return 1 + num_samples // self.hop


def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window computed in float64 and cast to f32 (edge values
    are ~1e-9, where f32 trig error would be a ~1e-2 relative error)."""
    n = np.arange(win_length, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def preemphasis(wav: torch.Tensor, coef: float) -> torch.Tensor:
    """FIR y[n] = x[n] - coef*x[n-1] over the last axis."""
    shifted = F.pad(wav[..., :-1], (1, 0))
    return wav - coef * shifted


def _iir_first_order(x: torch.Tensor, a: float, block: int) -> torch.Tensor:
    """y[n] = x[n] + a*y[n-1] along the last axis, exactly, in blocks: a
    lower-triangular (block x block) product gives the in-block prefixes,
    the block carries obey the same recurrence with coefficient a**block
    (solved recursively), and each block adds a**(n+1) times the carry
    entering it."""
    L = x.shape[-1]
    if L <= block:
        idx = torch.arange(L, device=x.device)
        expo = (idx[:, None] - idx[None, :]).clamp(min=0).to(torch.float64)
        tri = torch.where(idx[:, None] >= idx[None, :], a ** expo, 0.0)
        return x @ tri.T.to(x.dtype)
    nb = -(-L // block)
    xb = F.pad(x, (0, nb * block - L)).reshape(*x.shape[:-1], nb, block)
    p = _iir_first_order(xb, a, block)  # in-block prefixes, zero carry-in
    ends = _iir_first_order(p[..., -1], a ** block, block)
    prev = F.pad(ends[..., :-1], (1, 0))
    decay = torch.tensor(
        a ** (np.arange(block, dtype=np.float64) + 1.0), dtype=x.dtype,
        device=x.device,
    )
    y = p + prev[..., None] * decay
    return y.reshape(*x.shape[:-1], nb * block)[..., :L]


def inv_preemphasis(wav: torch.Tensor, coef: float, block: int = 256) -> torch.Tensor:
    """IIR y[n] = x[n] + coef*y[n-1] (inverse of :func:`preemphasis`)."""
    if coef == 0.0:
        return wav
    return _iir_first_order(wav, coef, block)


def reflect_pad(wav: torch.Tensor, left: int, right: int) -> torch.Tensor:
    """Reflect padding of the last axis for any number of leading dims."""
    lead = wav.shape[:-1]
    out = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (left, right), mode="reflect")
    return out.reshape(*lead, out.shape[-1])


def frame_signal(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered (reflect-padded) framing: (..., L) -> (..., T, n_fft)."""
    padded = reflect_pad(wav, n_fft // 2, n_fft // 2)
    n_frames = 1 + wav.shape[-1] // hop
    return padded.unfold(-1, n_fft, hop)[..., :n_frames, :]


def stft(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Complex STFT: (..., L) -> (..., T, n_fft//2+1)."""
    frames = frame_signal(wav, n_fft, hop)
    win = torch.from_numpy(hann_window(n_fft)).to(frames.device)
    return torch.fft.rfft(frames * win, dim=-1)


def stft_magnitude(wav: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """|STFT|: (..., L) -> (..., T, n_fft//2+1)."""
    return stft(wav, n_fft, hop).abs()


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """Inverse STFT by windowed overlap-add, window-square normalized, with
    the centred crop: (..., T, F) -> (..., length)."""
    frames = torch.fft.irfft(spec, n=n_fft, dim=-1)
    win = torch.from_numpy(hann_window(n_fft)).to(frames.device)
    T = frames.shape[-2]
    out_len = n_fft + hop * (T - 1)
    idx = (torch.arange(T, device=frames.device)[:, None] * hop
           + torch.arange(n_fft, device=frames.device)[None, :]).reshape(-1)
    flat = (frames * win).reshape(*frames.shape[:-2], -1)
    out = flat.new_zeros((*frames.shape[:-2], out_len)).index_add_(-1, idx, flat)
    wsq = win.new_zeros(out_len).index_add_(0, idx, (win * win).repeat(T))
    out = out / torch.clamp(wsq, min=1e-11)
    start = min(n_fft // 2, out_len - length)  # XLA's dynamic_slice clamps the start
    return out[..., start:start + length]


def amp_to_db(x: torch.Tensor) -> torch.Tensor:
    return 20.0 * torch.log10(torch.clamp(x, min=_AMP_FLOOR))


def db_to_amp(x: torch.Tensor) -> torch.Tensor:
    return torch.pow(10.0, x * 0.05)


def normalize(S_db: torch.Tensor, min_level_db: float) -> torch.Tensor:
    return torch.clamp((S_db - min_level_db) / (-min_level_db), 0.0, 1.0)


def denormalize(S_norm: torch.Tensor, min_level_db: float) -> torch.Tensor:
    return torch.clamp(S_norm, 0.0, 1.0) * (-min_level_db) + min_level_db


def spectrogram(wav: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """Normalized linear spectrogram: (..., L) -> (..., T, n_fft//2+1), the
    linear head's training target."""
    y = preemphasis(wav, cfg.preemphasis)
    D = stft_magnitude(y, cfg.n_fft, cfg.hop)
    return normalize(amp_to_db(D) - cfg.ref_level_db, cfg.min_level_db)


def melspectrogram(wav: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """Normalized log-mel via the FFT: (..., L) -> (..., T, n_mels)."""
    y = preemphasis(wav, cfg.preemphasis)
    D = stft_magnitude(y, cfg.n_fft, cfg.hop)
    basis = torch.from_numpy(cfg.mel_basis).to(D.device)
    M = D @ basis.T
    return normalize(amp_to_db(M) - cfg.ref_level_db, cfg.min_level_db)


_DISPATCH_LOGGED: set = set()


def log_dispatch(op: str, chosen: str, why: str) -> None:
    """One ``[dispatch]`` line per (op, route) per process, as the JAX
    package prints it."""
    if (op, chosen) not in _DISPATCH_LOGGED:
        _DISPATCH_LOGGED.add((op, chosen))
        print(f"[dispatch] {op} -> {chosen} ({why})")


def griffin_lim(magnitude: torch.Tensor, n_fft: int, hop: int, n_iter: int,
                length: int, momentum: float = 0.0) -> torch.Tensor:
    """Griffin-Lim through the FFT: (..., T, F) magnitude -> (..., length).
    Zero initial phase; ``momentum`` > 0 is the accelerated ("fast")
    variant of Perraudin et al. 2013 (the projected spectrum extrapolated
    against the previous projection)."""
    mag = magnitude.float()
    T = mag.shape[-2]
    y = istft(mag.to(torch.complex64), n_fft, hop, length)
    if momentum > 0.0:
        beta = momentum / (1.0 + momentum)
        tprev = torch.zeros_like(mag, dtype=torch.complex64)
        for _ in range(n_iter):
            D = stft(y, n_fft, hop)[..., :T, :]
            E = D - beta * tprev
            y = istft(mag * (E / torch.clamp(E.abs(), min=1e-11)), n_fft, hop, length)
            tprev = D
        return y
    for _ in range(n_iter):
        D = stft(y, n_fft, hop)[..., :T, :]
        y = istft(mag * (D / torch.clamp(D.abs(), min=1e-11)), n_fft, hop, length)
    return y


def inv_spectrogram(S_norm: torch.Tensor, cfg: DSPConfig, length: int | None = None) -> torch.Tensor:
    """Normalized linear spectrogram -> waveform by the FFT Griffin-Lim."""
    if length is None:
        length = cfg.hop * (S_norm.shape[-2] - 1)
    mag = db_to_amp(denormalize(S_norm, cfg.min_level_db) + cfg.ref_level_db)
    wav = griffin_lim(mag ** cfg.power, cfg.n_fft, cfg.hop, cfg.griffin_lim_iter, length,
                      momentum=cfg.griffin_lim_momentum)
    return inv_preemphasis(wav, cfg.preemphasis)


def mel_fused_eligible(wav: torch.Tensor, cfg: DSPConfig) -> bool:
    """The JAX package's routing rule for the enrollment front-end: a
    batched (B, L) wav whose length is a multiple of hop, and hop dividing
    n_fft."""
    return wav.ndim == 2 and cfg.n_fft % cfg.hop == 0 and wav.shape[-1] % cfg.hop == 0


def melspectrogram_auto(wav: torch.Tensor, cfg: DSPConfig) -> torch.Tensor:
    """The enrollment front-end, routed as the JAX ``melspectrogram_auto``
    routes: an eligible input (:func:`mel_fused_eligible`) goes to the fused
    front-end (its kernel for CUDA tensors, which raises for a frame it does
    not take; its plain version for CPU tensors), every other input to the
    FFT route :func:`melspectrogram`. (B, L) -> (B, 1 + L/hop, n_mels)."""
    if not mel_fused_eligible(wav, cfg):
        log_dispatch("melspectrogram", "fft", f"ndim={wav.ndim}, n_fft%hop={cfg.n_fft % cfg.hop}, "
                     f"L%hop={wav.shape[-1] % cfg.hop}")
        return melspectrogram(wav, cfg)
    from multi_speaker_tts_tpu_torch.ops.mel_kernel import melspectrogram_fused

    return melspectrogram_fused(wav, cfg)
