"""Seeded synthetic voices made on the device, in the corpus generator's
``rich`` style (``data/pattern_generator.generate_synthetic_dataset``): a
speaker is a fundamental in [85, 320] Hz, six harmonics with a decay and
two formant-like boosts, and a vibrato; an utterance of a speaker jitters
the fundamental by 3% and draws the vibrato's phase. Every clip is
normalized to a peak of 0.4 under a 50 ms attack and release. All draws
come from one ``torch.Generator`` on the device, in a few large calls."""

from __future__ import annotations

import math

import torch

N_HARMONICS = 6


def generator(seed: int, stream: int, device) -> torch.Generator:
    return torch.Generator(device).manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))


def speakers(gen: torch.Generator, n: int, device) -> dict:
    u = torch.rand((n, 8), generator=gen, device=device)
    f0 = 85.0 * (320.0 / 85.0) ** u[:, 0]
    k = torch.arange(1, N_HARMONICS + 1, device=device, dtype=torch.float32)
    decay = 0.45 + 0.30 * u[:, 1]
    amps = decay[:, None] ** (k - 1)[None, :]
    for j in (2, 3):
        fc = 300.0 + 2900.0 * u[:, j]
        amps = amps * (1.0 + 1.5 * torch.exp(-((f0[:, None] * k - fc[:, None]) ** 2)
                                              / (2 * 250.0 ** 2)))
    amps = amps / amps.amax(dim=1, keepdim=True)
    return {"f0": f0, "amps": amps, "vib_rate": 3.0 + 4.0 * u[:, 4],
            "vib_depth": 0.005 + 0.025 * u[:, 5]}


def render(gen: torch.Generator, spk: dict, who: torch.Tensor, lengths: torch.Tensor,
           n_samples: int, sample_rate: int) -> torch.Tensor:
    """Clips of speakers ``who`` (C,), ``lengths`` (C,) samples each, in a
    (C, n_samples) float32 tensor, zeros past each length."""
    device = who.device
    C = who.shape[0]
    u = torch.rand((C, 2), generator=gen, device=device)
    f0 = spk["f0"][who] * (0.97 + 0.06 * u[:, 0])
    t = torch.arange(n_samples, device=device, dtype=torch.float32)[None, :] / sample_rate
    vib = 1.0 + spk["vib_depth"][who][:, None] * torch.sin(
        2 * math.pi * spk["vib_rate"][who][:, None] * t + 2 * math.pi * u[:, 1:2])
    phase = 2 * math.pi * f0[:, None] * vib * t
    wav = torch.zeros((C, n_samples), device=device)
    for k in range(N_HARMONICS):
        wav += spk["amps"][who][:, k:k + 1] * torch.sin((k + 1) * phase)
    inside = t < (lengths[:, None].float() / sample_rate)
    wav = torch.where(inside, wav, torch.zeros((), device=device))
    wav = wav / wav.abs().amax(dim=1, keepdim=True).clamp(min=1e-6)
    end = lengths[:, None].float() / sample_rate
    env = torch.clamp(20 * t, max=1.0) * torch.clamp(20 * (end - t), min=0.0, max=1.0)
    return 0.4 * wav * env
