"""Closed-set speaker conditioning (port of ``multi_speaker_tts_tpu.models.speaker``).

A learned lookup table of speaker embeddings, the alternative to zero-shot
GE2E enrollment for a model trained on a fixed set of speakers
(``Speaker_Embedding.Type: LUT``).
"""

from __future__ import annotations

import torch
from torch import nn


class SpeakerLUT(nn.Module):
    """(B,) speaker ids -> (B, E) rows of the table, each divided by
    ``max(|row|, 1e-6)``. The table is ``table.weight`` (the JAX package's
    ``speaker_lut/table/embedding``)."""

    def __init__(self, num_speakers: int, embedding_size: int):
        super().__init__()
        self.table = nn.Embedding(num_speakers, embedding_size)

    @classmethod
    def from_hp(cls, hp) -> "SpeakerLUT":
        spk = hp.Speaker_Embedding
        return cls(spk.get("Num_Speakers", 256), spk.Embedding_Size)

    def forward(self, speaker_ids: torch.Tensor) -> torch.Tensor:
        emb = self.table(speaker_ids)
        norm = torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
        return emb / torch.clamp(norm, min=1e-6)
