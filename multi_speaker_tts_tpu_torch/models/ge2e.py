"""GE2E speaker encoder (port of ``multi_speaker_tts_tpu.models.ge2e``).

Stacked LSTM over mel windows -> projection of the last frame's output ->
L2 norm; an utterance embedding is the renormalized mean over sliding
windows, restricted to windows inside the real (pre-padding) frames.
Windows fold into the batch so the stack runs once per utterance, on the
persistent LSTM kernel for CUDA tensors (:mod:`..ops.lstm_kernel`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multi_speaker_tts_tpu_torch.models.layers import Dense, LSTMWeights
from multi_speaker_tts_tpu_torch.ops.lstm_kernel import lstm_stack_seq


def num_windows(length: int, window_length: int, window_shift: int) -> int:
    """Window count for a (padded) mel length."""
    return max(1, 1 + max(0, length - window_length) // window_shift)


def window_starts(length: int, window_length: int, window_shift: int) -> list[int]:
    """Start frames; the final window is clamped flush with the end."""
    T = max(length, window_length)
    W = num_windows(T, window_length, window_shift)
    return [min(w * window_shift, T - window_length) for w in range(W)]


def slide_windows(mel: torch.Tensor, window_length: int,
                  window_shift: int) -> torch.Tensor:
    """(..., T, M) -> (..., W, window_length, M); T < window_length is
    zero-padded to one full window."""
    T = mel.shape[-2]
    if T < window_length:
        mel = F.pad(mel, (0, 0, 0, window_length - T))
    starts = window_starts(T, window_length, window_shift)
    return torch.stack([mel[..., s:s + window_length, :] for s in starts], dim=-3)


def _l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-6)


class GE2E(nn.Module):
    """(N, L, mel) windows -> (N, embedding) unit-norm embeddings."""

    def __init__(self, mel_dim: int, lstm_size: int, lstm_stacks: int,
                 embedding_size: int, compute_dtype=torch.float32):
        super().__init__()
        self.lstm = nn.ModuleList(
            LSTMWeights(mel_dim if i == 0 else lstm_size, lstm_size)
            for i in range(lstm_stacks)
        )
        self.projection = Dense(lstm_size, embedding_size)
        self.compute_dtype = compute_dtype

    @classmethod
    def from_hp(cls, hp, compute_dtype) -> "GE2E":
        spk = hp.Speaker_Embedding
        return cls(hp.Sound.Mel_Dim, spk.GE2E.LSTM.Sizes, spk.GE2E.LSTM.Stacks,
                   spk.Embedding_Size, compute_dtype)

    def forward(self, mels: torch.Tensor) -> torch.Tensor:
        _, last = lstm_stack_seq([m.params for m in self.lstm], mels,
                                 self.compute_dtype)
        return _l2_normalize(self.projection(last))

    def embed_utterance(self, mel: torch.Tensor, window_length: int,
                        window_shift: int,
                        true_frame_lengths: torch.Tensor | None = None) -> torch.Tensor:
        """(B, T, M) utterance mels -> (B, E). ``true_frame_lengths`` (frames
        before any padding) keeps only windows lying inside the real signal,
        falling back to window 0 when none fits."""
        B, T, M = mel.shape
        windows = slide_windows(mel, window_length, window_shift)
        W = windows.shape[1]
        embs = self(windows.reshape(B * W, window_length, M)).reshape(B, W, -1)
        if true_frame_lengths is None:
            mean = embs.mean(dim=1)
        else:
            starts = torch.tensor(window_starts(T, window_length, window_shift),
                                  device=mel.device)
            fits = starts[None, :] + window_length <= true_frame_lengths[:, None]
            first = torch.arange(W, device=mel.device)[None, :] == 0
            keep = torch.where(fits.any(dim=1, keepdim=True), fits, first)
            mask = keep[..., None].to(embs.dtype)
            mean = (embs * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1.0)
        return _l2_normalize(mean)


def ge2e_similarity_matrix(embeddings: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Scaled cosine similarity S[j, i, k] = w cos(e_ji, c_k) + b of (N, M,
    E) unit-norm embeddings (N speakers x M utterances) against the speaker
    centroids; the own-speaker column uses the leave-one-out centroid, and
    w is clamped to at least 1e-6."""
    N, M, _ = embeddings.shape
    centroids = _l2_normalize(embeddings.mean(dim=1))  # (N, E)
    loo = _l2_normalize((embeddings.sum(dim=1, keepdim=True) - embeddings) / (M - 1))
    cos_all = torch.einsum("jme,ke->jmk", embeddings, centroids)
    cos_own = (embeddings * loo).sum(-1)  # (N, M)
    own = torch.eye(N, dtype=cos_all.dtype, device=cos_all.device)[:, None, :]
    cos = cos_all * (1.0 - own) + cos_own[..., None] * own
    return torch.clamp(weight, min=1e-6) * cos + bias


def ge2e_loss(embeddings: torch.Tensor, weight: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """The softmax GE2E loss: the mean over utterances of -S_jij +
    logsumexp_k S_jik."""
    S = ge2e_similarity_matrix(embeddings, weight, bias)
    N = S.shape[0]
    own = S[torch.arange(N), :, torch.arange(N)]  # (N, M)
    return (-own + torch.logsumexp(S, dim=2)).mean()
