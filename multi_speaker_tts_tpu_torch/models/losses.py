"""Training losses (port of ``multi_speaker_tts_tpu.models.losses``): masked
mel L1 before and after the postnet, the stop-token BCE, the optional
linear-spectrogram L1 and the guided-attention loss, all in f32.

Each loss is a masked sum over a masked count. In a data-parallel run the
count is the global batch's (summed over the processes, no gradient through
it) and the sum this process's rows': each process's loss is its share, and
the shares add up to the single-device loss of the global batch."""

from __future__ import annotations

import torch

from multi_speaker_tts_tpu_torch.parallel import multihost


def _global_count(count: torch.Tensor) -> torch.Tensor:
    """A denominator over the whole (data-parallel) batch, clamped at 1."""
    return torch.clamp(multihost.all_reduce_sum([count.detach()])[0], min=1.0)


def sequence_mask(lengths: torch.Tensor, max_len: int, dtype=torch.float32) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) 0/1 mask."""
    pos = torch.arange(max_len, device=lengths.device)
    return (pos[None, :] < lengths[:, None]).to(dtype)


def masked_l1(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over valid frames only. mask: (B, T)."""
    err = (pred.float() - target.float()).abs() * mask[..., None]
    return err.sum() / _global_count(mask.sum() * pred.shape[-1])


def _steps(mel_lengths: torch.Tensor, n_frames_per_step: int) -> torch.Tensor:
    """Decoder steps per utterance: ceil(frames / r)."""
    return torch.ceil(mel_lengths.float() / n_frames_per_step).to(torch.int32)


def stop_token_bce(stop_logits: torch.Tensor, mel_lengths: torch.Tensor,
                   n_frames_per_step: int = 1, positive_weight: float = 5.0) -> torch.Tensor:
    """BCE against a target that is 1 at and after the last valid step; the
    one positive step per utterance weighs ``positive_weight``."""
    n_steps = stop_logits.shape[1]
    lengths_steps = _steps(mel_lengths, n_frames_per_step)
    steps = torch.arange(n_steps, device=stop_logits.device)[None, :]
    target = (steps >= lengths_steps[:, None] - 1).float()
    valid = (steps < lengths_steps[:, None]).float()
    logits = stop_logits.float()
    bce = torch.clamp(logits, min=0.0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    weight = torch.where(target > 0, positive_weight, 1.0) * valid
    return (bce * weight).sum() / _global_count(weight.sum())


def guided_attention_loss(alignments: torch.Tensor, token_lengths: torch.Tensor,
                          mel_lengths: torch.Tensor, sigma: float = 0.2) -> torch.Tensor:
    """Guided attention (Tachibana et al.): W[t, s] = 1 - exp(-(s/S - t/T)^2
    / (2 sigma^2)) over the valid region; ``mel_lengths`` in decoder steps."""
    B, T, S = alignments.shape
    dev = alignments.device
    t_pos = torch.arange(T, device=dev)[None, :, None] / torch.clamp(
        mel_lengths[:, None, None], min=1)
    s_pos = torch.arange(S, device=dev)[None, None, :] / torch.clamp(
        token_lengths[:, None, None], min=1)
    W = 1.0 - torch.exp(-((s_pos - t_pos) ** 2) / (2 * sigma ** 2))
    mask = sequence_mask(mel_lengths, T)[:, :, None] * sequence_mask(token_lengths, S)[:, None, :]
    return (alignments.float() * W * mask).sum() / _global_count(mask.sum())


def tacotron_losses(outputs: dict, mels: torch.Tensor, mel_lengths: torch.Tensor,
                    token_lengths: torch.Tensor, spects: torch.Tensor | None = None,
                    n_frames_per_step: int = 1, guided_attention_sigma: float | None = 0.2,
                    guided_attention_weight: float = 10.0) -> dict[str, torch.Tensor]:
    """All synthesizer losses; 'total' is the training objective."""
    mask = sequence_mask(mel_lengths, mels.shape[1])
    losses = {
        "mel_pre": masked_l1(outputs["mel_pre"], mels, mask),
        "mel_post": masked_l1(outputs["mel_post"], mels, mask),
        "stop": stop_token_bce(outputs["stop_logits"], mel_lengths, n_frames_per_step),
    }
    total = losses["mel_pre"] + losses["mel_post"] + losses["stop"]
    if spects is not None and "linear" in outputs:
        losses["linear"] = masked_l1(outputs["linear"], spects, mask)
        total = total + losses["linear"]
    if guided_attention_sigma is not None:
        losses["guided_attention"] = guided_attention_loss(
            outputs["alignments"], token_lengths, _steps(mel_lengths, n_frames_per_step),
            guided_attention_sigma)
        total = total + guided_attention_weight * losses["guided_attention"]
    losses["total"] = total
    return losses
