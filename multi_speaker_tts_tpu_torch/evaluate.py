"""Model evaluation (port of ``multi_speaker_tts_tpu.evaluate``): teacher-forced
mel L1 before and after the postnet, linear L1, the stop BCE and attention
diagonality over a pattern set, and GE2E speaker verification (EER, own and
cross-speaker cosines, nearest-centroid accuracy), for any checkpoint, so
that two models can be compared on the same patterns.

CLI (the card by default; ``-device cpu`` runs the plain versions)::

    python -m multi_speaker_tts_tpu_torch.evaluate -checkpoint <file.msgpack | dir> \\
        -pattern <dir> [-hp file] [-batches N] [-sv]
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.data.datasets import BucketBatcher, PatternDataset


def attention_diagonality(alignments: np.ndarray, token_lengths, mel_lengths,
                          n_frames_per_step: int = 1) -> float:
    """Mean attention mass within a +-20% band around the ideal diagonal.
    Alignment rows are decode steps (r frames each); ``mel_lengths`` is in
    frames and is converted."""
    B, T, S = alignments.shape
    total, count = 0.0, 0
    for b in range(B):
        tl = int(token_lengths[b])
        ml = -(-int(mel_lengths[b]) // n_frames_per_step)  # steps
        if tl < 2 or ml < 2:
            continue
        t_pos = np.arange(ml) / ml
        s_pos = np.arange(tl) / tl
        band = np.abs(s_pos[None, :] - t_pos[:, None]) <= 0.2
        total += float((alignments[b, :ml, :tl] * band).sum() / ml)
        count += 1
    return total / max(count, 1)


def _eval_masks(hp, batch: dict, seed: int, device) -> list[torch.Tensor] | None:
    """The prenet's keep masks for one evaluation batch, from a CPU generator
    seeded with ``seed`` (the same draws on every batch and every device, as
    the JAX evaluation passes one key to every batch)."""
    rate = float(hp.Decoder.Prenet.Dropout_Rate)
    if rate == 0.0:
        return None
    gen = torch.Generator().manual_seed(seed)
    B, T = batch["mels"].shape[:2]
    shape = (B, T // int(hp.Decoder.get("N_Frames_Per_Step", 1)))
    return [(torch.rand((*shape, size), generator=gen) < 1.0 - rate).to(device)
            for size in hp.Decoder.Prenet.Sizes]


def evaluate(hp, trainer, pattern_dir: str, max_batches: int = 16, seed: int = 0) -> dict:
    """Teacher-forced metrics of ``trainer``'s weights (a
    :class:`..train.trainer.Trainer`) over up to ``max_batches`` bucketed
    batches of ``Train.Eval_Batch_Size``, in order: each loss's mean, the
    mean attention diagonality, and the batch count."""
    lh = hp.get("Linear_Head")
    batcher = BucketBatcher(
        PatternDataset(pattern_dir),
        batch_size=hp.Train.get("Eval_Batch_Size", 8),
        token_buckets=list(hp.Train.Batch_Bucketing.Token_Buckets),
        mel_buckets=list(hp.Train.Batch_Bucketing.Mel_Buckets),
        mel_dim=hp.Sound.Mel_Dim,
        n_frames_per_step=hp.Decoder.get("N_Frames_Per_Step", 1),
        ref_window=(hp.Speaker_Embedding.GE2E.Window_Length
                    if trainer.ge2e is not None else None),
        spect_dim=hp.Sound.Spectrogram_Dim if (lh is not None and lh.Use) else None,
        shuffle=False,
    )
    sums: dict[str, float] = {}
    diag_sum, n = 0.0, 0
    for _, batch in batcher:
        if n >= max_batches:
            break
        losses, outputs = trainer.eval_step(batch, _eval_masks(hp, batch, seed, trainer.device))
        for k, v in losses.items():
            sums[k] = sums.get(k, 0.0) + v
        diag_sum += attention_diagonality(
            outputs["alignments"].float().cpu().numpy(), batch["token_lengths"],
            batch["mel_lengths"], n_frames_per_step=int(hp.Decoder.get("N_Frames_Per_Step", 1)))
        n += 1
    if n == 0:
        raise ValueError(f"no evaluable batches under {pattern_dir}")
    metrics = {k: v / n for k, v in sums.items()}
    metrics["attention_diagonality"] = diag_sum / n
    metrics["num_batches"] = n
    return metrics


def compute_eer(scores: np.ndarray, labels: np.ndarray) -> float:
    """Equal error rate of a verification trial set: ``scores`` a similarity
    per trial, ``labels`` True for same-speaker trials. The operating point
    where the false-accept rate (negatives at or above the threshold) equals
    the false-reject rate (positives below it), linearly interpolated
    between neighbouring thresholds."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, bool)
    pos = np.sort(scores[labels])
    neg = np.sort(scores[~labels])
    if len(pos) == 0 or len(neg) == 0:
        raise ValueError("EER needs both same- and cross-speaker trials")
    ts = np.unique(scores)
    frr = np.searchsorted(pos, ts, side="left") / len(pos)
    far = 1.0 - np.searchsorted(neg, ts, side="left") / len(neg)
    diff = far - frr  # decreasing in the threshold
    i = int(np.argmax(diff <= 0))
    if i == 0 or diff[i] == 0:
        return float((far[i] + frr[i]) / 2.0)
    w = diff[i - 1] / (diff[i - 1] - diff[i])
    far_x = far[i - 1] + w * (far[i] - far[i - 1])
    frr_x = frr[i - 1] + w * (frr[i] - frr[i - 1])
    return float((far_x + frr_x) / 2.0)


@torch.no_grad()
def speaker_verification(hp, ge2e, pattern_dir: str, max_utts_per_speaker: int = 10,
                         batch_size: int = 16, return_embeddings: bool = False) -> dict:
    """GE2E encoder quality over a pattern set: every pattern mel (up to
    ``max_utts_per_speaker`` a speaker) embedded by ``ge2e.embed_utterance``
    (the sliding-window path of enrollment) in batches of ``batch_size``
    (the last one wrapped around to full size, as the JAX package's one
    program shape does), every utterance pair scored by cosine. Reports
    ``sv_eer``, ``sv_own_cos`` / ``sv_cross_cos`` (mean same / cross-speaker
    pair cosine), ``sv_margin``, ``sv_centroid_accuracy`` (nearest centroid,
    own centroid leaving the utterance out) and the counts."""
    if ge2e is None:
        raise ValueError("model has no GE2E speaker encoder")
    spk_cfg = hp.Speaker_Embedding.GE2E
    win_len, win_shift = spk_cfg.Window_Length, spk_cfg.Window_Shift
    device = next(ge2e.parameters()).device
    ds = PatternDataset(pattern_dir)

    chosen: list[int] = []
    for s in sorted(ds.indices_by_speaker):
        chosen.extend(ds.indices_by_speaker[s][:max_utts_per_speaker])
    mels = [ds[i]["Mel"] for i in chosen]
    spk_of = np.asarray([ds.speaker_ids[ds.speakers[i]] for i in chosen])
    lengths = np.asarray([m.shape[0] for m in mels], np.int64)
    T_pad = max(int(lengths.max()), win_len)
    packed = np.zeros((len(mels), T_pad, mels[0].shape[-1]), np.float32)
    for i, m in enumerate(mels):
        packed[i, :m.shape[0]] = m

    embs = []
    for lo in range(0, len(mels), batch_size):
        hi = min(lo + batch_size, len(mels))
        idx = np.arange(lo, lo + batch_size) % len(mels)
        out = ge2e.embed_utterance(torch.from_numpy(packed[idx]).to(device), win_len,
                                   win_shift, torch.from_numpy(lengths[idx]).to(device))
        embs.append(out.float().cpu().numpy()[:hi - lo])
    E = np.concatenate(embs, axis=0)  # (U, emb), unit-norm

    cos = E @ E.T
    iu, ju = np.triu_indices(len(E), k=1)
    scores = cos[iu, ju]
    same = spk_of[iu] == spk_of[ju]

    correct = 0
    for i in range(len(E)):
        best, best_s = -np.inf, None
        for s in np.unique(spk_of):
            members = (spk_of == s) & (np.arange(len(E)) != i)
            if not members.any():
                continue
            c = E[members].mean(axis=0)
            c = c / max(np.linalg.norm(c), 1e-9)
            score = float(E[i] @ c)
            if score > best:
                best, best_s = score, s
        correct += int(best_s == spk_of[i])

    extra = {"embeddings": E, "speaker_of": spk_of} if return_embeddings else {}
    return {
        **extra,
        "sv_eer": compute_eer(scores, same),
        "sv_own_cos": float(scores[same].mean()),
        "sv_cross_cos": float(scores[~same].mean()),
        "sv_margin": float(scores[same].mean() - scores[~same].mean()),
        "sv_centroid_accuracy": correct / len(E),
        "sv_num_utterances": len(E),
        "sv_num_speakers": int(len(np.unique(spk_of))),
    }


def load_trainer(checkpoint: str, hp=None, device=None):
    """A :class:`..train.trainer.Trainer` holding a compact ``.msgpack``
    checkpoint's weights or a training checkpoint directory's latest step;
    hp from the checkpoint unless given."""
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse, default_hparams
    from multi_speaker_tts_tpu_torch.train.checkpoints import CheckpointManager
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer

    if not pathlib.Path(checkpoint).is_dir():
        return Trainer.from_compact(checkpoint, hp=hp, device=device)
    state, step = CheckpointManager(checkpoint).restore()
    if state is None:
        raise FileNotFoundError(f"no checkpoint under {checkpoint}")
    if hp is None:
        hp = Recursive_Parse(state["hp"]) if "hp" in state else default_hparams()
    trainer = Trainer(hp, device=device)
    trainer.load_state(state)
    print(f"loaded checkpoint step {step}")
    return trainer


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description="Evaluate a TTS checkpoint")
    parser.add_argument("-hp", "--hyper_parameters", default=None)
    parser.add_argument("-checkpoint", required=True,
                        help=".msgpack compact checkpoint or a training checkpoint directory")
    parser.add_argument("-pattern", required=True)
    parser.add_argument("-batches", type=int, default=16)
    parser.add_argument("-sv", action="store_true",
                        help="also report GE2E speaker-verification metrics "
                             "(EER, cosine margins) over the pattern set")
    parser.add_argument("-device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from multi_speaker_tts_tpu_torch.hparams import load_hyper_parameters

    hp = load_hyper_parameters(args.hyper_parameters) if args.hyper_parameters else None
    try:
        trainer = load_trainer(args.checkpoint, hp, args.device)
    except FileNotFoundError as e:
        parser.error(f"-checkpoint {args.checkpoint!r}: {e}")
    metrics = evaluate(trainer.hp, trainer, args.pattern, args.batches)
    if args.sv:
        metrics.update(speaker_verification(trainer.hp, trainer.ge2e, args.pattern))
    print(json.dumps({k: round(float(v), 6) for k, v in metrics.items()}))
    return metrics


if __name__ == "__main__":
    main()
