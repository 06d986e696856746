"""SV-metric control: is the demo corpus's EER the corpus or the code? (port
of the top-level ``tools/sv_harmonic_control.py``).

The demo corpus's speakers are pure harmonic stacks at f0 = 110 * 1.3^s
(``data/pattern_generator.generate_synthetic_dataset``), so some speaker
pairs share most of their spectral energy: 1.3^3 = 2.197 is nearly an
octave. This control computes the interpolated-crossing EER restricted to
(a) near-harmonic speaker pairs and (b) everything else, then the same
split by f0 adjacency (one corpus step, ratio 1.3, apart or not): if the
EER concentrates in one half, the metric and the embedding space are sound
and the corpus's separability is the limit.

    python -m multi_speaker_tts_tpu_torch.tools.sv_harmonic_control \\
        -checkpoint demo/serving_ckpt_full.msgpack -pattern DIR [-threshold 0.2] [-device cpu]

The embeddings come from ``evaluate.speaker_verification(...,
return_embeddings=True)`` on the card (``-device cpu`` on the CPU); the
numeric part is :func:`harmonic_control` of (embeddings, speaker ids,
threshold). Prints the JAX tool's JSON object, then ``device`` and
``seconds`` beside it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np


def octave_distance(r: float) -> float:
    """Distance of a frequency ratio from the nearest power of two, in
    octaves: 0 = harmonically aligned (unison / octave), 0.5 = maximally
    inharmonic (tritone-like)."""
    o = np.log2(r)
    return float(abs(o - round(o)))


def _spearman(x: np.ndarray, y: np.ndarray) -> float:
    rx = np.argsort(np.argsort(x)).astype(np.float64)
    ry = np.argsort(np.argsort(y)).astype(np.float64)
    rx -= rx.mean()
    ry -= ry.mean()
    return round(float((rx @ ry) / np.sqrt((rx @ rx) * (ry @ ry))), 3)


def _split_eer(scores, same, cross) -> float:
    """The EER over the same-speaker pairs and the cross pairs in ``cross``."""
    from multi_speaker_tts_tpu_torch.evaluate import compute_eer

    return round(compute_eer(np.concatenate([scores[same], scores[cross]]),
                             np.concatenate([np.ones(same.sum(), bool),
                                             np.zeros(cross.sum(), bool)])), 4)


def harmonic_control(E: np.ndarray, spk_of: np.ndarray, threshold: float = 0.2,
                     sv_eer: float | None = None) -> dict:
    """The control on unit-norm utterance embeddings ``E`` (U, emb) of
    speakers ``spk_of`` (U,): every utterance pair scored by cosine, the
    cross pairs split by the octave distance of their speakers' f0 (below
    ``threshold``: near-harmonic) and by adjacency (ratio below 1.3^2), an
    EER over the same-speaker pairs and each half, and the per speaker-pair
    mean cross cosine. ``sv_eer``: the EER over all pairs, recomputed if
    None."""
    from multi_speaker_tts_tpu_torch.evaluate import compute_eer

    E = np.asarray(E, np.float64)
    spk_of = np.asarray(spk_of)
    f0 = {s: 110.0 * (1.3 ** s) for s in np.unique(spk_of)}
    cos = E @ E.T
    iu, ju = np.triu_indices(len(E), k=1)
    scores = cos[iu, ju]
    same = spk_of[iu] == spk_of[ju]
    ratio = np.asarray([max(f0[a], f0[b]) / min(f0[a], f0[b])
                        for a, b in zip(spk_of[iu], spk_of[ju])])
    odist = np.asarray([octave_distance(r) for r in ratio])
    near = (~same) & (odist < threshold)
    far = (~same) & (odist >= threshold)
    if sv_eer is None:
        sv_eer = compute_eer(scores, same)
    out = {
        "sv_eer_all": round(sv_eer, 4),
        "near_harmonic_pairs": int(near.sum()),
        "inharmonic_pairs": int(far.sum()),
        "cross_cos_near_harmonic": round(float(scores[near].mean()), 4),
        "cross_cos_inharmonic": round(float(scores[far].mean()), 4),
        "own_cos": round(float(scores[same].mean()), 4),
        "sv_eer_excl_near_harmonic": _split_eer(scores, same, far),
        "sv_eer_near_harmonic_only": _split_eer(scores, same, near),
        "octave_threshold": threshold,
    }
    # Second split, by linear f0 adjacency (ratio 1.3 = one corpus step).
    adjacent = (~same) & (ratio < 1.69)  # 1.3^2 = 1.69: one step apart
    apart = (~same) & (ratio >= 1.69)
    out.update({
        "adjacent_pairs": int(adjacent.sum()),
        "nonadjacent_pairs": int(apart.sum()),
        "cross_cos_adjacent": round(float(scores[adjacent].mean()), 4),
        "cross_cos_nonadjacent": round(float(scores[apart].mean()), 4),
        "sv_eer_excl_adjacent": _split_eer(scores, same, apart),
        "sv_eer_adjacent_only": _split_eer(scores, same, adjacent),
        # rank correlation between pair confusion and log-f0 distance
        "spearman_crosscos_vs_logf0dist": _spearman(scores[~same],
                                                    np.abs(np.log(ratio[~same]))),
    })
    pairs = {}
    for a in np.unique(spk_of):
        for b in np.unique(spk_of):
            if a < b:
                m = (~same) & (((spk_of[iu] == a) & (spk_of[ju] == b))
                               | ((spk_of[iu] == b) & (spk_of[ju] == a)))
                pairs[f"spk{a}-spk{b}"] = {
                    "octave_dist": round(octave_distance(f0[b] / f0[a]), 3),
                    "mean_cross_cos": round(float(scores[m].mean()), 3),
                }
    out["pairs"] = pairs
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("-checkpoint", default="demo/serving_ckpt_full.msgpack",
                    help="compact checkpoint carrying the (frozen pretrained) GE2E encoder")
    ap.add_argument("-pattern", required=True, help="pattern directory of the corpus")
    ap.add_argument("-threshold", type=float, default=0.2,
                    help="octave distance below which a pair counts as near-harmonic")
    ap.add_argument("-device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from multi_speaker_tts_tpu_torch.evaluate import load_trainer, speaker_verification

    trainer = load_trainer(args.checkpoint, device=args.device)
    t0 = time.perf_counter()
    sv = speaker_verification(trainer.hp, trainer.ge2e, args.pattern, return_embeddings=True)
    out = harmonic_control(sv["embeddings"], sv["speaker_of"], args.threshold, sv["sv_eer"])
    out["device"] = str(trainer.device)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
