"""Driver of a GE2E embedding cell: a closed loop over a corpus of seeded
clips of speech-like audio (``traffic/voices.py``) bucketed by length, as a
corpus is embedded: the clips sorted by length into batches, each batch
packed to its own longest clip in whole hops (the shorter ones wrap-padded,
as ``Synthesizer.enroll`` pads a clip), then ``dsp.melspectrogram_auto`` and
``GE2E.embed_utterance`` over the windows inside each clip's real frames; a
call is done when its embeddings are on the host. The clips are made on the
device at set-up; the batches are taken in an order in which every stretch
of them spans the corpus's lengths (:func:`pass_order`), pass after pass.

The check: the embeddings of batches sampled from the seed among those the
window answered (the last one among them), against the plain float32
reference's mel and GE2E on the same clips: the widest distance between a
served unit embedding and the reference's.
"""

from __future__ import annotations

import gc

import torch

from benchmark.harness import ge2e
from benchmark.harness.cell import Compared
from benchmark.reference import dsp as rdsp
from benchmark.reference import models as R
from benchmark.reference.lowp import Arith, no_tf32
from benchmark.traffic import texts as keyed
from benchmark.traffic import voices


def corpus_lengths(seed: int, params: dict, sample_rate: int) -> list[int]:
    """The corpus's clip lengths in samples, ascending: ``batch`` x
    ``pool_batches`` of them over [``seconds_min``, ``seconds_max``], one
    drawn from the seed inside each of as many equal strata, so that every
    seed asks for work of nearly the same sizes."""
    lo, hi = params["seconds_min"], params["seconds_max"]
    n = params["batch"] * params["pool_batches"]
    u = keyed.rng_for(seed, 6).random(n)
    return [int(round((lo + (hi - lo) * (i + u[i]) / n) * sample_rate)) for i in range(n)]


def pass_order(n: int) -> list[int]:
    """Batches 0..n-1 (ascending lengths) in bit-reversed order: every
    stretch of a pass spans the lengths, so a window that ends inside a pass
    holds about the corpus's mix."""
    bits = max(n - 1, 1).bit_length()
    return sorted(range(n), key=lambda i: int(format(i, f"0{bits}b")[::-1], 2))


def make_batch(seed: int, index: int, lengths: list[int], params: dict, snd: dict,
               device) -> dict:
    gen = voices.generator(seed, 2000 + index, device)
    lengths = torch.tensor(lengths, device=device)
    n_spk = params["speakers_per_batch"]
    spk = voices.speakers(gen, n_spk, device)
    who = torch.randint(0, n_spk, (len(lengths),), generator=gen, device=device)
    hop = snd["Frame_Shift"]
    L = -(-int(lengths.max()) // hop) * hop  # whole frames, as the fused front end takes them
    wav = voices.render(gen, spk, who, lengths, L, snd["Sample_Rate"])
    idx = torch.arange(L, device=device)[None, :] % lengths[:, None]
    padded = torch.gather(wav, 1, idx)  # wrap padding to the batch's longest clip
    return {"wav": padded.contiguous(), "lengths": lengths,
            "true_frames": 1 + lengths // snd["Frame_Shift"],
            "audio_s": float(lengths.sum()) / snd["Sample_Rate"]}


def setup(ctx) -> dict:
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.models.ge2e import GE2E
    from multi_speaker_tts_tpu_torch.ops.numerics import compute_dtype_of

    hp, over = ge2e.hparams(ctx)
    d = ge2e.dims(hp)
    model = GE2E.from_hp(hp, compute_dtype_of(hp)).to(ctx.device)
    tree = ge2e.weights(ctx.seed, d, ctx.device)
    ge2e.load(model, tree, d)
    p = ctx.params
    lengths = corpus_lengths(ctx.seed, p, over["Sound"]["Sample_Rate"])
    pool = [make_batch(ctx.seed, i, lengths[i * p["batch"]:(i + 1) * p["batch"]], p,
                       over["Sound"], ctx.device) for i in range(p["pool_batches"])]
    win = hp.Speaker_Embedding.GE2E
    state = {"model": model, "cfg": dsp.DSPConfig.from_hp(hp), "pool": pool, "tree": tree,
             "hp": hp, "over": over, "dims": d, "seed": ctx.seed, "order": pass_order(len(pool)),
             "window": (win.Window_Length, win.Window_Shift)}
    for batch in pool:  # warm-up: each batch has a shape of its own
        embed(state, batch)
    return state


@torch.no_grad()
def embed(state, batch):
    from multi_speaker_tts_tpu_torch.audio import dsp

    mel = dsp.melspectrogram_auto(batch["wav"], state["cfg"])
    emb = state["model"].embed_utterance(mel, *state["window"], batch["true_frames"])
    return emb.cpu()


def step(state, i: int) -> dict:
    k = state["order"][i % len(state["pool"])]
    batch = state["pool"][k]
    return {"requests": len(batch["lengths"]), "batch": k, "emb": embed(state, batch),
            "audio_s": batch["audio_s"]}


def end_to_end(state, records, window_s) -> dict:
    return {"embed_audio_rate": sum(r["audio_s"] for r in records) / window_s}


def work(state, records) -> dict:
    win, shift = state["window"]
    hop = state["over"]["Sound"]["Frame_Shift"]
    calls = []
    for r in records:
        b = state["pool"][r["batch"]]
        T = 1 + b["wav"].shape[1] // hop
        starts = R.window_starts(T, win, shift)
        real = sum(len([s for s in starts if s + win <= int(tf)]) or 1 for tf in b["true_frames"])
        calls.append({"rows": b["wav"].shape[0], "samples": b["wav"].shape[1], "frames": T,
                      "real_windows": real})
    return {"dims": state["dims"], "T": win, "calls": calls, "kind": "embed",
            "sound": state["over"]["Sound"]}


def check(state, records, ctx) -> list[Compared]:
    model = state.pop("model")
    device = next(model.parameters()).device
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    n = ctx.params["check_batches"]
    order = keyed.rng_for(state["seed"], 4).permutation(len(records) - 1)[:max(n - 1, 0)]
    picks = sorted(set(int(k) for k in order) | {len(records) - 1})
    win, shift = state["window"]
    snd = state["over"]["Sound"]
    arths = {"": Arith(False)}
    if ctx.control:
        arths[".control"] = Arith(True)
    gaps = {}
    with torch.no_grad():
        for k in picks:
            b = state["pool"][records[k]["batch"]]
            served = records[k]["emb"].to(device).float()
            ref = None
            for suffix, ar in arths.items():
                emb = torch.cat([R.utterance_embedding(state["tree"], rdsp.melspectrogram(
                    b["wav"][j:j + 32], snd, ar), b["true_frames"][j:j + 32], win, shift, ar)
                    for j in range(0, b["wav"].shape[0], 32)])
                if ref is None:
                    ref = emb
                    got = served
                else:
                    got = emb
                gap = float(torch.linalg.vector_norm(got - ref, dim=-1).max())
                gaps["embed_gap" + suffix] = max(gaps.get("embed_gap" + suffix, 0.0), gap)
    out = [Compared("embed_gap", gaps["embed_gap"], ctx.limits["embed_gap"])]
    if ctx.control:
        out.append(Compared("embed_gap.control", gaps["embed_gap.control"],
                            ctx.limits["embed_gap"]))
    return out
