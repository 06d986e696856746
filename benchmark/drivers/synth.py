"""Driver of a batched synthesis cell: a closed loop of
``Synthesizer.synthesize(texts, embedding, pcm16=True)``, one batch of texts
a call drawn from the seed (``traffic/texts.py``), each batch spoken as one
of the cell's enrolled speakers, each call done when its 16-bit PCM is on
the host. The program's own seed (its prenet dropout's) is the cell's
``program_seed``.

The check, once the window has closed: whole batches drawn from the seed,
with the batch of the window's longest row among them, every row of each
against the plain float32 reference (``reference/``), which works out again
everything the program derived (the speaker embeddings from the enrollment
clips, the tokens, the buckets, the prenet's keep masks from the seed the
program is given, the vocoder's magnitudes) and follows the program the
way a served model's tokens are checked: the decoder teacher-forced on the
frames and the attention weights the program served (each frame, stop
logit and alignment against the reference's prediction from the same
history), the linear spectrogram
against the reference's postnet and CBHG head on the served decoder frames,
and the waveform against one reference Griffin-Lim iteration from the
program's own estimate one iteration earlier (the program's vocoder rerun
on its captured input for one iteration fewer, after a rerun of all of them
has reproduced the served estimate exactly). Each row is held to the
limits on its own: a row decoded to the bucket's cap on its first
``judge_steps`` steps, any other on all of them. The decoder's frames, stop
logits and alignments are read as the decoder returns them (its ``infer``
wrapped on the instance) and the vocoder's input and output as
``stft_matmul.griffin_lim_auto`` returns them (wrapped on the module);
everything else is what ``synthesize`` returns. Which statistics are
compared, and their limits, the cell's file says (``limits``).
"""

from __future__ import annotations

import gc
import math
import time
import wave

import numpy as np
import torch

from benchmark.harness.cell import ROOT, Compared, merge
from benchmark.reference import compact
from benchmark.reference import dsp as rdsp
from benchmark.reference import models as R
from benchmark.reference import text as rtext
from benchmark.reference.lowp import Arith, no_tf32
from benchmark.traffic import texts as traffic


def read_wav(path) -> np.ndarray:
    """A 16-bit mono wav -> float32 in [-1, 1)."""
    with wave.open(str(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: not 16-bit mono")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2").astype(np.float32) / 32768.0


def hp_dict(ctx) -> dict:
    return merge(ctx.cell.config["hp"], ctx.overrides.get("hp", {}))


def setup(ctx) -> dict:
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import stft_matmul

    cfg, params = ctx.cell.config, ctx.params
    hp = hp_dict(ctx)
    tree, stats, _ = compact.load_compact(ROOT / cfg["checkpoint"])
    synth = Synthesizer(Recursive_Parse(hp), tree, stats, seed=params["program_seed"],
                        device=ctx.device,
                        quantize=ctx.overrides.get("quantize", cfg["quantize"]))
    captured = []
    decoder = synth.tacotron.decoder
    infer = decoder.infer

    def served_decode(*args, **kwargs):  # the decoder's own outputs, kept as they are
        out = infer(*args, **kwargs)
        captured.append(out)
        return out

    decoder.infer = served_decode
    # A second set-up in one process (control.py) wraps what the first wrapped.
    gl = getattr(stft_matmul.griffin_lim_auto, "served_by", stft_matmul.griffin_lim_auto)
    vocoded = []

    def served_vocode(magnitude, n_fft, hop, n_iter, length, momentum=0.0):
        out = gl(magnitude, n_fft, hop, n_iter, length, momentum=momentum)
        vocoded.append({"mag": magnitude, "wav": out, "args": (n_fft, hop, n_iter, length),
                        "momentum": momentum})  # the vocoder's own input and output
        return out

    served_vocode.served_by = gl
    stft_matmul.griffin_lim_auto = served_vocode
    wavs = [read_wav(ROOT / p) for p in params["enroll"]]
    embeddings = [synth.enroll(w) for w in wavs]
    params = {**params, "speakers": len(wavs)}
    # The run's batches drawn before the window, as many as the window can
    # take at ``batches_per_s`` (more are drawn as they are due).
    n = math.ceil(ctx.seconds * params["batches_per_s"])
    state = {"synth": synth, "captured": captured, "vocoded": vocoded, "gl": gl, "tree": tree,
             "stats": stats, "hp": hp, "wavs": wavs, "embeddings": embeddings, "seed": ctx.seed,
             "params": params, "batches": [traffic.batch(ctx.seed, i, params) for i in range(n)],
             "longest": (0, None)}
    for i in range(params["warmup_batches"]):  # the traffic's shapes: every batch's are alike
        call(state, traffic.batch(ctx.seed, i, params, traffic.WARMUP))
    return state


def call(state: dict, batch: dict) -> dict:
    t0 = time.perf_counter()
    out = state["synth"].synthesize(batch["texts"], state["embeddings"][batch["speaker"]],
                                    pcm16=True)
    latency = time.perf_counter() - t0
    mel, stops, aligns, _ = state["captured"].pop()
    state["captured"].clear()
    vocoded = state["vocoded"][:]
    state["vocoded"].clear()
    return {"out": out, "decoded": (mel, stops, aligns), "vocoded": vocoded,
            "latency_s": latency}


def step(state: dict, i: int) -> dict:
    """One batch. Its outputs are kept for the check only where the batch
    falls in the check's sample (every ``keep_every``-th batch from an
    offset drawn from the seed) or holds the longest row so far; of every
    other batch only the lengths stay, as a server would let the rest go."""
    batches = state["batches"]
    batch = batches[i] if i < len(batches) else traffic.batch(state["seed"], i, state["params"])
    rec = call(state, batch)
    snd = state["hp"]["Sound"]
    frames = [o["mel_length"] for o in rec["out"]]
    rec.update(batch, requests=len(batch["texts"]),
               audio_s=sum(frames) * snd["Frame_Shift"] / snd["Sample_Rate"])
    every = state["params"]["keep_every"]
    offset = int(traffic.rng_for(state["seed"], 5).integers(every))
    sampled = (i + offset) % every == 0
    if max(frames) > state["longest"][0]:
        held = state["longest"][1]
        if held is not None and not held["sampled"]:
            slim(held)
        state["longest"] = (max(frames), rec)
    elif not sampled:
        slim(rec)
    rec["sampled"] = sampled
    return rec


def slim(rec: dict) -> None:
    rec["out"] = [{"mel_length": o["mel_length"]} for o in rec["out"]]
    rec.pop("decoded", None)
    rec.pop("vocoded", None)


def end_to_end(state, records, window_s) -> dict:
    lat = [r["latency_s"] * 1e3 for r in records for _ in range(r["requests"])]
    return {"synth_audio_rate": sum(r["audio_s"] for r in records) / window_s,
            "synth_p95_ms": float(np.percentile(lat, 95))}


def decode_bucket(estimate: int, max_step: int, floor: int = 64) -> int:
    b = floor
    while b < min(estimate, max_step):
        b *= 2
    return min(b, max_step)


def shapes(hp: dict, texts: list[str]) -> dict:
    """The batch's buckets by the configuration's rules: rows to a power of
    two, tokens to a multiple of 16, the decode bucket from the longest
    text (``Max_Frames_Per_Token`` frames a token, floor 64, at most
    ``Max_Step``)."""
    ids = [rtext.encode(t) for t in texts]
    longest = max(len(s) for s in ids)
    dec = hp["Decoder"]
    max_steps = decode_bucket(longest * dec["Max_Frames_Per_Token"], dec["Max_Step"])
    return {"ids": ids, "B": 1 << max(0, (len(ids) - 1).bit_length()),
            "S": -(-longest // 16) * 16, "max_steps": max_steps}


def work(state, records) -> dict:
    """What the per-layer readers count: each batch's buckets and the
    decoded length of every row."""
    hp = state["hp"]
    r = hp["Decoder"]["N_Frames_Per_Step"]
    batches = []
    for rec in records:
        sh = shapes(hp, rec["texts"])
        frames = [o["mel_length"] for o in rec["out"]]
        batches.append({"S": sh["S"], "n_steps": sh["max_steps"] // r,
                        "steps": [f // r for f in frames], "frames": frames})
    return {"hp": hp, "batches": batches}


# -- the check ---------------------------------------------------------------------
def enroll_reference(G, wav: np.ndarray, hp: dict, device, ar: Arith) -> torch.Tensor:
    """The enrollment as the configuration defines it: the clip wrap-padded
    to a power of two (at least 2^13 samples and one window of frames),
    its mel, the GE2E windows inside its real frames."""
    snd, spk = hp["Sound"], hp["Speaker_Embedding"]["GE2E"]
    hop, win, shift = snd["Frame_Shift"], spk["Window_Length"], spk["Window_Shift"]
    floor_pow = max(math.ceil(math.log2(max((win - 1) * hop, 2))), 13)
    L = 1 << max(math.ceil(math.log2(max(len(wav), 2))), floor_pow)
    padded = torch.tensor(np.pad(wav, (0, L - len(wav)), mode="wrap"), device=device)[None]
    mel = rdsp.melspectrogram(padded, snd, ar)
    true = torch.tensor([1 + len(wav) // hop], device=device)
    return R.utterance_embedding(G, mel, true, win, shift, ar)[0]


def prenet_keep(hp: dict, seed: int, rows: int, steps: int, device) -> list[torch.Tensor]:
    """The prenet's keep masks as the program is told to draw them from its
    seed: per step, a (rows, size) uniform draw a layer from one generator
    on the device, kept below 1 - rate. -> one (rows, steps, size) mask a
    layer."""
    pre = hp["Decoder"]["Prenet"]
    g = torch.Generator(device).manual_seed(seed)
    keep = 1.0 - pre["Dropout_Rate"]
    draws = [[torch.rand((rows, s), generator=g, device=device) < keep for s in pre["Sizes"]]
             for _ in range(steps)]
    return [torch.stack([d[li] for d in draws], dim=1) for li in range(len(pre["Sizes"]))]


def sample_batches(records, seed: int, n: int) -> list[int]:
    """The batch of the window's longest row and ``n - 1`` more drawn from
    the seed among the batches whose outputs were kept."""
    kept = [b for b, rec in enumerate(records) if "decoded" in rec]
    longest = max(kept, key=lambda b: max(o["mel_length"] for o in records[b]["out"]))
    rest = [b for b in kept if b != longest]
    pick = traffic.rng_for(seed, 3).permutation(len(rest))[:max(n - 1, 0)]
    return sorted([longest] + [rest[k] for k in pick])


class Gaps:
    """Per statistic, over the rows compared: the widest absolute gap
    (``<name>_gap``), and of the rows' root mean square gaps the largest
    (``<name>_row``) and the median (``<name>_med``); ``rows`` keeps each
    row's."""

    def __init__(self):
        self.max, self.rows = {}, {}

    def add(self, name: str, diff: torch.Tensor, scale: float = 1.0) -> None:
        """One row's gaps, the root mean square over ``scale``."""
        d = diff.detach().double()
        self.worst(name, float(d.abs().max()))
        self.rows.setdefault(name, []).append(float(d.pow(2).mean().sqrt()) / scale)

    def worst(self, name: str, value: float) -> None:
        self.max[name] = max(self.max.get(name, -math.inf), value)

    def stats(self) -> dict:
        return {**{f"{k}_gap": v for k, v in self.max.items()},
                **{f"{k}_row": max(v) for k, v in self.rows.items()},
                **{f"{k}_med": float(np.median(v)) for k, v in self.rows.items()}}


def check(state, records, ctx) -> list[Compared]:
    from multi_speaker_tts_tpu_torch.ops import stft_matmul

    stft_matmul.griffin_lim_auto = state["gl"]  # the capture of set-up undone
    device = state["synth"].device
    hp, lim, snd = state["hp"], ctx.limits, state["hp"]["Sound"]
    state.pop("synth")
    state["captured"].clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    P = R.to_device(state["tree"]["tacotron"], device)
    S = R.to_device(state["stats"]["tacotron"], device)
    G = R.to_device(state["tree"]["ge2e"], device)
    dec = hp["Decoder"]
    r = dec["N_Frames_Per_Step"]
    judge = ctx.params["judge_steps"]
    report = ctx.control or ctx.overrides.get("report_rows", False)
    full, low = Arith(False), Arith(True)
    gaps = {"": Gaps()}
    if ctx.control:
        gaps[".control"] = Gaps()
    rows_seen = []  # (batch, row, frames, capped) in the order the gaps were added

    with torch.no_grad():
        ref_spk = [enroll_reference(G, w, hp, device, full) for w in state["wavs"]]
        for i, w in enumerate(state["wavs"]):
            prog = torch.tensor(state["embeddings"][i], device=device)
            gaps[""].worst("enroll", float(torch.linalg.vector_norm(prog - ref_spk[i])))
            if ctx.control:
                ctl = enroll_reference(G, w, hp, device, low)
                gaps[".control"].worst("enroll", float(torch.linalg.vector_norm(ctl - ref_spk[i])))

        picks = sample_batches(records, state["seed"], ctx.params["check_batches"])
        keep = prenet_keep(hp, ctx.params["program_seed"], shapes(hp, records[0]["texts"])["B"],
                           max(records[b]["decoded"][1].shape[1] for b in picks), device)
        keep_prob = 1.0 - dec["Prenet"]["Dropout_Rate"]
        by_S: dict[int, list] = {}
        for b in picks:
            for j in range(len(records[b]["out"])):
                by_S.setdefault(shapes(hp, records[b]["texts"])["S"], []).append((b, j))
        for S_, group in by_S.items():
            n_rows = len(group)
            ids = [shapes(hp, records[b]["texts"])["ids"][j] for b, j in group]
            tokens = torch.full((n_rows, S_), rtext.PAD_ID, dtype=torch.long, device=device)
            for k, s in enumerate(ids):
                tokens[k, :len(s)] = torch.tensor(s, device=device)
            lengths = torch.tensor([len(s) for s in ids], device=device)
            spk = torch.stack([ref_spk[records[b]["speaker"]] for b, _ in group])
            served_mel = torch.stack([records[b]["decoded"][0][j].float() for b, j in group])
            frames = [records[b]["out"][j]["mel_length"] for b, j in group]
            caps = [shapes(hp, records[b]["texts"])["max_steps"] for b, _ in group]
            n = max(frames) // r
            # The decoder's input at step t: the last frame of step t - 1 as served.
            inputs = torch.cat([served_mel.new_zeros(n_rows, 1, served_mel.shape[-1]),
                                served_mel[:, r - 1:(n - 1) * r:r]], dim=1)
            kp = [m[[j for _, j in group], :n] for m in keep]
            # The postnet reads the decoded frames zeroed past each row's length,
            # over the whole decode bucket, as the model defines it.
            n_frames = torch.tensor(frames, device=device)
            mel_pre = served_mel * (torch.arange(served_mel.shape[1], device=device)[None, :, None]
                                    < n_frames[:, None, None])
            # ... and its attention's previous weights those the program served.
            a_served = torch.stack([records[b]["decoded"][2][j, :n].float() for b, j in group])
            mem, mask = R.memory(P, S, tokens, lengths, spk, full)
            f_ref, s_ref, a_ref = R.decode_teacher_forced(P, mem, mask, inputs, kp, keep_prob, full,
                                                          a_served)
            post_ref = mel_pre + R.postnet(P, S, mel_pre, full)
            lin_ref = R.cbhg_linear(P, S, post_ref, full)
            served = {"": {
                "frames": served_mel[:, :n * r],
                "stops": torch.stack([records[b]["decoded"][1][j, :n].float() for b, j in group]),
                "aligns": a_served,
                "post": [torch.tensor(records[b]["out"][j]["mel"], device=device) for b, j in group],
                "linear": [torch.tensor(records[b]["out"][j]["linear"], device=device)
                           for b, j in group]}}
            if ctx.control:
                # The control in the program's place, at the same positions.
                mem_c, mask_c = R.memory(P, S, tokens, lengths, spk, low)
                f_c, s_c, a_c = R.decode_teacher_forced(P, mem_c, mask_c, inputs, kp, keep_prob, low,
                                                        a_served)
                post_c = mel_pre + R.postnet(P, S, mel_pre, low)
                lin_c = R.cbhg_linear(P, S, post_c, low)
                served[".control"] = {"frames": f_c.reshape(n_rows, n * r, -1), "stops": s_c,
                                      "aligns": a_c, "post": [post_c[k, :f] for k, f in
                                                              enumerate(frames)],
                                      "linear": [lin_c[k, :f] for k, f in enumerate(frames)]}
            f_ref = f_ref.reshape(n_rows, n * r, -1)
            for k, (f, cap) in enumerate(zip(frames, caps)):
                rows_seen.append((group[k][0], group[k][1], f, f >= cap))
            for suffix, srv in served.items():
                g = gaps[suffix]
                for k, (f, cap) in enumerate(zip(frames, caps)):
                    st = f // r if f < cap else min(f // r, judge)
                    g.add("frame", srv["frames"][k, :st * r] - f_ref[k, :st * r])
                    g.add("stop", srv["stops"][k, :st] - s_ref[k, :st])
                    g.add("align", srv["aligns"][k, :st] - a_ref[k, :st])
                    g.add("postnet", srv["post"][k] - post_ref[k, :f])
                    g.add("linear", srv["linear"][k] - lin_ref[k, :f])
        del P, S, mem, f_ref, s_ref, a_ref, post_ref, lin_ref
        vocode_check(state, records, picks, gaps, device, snd, ctx.control)
    if report:
        report_rows(gaps, rows_seen)
    got = gaps[""].stats()
    out = [Compared(k, got[k], lim[k]) for k in lim]
    if ctx.control:
        ctl = gaps[".control"].stats()
        out += [Compared(k, got[k], math.inf) for k in sorted(got) if k not in lim]
        out += [Compared(k + ".control", ctl[k], lim.get(k, math.inf)) for k in sorted(ctl)]
    return out


def vocode_check(state, records, picks, gaps, device, snd, control: bool) -> None:
    """Each picked batch's vocoder call: rerun on its captured input, all of
    its iterations (``vocode_rerun_gap``: the widest gap from the served
    estimate; the teacher forcing below holds only where it is 0) and one
    fewer. Then every row of the served 16-bit waveform against the
    reference's: one reference iteration from the program's estimate one
    iteration earlier, onto the magnitudes the reference works out from the
    served linear spectrogram, on the samples whose frames all lie inside
    the row's served length (the served estimate elsewhere), then the
    inverse pre-emphasis and the 16-bit steps. ``vocode_row``: the largest
    row root mean square gap on those samples over the row's root mean
    square there."""
    n_fft, hop, coef = snd["Frame_Length"], snd["Frame_Shift"], snd["Preemphasis"]
    arths = {"": Arith(False), **({".control": Arith(True)} if control else {})}
    for b in picks:
        for call_ in records[b]["vocoded"]:
            if call_["momentum"]:
                raise ValueError("the vocoder's check follows the plain iteration: momentum 0")
            n_fft_, hop_, n_iter, length = call_["args"]
            again = state["gl"](call_["mag"], n_fft_, hop_, n_iter, length)
            gaps[""].worst("vocode_rerun", float((again - call_["wav"]).abs().max()))
            before = state["gl"](call_["mag"], n_fft_, hop_, n_iter - 1, length).float()
            del again
            T = before.shape[1] // hop + 1
            rows = records[b]["out"]
            mag = torch.zeros((len(rows), T, n_fft // 2 + 1), device=device)
            for j, o in enumerate(rows):
                f = min(o["mel_length"], T)
                mag[j, :f] = rdsp.linear_magnitude(
                    torch.tensor(o["linear"][:f], device=device).float(), snd)
            spans = [(n_fft, (o["mel_length"] - 1) * hop - n_fft) for o in rows]
            pcm = {}
            for suffix, ar in arths.items():
                step_ = rdsp.griffin_lim_step(before, mag, n_fft, hop, ar)
                mixed = call_["wav"].double().clone()
                for j, (lo, hi) in enumerate(spans):
                    if hi > lo:
                        mixed[j, lo:hi] = step_[j, lo:hi]
                pcm[suffix] = rdsp.pcm16(rdsp.inv_preemphasis(mixed, coef))
            for j, ((lo, hi), o) in enumerate(zip(spans, rows)):
                if hi <= lo:
                    continue
                ref = pcm[""][j, lo:hi]
                scale = float(ref.pow(2).mean().sqrt().clamp(min=1.0))
                served = torch.tensor(o["wav"][lo:hi], device=device).double()
                gaps[""].add("vocode", served - ref, scale)
                if control:
                    gaps[".control"].add("vocode", pcm[".control"][j, lo:hi] - ref, scale)


def report_rows(gaps, rows_seen) -> None:
    """Each compared row's gaps, for the readings limits are set from."""
    import json
    import sys

    for suffix, g in gaps.items():
        print("rows" + suffix + " " + json.dumps({
            "rows": [list(x) for x in rows_seen],
            **{k: v for k, v in g.rows.items()}}), file=sys.stderr)
