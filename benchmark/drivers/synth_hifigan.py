"""Driver of a batched synthesis cell whose vocoder is the HiFi-GAN V1
generator: ``synth.py``'s closed loop of ``Synthesizer.synthesize(texts,
embedding, pcm16=True)`` on the same traffic, its timed call, records,
end-to-end metrics and work (imported from it), with a set-up and a check
of its own.

Set-up: ``synth.py``'s, with the configuration's ``Vocoder`` section on and
the generator's folded float32 weights drawn from the run's seed
(``reference/hifigan.py``) given to the program as ``vocoder_params``. The
decoder's ``infer`` and the generator's ``forward`` are wrapped on their
instances to keep what each returned: the generator's input (the postnet's
mel at the vocoder bucket) and its waveform.

The check, once the window has closed, on ``synth.py``'s sample of whole
batches:

- the speaker embeddings, the decoder's frames, stop logits and attention
  weights (teacher-forced on what the program served) and the postnet as
  ``synth.py`` checks them (``enroll_gap``, ``frame_*``, ``stop_*``,
  ``align_*``, ``postnet_*``);
- each picked batch's generator call, rerun through the program's own
  stages (``pre``, ``stage``, ``post``) on its captured input: the rerun's
  waveform against the one captured (``wave_rerun_gap``: exact), then each
  stage's output against the reference's stage on the program's own
  previous activation (``stage_row``: the largest row root mean square gap
  of any stage over the row's decoded frames, over the row's root mean
  square there). A single stage's bf16 rounding is far smaller than that
  of the generator's thirty convolutions end to end, so this follows the
  program stage by stage as the decoder's check follows it step by step;
- every row's served 16-bit waveform against the reference generator run
  whole on the captured input (``wave_row`` the largest row's root mean
  square gap over the row's root mean square, ``wave_med`` the median
  row's), on the row's served samples.

Which statistics are compared, and their limits, the cell's file says.
"""

from __future__ import annotations

import gc
import math

import numpy as np
import torch

from benchmark.drivers import synth
from benchmark.drivers.synth import (  # noqa: F401  (the harness calls these by name)
    Gaps, call, end_to_end, enroll_reference, prenet_keep, report_rows, sample_batches,
    shapes, step, work)
from benchmark.harness.cell import ROOT, Compared
from benchmark.reference import compact
from benchmark.reference import dsp as rdsp
from benchmark.reference import hifigan as RH
from benchmark.reference import models as R
from benchmark.reference import text as rtext
from benchmark.reference.lowp import Arith, no_tf32
from benchmark.traffic import texts as traffic

WEIGHTS_STREAM = 7  # the seed's stream of the generator's weights (traffic.rng_for)


def weights(ctx, hp: dict) -> dict[str, np.ndarray]:
    return RH.draw_weights(hp["Vocoder"]["HiFiGAN"], hp["Sound"]["Mel_Dim"],
                           traffic.rng_for(ctx.seed, WEIGHTS_STREAM))


def setup(ctx) -> dict:
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.inference import Synthesizer

    cfg, params = ctx.cell.config, ctx.params
    hp = synth.hp_dict(ctx)
    tree, stats, _ = compact.load_compact(ROOT / cfg["checkpoint"])
    W = weights(ctx, hp)
    program = Synthesizer(Recursive_Parse(hp), tree, stats, seed=params["program_seed"],
                          device=ctx.device,
                          quantize=ctx.overrides.get("quantize", cfg["quantize"]),
                          vocoder_params=W)
    captured, vocoded = [], []
    decoder, generator = program.tacotron.decoder, program.vocoder
    infer, forward = decoder.infer, generator.forward

    def served_decode(*args, **kwargs):  # the decoder's own outputs, kept as they are
        out = infer(*args, **kwargs)
        captured.append(out)
        return out

    def served_vocode(mel):  # the generator's own input and output
        out = forward(mel)
        vocoded.append({"mel": mel, "wav": out})
        return out

    decoder.infer, generator.forward = served_decode, served_vocode
    wavs = [synth.read_wav(ROOT / p) for p in params["enroll"]]
    embeddings = [program.enroll(w) for w in wavs]
    params = {**params, "speakers": len(wavs)}
    n = math.ceil(ctx.seconds * params["batches_per_s"])
    state = {"synth": program, "generator": generator, "captured": captured, "vocoded": vocoded,
             "weights": W, "tree": tree, "stats": stats, "hp": hp, "wavs": wavs,
             "embeddings": embeddings, "seed": ctx.seed, "params": params,
             "batches": [traffic.batch(ctx.seed, i, params) for i in range(n)],
             "longest": (0, None)}
    for i in range(params["warmup_batches"]):  # the traffic's shapes: every batch's are alike
        call(state, traffic.batch(ctx.seed, i, params, traffic.WARMUP))
    return state


def check(state, records, ctx) -> list[Compared]:
    device, lim = state["synth"].device, ctx.limits
    state.pop("synth")  # the generator stays (state["generator"]) for its rerun
    state["captured"].clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    report = ctx.control or ctx.overrides.get("report_rows", False)
    gaps = {"": Gaps(), **({".control": Gaps()} if ctx.control else {})}
    rows_seen = []
    picks = sample_batches(records, state["seed"], ctx.params["check_batches"])
    with torch.no_grad():
        decoder_check(state, records, picks, gaps, rows_seen, device, ctx)
        vocoder_check(state, records, picks, gaps, device, ctx.control)
    if report:
        report_rows(gaps, rows_seen)
    got = gaps[""].stats()
    out = [Compared(k, got[k], lim[k]) for k in lim]
    if ctx.control:
        ctl = gaps[".control"].stats()
        out += [Compared(k, got[k], math.inf) for k in sorted(got) if k not in lim]
        out += [Compared(k + ".control", ctl[k], lim.get(k, math.inf)) for k in sorted(ctl)]
    return out


def decoder_check(state, records, picks, gaps, rows_seen, device, ctx) -> None:
    """``synth.py``'s check of the enrollment, the decoder and the postnet
    (this configuration has no linear head)."""
    hp = state["hp"]
    P = R.to_device(state["tree"]["tacotron"], device)
    S = R.to_device(state["stats"]["tacotron"], device)
    G = R.to_device(state["tree"]["ge2e"], device)
    dec = hp["Decoder"]
    r = dec["N_Frames_Per_Step"]
    judge = ctx.params["judge_steps"]
    full, low = Arith(False), Arith(True)

    ref_spk = [enroll_reference(G, w, hp, device, full) for w in state["wavs"]]
    for i, w in enumerate(state["wavs"]):
        prog = torch.tensor(state["embeddings"][i], device=device)
        gaps[""].worst("enroll", float(torch.linalg.vector_norm(prog - ref_spk[i])))
        if ctx.control:
            ctl = enroll_reference(G, w, hp, device, low)
            gaps[".control"].worst("enroll", float(torch.linalg.vector_norm(ctl - ref_spk[i])))

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
        inputs = torch.cat([served_mel.new_zeros(n_rows, 1, served_mel.shape[-1]),
                            served_mel[:, r - 1:(n - 1) * r:r]], dim=1)
        kp = [m[[j for _, j in group], :n] for m in keep]
        n_frames = torch.tensor(frames, device=device)
        mel_pre = served_mel * (torch.arange(served_mel.shape[1], device=device)[None, :, None]
                                < n_frames[:, None, None])
        a_served = torch.stack([records[b]["decoded"][2][j, :n].float() for b, j in group])
        mem, mask = R.memory(P, S, tokens, lengths, spk, full)
        f_ref, s_ref, a_ref = R.decode_teacher_forced(P, mem, mask, inputs, kp, keep_prob, full,
                                                      a_served)
        post_ref = mel_pre + R.postnet(P, S, mel_pre, full)
        served = {"": {
            "frames": served_mel[:, :n * r],
            "stops": torch.stack([records[b]["decoded"][1][j, :n].float() for b, j in group]),
            "aligns": a_served,
            "post": [torch.tensor(records[b]["out"][j]["mel"], device=device) for b, j in group]}}
        if ctx.control:
            mem_c, mask_c = R.memory(P, S, tokens, lengths, spk, low)
            f_c, s_c, a_c = R.decode_teacher_forced(P, mem_c, mask_c, inputs, kp, keep_prob, low,
                                                    a_served)
            post_c = mel_pre + R.postnet(P, S, mel_pre, low)
            served[".control"] = {"frames": f_c.reshape(n_rows, n * r, -1), "stops": s_c,
                                  "aligns": a_c,
                                  "post": [post_c[k, :f] for k, f in enumerate(frames)]}
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


def _rms(x: torch.Tensor) -> float:
    return float(x.double().pow(2).mean().sqrt())


def vocoder_check(state, records, picks, gaps, device, control: bool) -> None:
    """Each picked batch's generator call: the program's pieces (``pre``,
    each ``stage``, ``post``) rerun on its captured input, the rerun's
    waveform against the captured one, and each piece's output against the
    reference's piece on the program's own input to it; then the served
    waveform against the reference generator on the captured input."""
    hp = state["hp"]
    cfg, hop = hp["Vocoder"]["HiFiGAN"], hp["Sound"]["Frame_Shift"]
    rates = cfg["Upsample_Rates"]
    gen = state["generator"]
    W = {k: torch.as_tensor(v, device=device) for k, v in state["weights"].items()}
    arths = {"": Arith(False), **({".control": Arith(True)} if control else {})}
    # samples a frame at the output of conv_pre, of each stage and of conv_post
    per_frame = [1] + [math.prod(rates[:i + 1]) for i in range(len(rates))] + [hop]

    def piece(s: int, x: torch.Tensor, ar: Arith) -> torch.Tensor:
        if s == 0:
            return RH.pre(W, x, ar)
        return RH.stage(W, s - 1, x, cfg, ar) if s <= len(rates) else RH.post(W, x, ar)

    for b in picks:
        for call_ in records[b]["vocoded"]:
            mel, rows = call_["mel"], records[b]["out"]
            acts = [gen.pre(mel)]
            for i in range(len(rates)):
                acts.append(gen.stage(i, acts[-1]))
            acts.append(gen.post(acts[-1]))
            gaps[""].worst("wave_rerun", float((acts[-1] - call_["wav"]).abs().max()))
            for s, x in enumerate([mel] + acts[:-1]):
                ref = piece(s, x, arths[""])
                served = {"": acts[s], **{k: piece(s, x, ar) for k, ar in arths.items() if k}}
                for suffix, got in served.items():
                    for j, o in enumerate(rows):
                        span = o["mel_length"] * per_frame[s]
                        f = ref[j, ..., :span]
                        gaps[suffix].add("stage", got[j, ..., :span] - f, max(_rms(f), 1e-30))
                del ref, served
            del acts
            pcm = {k: rdsp.pcm16(RH.generate(W, mel, cfg, ar).double()) for k, ar in arths.items()}
            for j, o in enumerate(rows):
                n = len(o["wav"])
                ref = pcm[""][j, :n]
                scale = max(_rms(ref), 1.0)
                gaps[""].add("wave", torch.tensor(o["wav"], device=device).double() - ref, scale)
                if control:
                    gaps[".control"].add("wave", pcm[".control"][j, :n] - ref, scale)
