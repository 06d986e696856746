"""Trained-checkpoint conversion parity (port of the top-level
``tools/torch_parity.py``).

Trains the port's copy of the reconstructed reference model
(``convert/reference_torch.py``: the per-frame Python decode loop) with the
reference recipe on a corpus (GE2E pretraining, then teacher-forced TTS
with the encoder frozen), saves a reference-style ``torch.save`` checkpoint,
converts it with the production mapping tables (``convert/mapping.py``)
into the port's models (``weights.params_from_jax``), and measures both on
identical batches:

- elementwise forward parity (mel pre / post, stop logits, alignments,
  linear, GE2E embeddings) on the trained weights;
- quality metrics side by side (teacher-forced masked mel L1 pre / post,
  stop accuracy, attention diagonality): the converted model must
  reproduce the torch model's numbers, not merely finite ones.

    python -m multi_speaker_tts_tpu_torch.tools.torch_parity -out DIR \\
        [-steps 300] [-ge2e_steps 300] [-hp_from demo/serving_ckpt.msgpack] [-device cpu]

``main`` takes the serving-width configuration from a compact
checkpoint's ``meta["hp"]`` (the demo's by default) at one frame a step.
The tests drive it at tiny widths on the CPU (``tests/test_torch_convert.py``).
"""

from __future__ import annotations

import numpy as np
import torch


# --------------------------------------------------------------------------
# torch-side GE2E loss (the GE2E softmax loss, eq. 5/6/8/9 of Wan et al.)
# --------------------------------------------------------------------------

def torch_ge2e_loss(emb, w, b):
    """emb: (N, M, E) unit-norm torch tensor; w, b scalar Parameters."""
    N, M, _ = emb.shape
    centroids = emb.mean(dim=1)
    centroids_n = centroids / centroids.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    loo = (emb.sum(dim=1, keepdim=True) - emb) / (M - 1)
    loo_n = loo / loo.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    cos_all = torch.einsum("jme,ke->jmk", emb, centroids_n)
    cos_own = torch.einsum("jme,jme->jm", emb, loo_n)
    own_col = torch.eye(N, dtype=emb.dtype, device=emb.device)[:, None, :]  # (N, 1, N)
    cos = cos_all * (1.0 - own_col) + cos_own[..., None] * own_col
    S = w.clamp(min=1e-6) * cos + b
    own = S.gather(2, torch.arange(N, device=emb.device)[:, None, None].expand(N, M, 1))[..., 0]
    return (-own + torch.logsumexp(S, dim=2)).mean()


# --------------------------------------------------------------------------
# torch-side synthesizer losses (the trainer's losses)
# --------------------------------------------------------------------------

def torch_tacotron_losses(out, mels, mel_lengths, token_lengths, spects, r):
    B, T, _ = mels.shape
    dev = mels.device
    mask = (torch.arange(T, device=dev)[None, :] < mel_lengths[:, None]).float()

    def masked_l1(pred, target):
        err = (pred - target).abs() * mask[..., None]
        return err.sum() / (mask.sum() * pred.shape[-1]).clamp(min=1.0)

    losses = {
        "mel_pre": masked_l1(out["mel_pre"], mels),
        "mel_post": masked_l1(out["mel_post"], mels),
    }
    # Stop BCE: target 1 at/after the last valid step, positives x5.
    logits = out["stop_logits"]
    n_steps = logits.shape[1]
    lengths_steps = torch.ceil(mel_lengths.float() / r).long()
    steps = torch.arange(n_steps, device=dev)[None, :]
    target = (steps >= (lengths_steps[:, None] - 1)).float()
    valid = (steps < lengths_steps[:, None]).float()
    bce = (logits.clamp(min=0) - logits * target
           + torch.log1p(torch.exp(-logits.abs())))
    weight = torch.where(target > 0, 5.0, 1.0) * valid
    losses["stop"] = (bce * weight).sum() / weight.sum().clamp(min=1.0)
    total = losses["mel_pre"] + losses["mel_post"] + losses["stop"]
    if spects is not None and "linear" in out:
        losses["linear"] = masked_l1(out["linear"], spects)
        total = total + losses["linear"]
    # Guided attention (Tachibana, sigma 0.2, weight 10: the trainer's defaults).
    align = out["alignments"]  # (B, steps, S)
    _, Td, S = align.shape
    t_pos = (torch.arange(Td, device=dev)[None, :, None]
             / lengths_steps[:, None, None].clamp(min=1))
    s_pos = (torch.arange(S, device=dev)[None, None, :]
             / token_lengths[:, None, None].clamp(min=1))
    W = 1.0 - torch.exp(-((s_pos - t_pos) ** 2) / (2 * 0.2**2))
    amask = ((torch.arange(Td, device=dev)[None, :] < lengths_steps[:, None]).float()[:, :, None]
             * (torch.arange(S, device=dev)[None, :] < token_lengths[:, None]).float()[:, None, :])
    losses["guided_attention"] = (align * W * amask).sum() / amask.sum().clamp(min=1.0)
    total = total + 10.0 * losses["guided_attention"]
    losses["total"] = total
    return losses


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def train_torch_reference(hp, pattern_dir: str, tts_steps: int, ge2e_steps: int,
                          seed: int = 0, lr: float = 1e-3, log=print, device="cpu"):
    """The reference recipe in torch: GE2E pretraining (SGD with momentum,
    w / b gradients scaled, clip 3.0), then teacher-forced TTS training with
    the encoder frozen (Adam, clip 1.0). Returns (taco, ge2e) on ``device``
    (the CPU unless asked)."""
    from multi_speaker_tts_tpu_torch.convert.reference_torch import (
        build_reference_ge2e, build_reference_tacotron,
    )
    from multi_speaker_tts_tpu_torch.data.datasets import (
        BucketBatcher, GE2EBatchSampler, PatternDataset,
    )

    dev = torch.device(device)
    torch.manual_seed(seed)
    ds = PatternDataset(pattern_dir)

    # --- GE2E pretraining --------------------------------------------------
    ge2e = build_reference_ge2e(hp).to(dev)
    N = int(hp.GE2E_Train.Batch_Speakers)
    M = int(hp.GE2E_Train.Batch_Utterances)
    w = torch.nn.Parameter(torch.tensor(
        float(hp.Speaker_Embedding.GE2E.Loss.Initial_Weight), device=dev))
    b = torch.nn.Parameter(torch.tensor(
        float(hp.Speaker_Embedding.GE2E.Loss.Initial_Bias), device=dev))
    opt = torch.optim.SGD(list(ge2e.parameters()) + [w, b],
                          lr=float(hp.GE2E_Train.Learning_Rate), momentum=0.9)
    scale = float(hp.GE2E_Train.get("Scale_Gradient", 0.01))
    sampler = GE2EBatchSampler(ds, N, M, int(hp.GE2E_Train.Frame_Length), seed=seed)
    ge2e.train()
    for step in range(1, ge2e_steps + 1):
        mels = torch.from_numpy(sampler.sample()["mels"]).to(dev)
        emb = ge2e(mels).reshape(N, M, -1)
        loss = torch_ge2e_loss(emb, w, b)
        opt.zero_grad()
        loss.backward()
        torch.nn.utils.clip_grad_norm_(list(ge2e.parameters()) + [w, b], 3.0)
        with torch.no_grad():
            w.grad *= scale
            b.grad *= scale
        opt.step()
        with torch.no_grad():
            w.clamp_(min=1e-6)
        if step % 50 == 0 or step == ge2e_steps:
            log(f"torch GE2E step {step}/{ge2e_steps} loss {loss.item():.4f}")
    ge2e.eval()

    # --- TTS training, the encoder frozen -----------------------------------
    taco = build_reference_tacotron(hp).to(dev)
    r = int(hp.Decoder.get("N_Frames_Per_Step", 1))
    lh = hp.get("Linear_Head")
    use_linear = lh is not None and lh.Use
    batcher = BucketBatcher(
        ds,
        batch_size=int(hp.Train.Batch_Size),
        token_buckets=list(hp.Train.Batch_Bucketing.Token_Buckets),
        mel_buckets=list(hp.Train.Batch_Bucketing.Mel_Buckets),
        mel_dim=int(hp.Sound.Mel_Dim),
        n_frames_per_step=r,
        ref_window=int(hp.Speaker_Embedding.GE2E.Window_Length),
        spect_dim=int(hp.Sound.Spectrogram_Dim) if use_linear else None,
        seed=seed,
    )
    if not batcher.assignment:
        raise ValueError(
            f"no utterances fit the buckets (token {batcher.token_buckets}, "
            f"mel {batcher.mel_buckets}); {batcher.n_dropped} dropped"
        )
    opt = torch.optim.Adam(taco.parameters(), lr=lr)
    taco.train()
    step = 0
    while step < tts_steps:
        for _, batch in batcher:
            if step >= tts_steps:
                break
            tokens = torch.from_numpy(batch["tokens"]).long().to(dev)
            token_lengths = torch.from_numpy(batch["token_lengths"]).long().to(dev)
            mels = torch.from_numpy(batch["mels"]).to(dev)
            mel_lengths = torch.from_numpy(batch["mel_lengths"]).long().to(dev)
            spects = torch.from_numpy(batch["spects"]).to(dev) if use_linear else None
            with torch.no_grad():
                spk = ge2e(torch.from_numpy(batch["ref_mels"]).to(dev))
            out = taco(tokens, token_lengths, mels, spk)
            losses = torch_tacotron_losses(out, mels, mel_lengths, token_lengths, spects, r)
            opt.zero_grad()
            losses["total"].backward()
            torch.nn.utils.clip_grad_norm_(taco.parameters(), 1.0)
            opt.step()
            step += 1
            if step % 50 == 0 or step == tts_steps:
                log(f"torch TTS step {step}/{tts_steps} "
                    f"total {losses['total'].item():.4f} "
                    f"mel_post {losses['mel_post'].item():.4f}")
    taco.eval()
    return taco, ge2e


# --------------------------------------------------------------------------
# evaluation on identical batches
# --------------------------------------------------------------------------

def _np_masked_l1(pred, target, mel_lengths):
    B, T, _ = target.shape
    mask = (np.arange(T)[None, :] < mel_lengths[:, None]).astype(np.float32)
    err = np.abs(pred - target) * mask[..., None]
    return float(err.sum() / max(mask.sum() * target.shape[-1], 1.0))


def _np_stop_accuracy(logits, mel_lengths, r):
    n_steps = logits.shape[1]
    lengths_steps = np.ceil(mel_lengths / r).astype(np.int64)
    steps = np.arange(n_steps)[None, :]
    target = steps >= (lengths_steps[:, None] - 1)
    valid = steps < lengths_steps[:, None]
    pred = logits >= 0.0  # sigmoid >= 0.5
    return float(((pred == target) & valid).sum() / max(valid.sum(), 1))


def converted_models(tree: dict, hp, device):
    """A converted ``{"params", "batch_stats"}`` tree -> the port's (Tacotron,
    GE2E) on ``device``, in eval mode, in the hp's compute dtype."""
    from multi_speaker_tts_tpu_torch.models.ge2e import GE2E
    from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
    from multi_speaker_tts_tpu_torch.ops.numerics import compute_dtype_of
    from multi_speaker_tts_tpu_torch.weights import load_into, params_from_jax

    state = params_from_jax(tree["params"], tree["batch_stats"], hp)
    cd = compute_dtype_of(hp)
    taco, ge2e = Tacotron(hp, cd), GE2E.from_hp(hp, cd)
    load_into(taco, state, "tacotron.")
    load_into(ge2e, state, "ge2e.")
    return taco.to(device).eval(), ge2e.to(device).eval()


def compare_on_identical_batches(hp, taco, ge2e, pattern_dir: str, n_batches: int = 8,
                                 seed: int = 0, device=None):
    """Save the trained torch models reference-style, convert them into the
    port's models, and run both on the same collated batches (eval mode,
    prenet dropout 0 on both sides, so the comparison is deterministic), on
    ``device`` (the card unless the caller asks for the CPU).

    Returns a report: each side's metrics, their absolute deltas, and the
    largest elementwise |torch - port| per output."""
    import tempfile

    from multi_speaker_tts_tpu_torch.convert.mapping import convert_full_checkpoint
    from multi_speaker_tts_tpu_torch.convert.reference_torch import (
        build_reference_ge2e, build_reference_tacotron, save_reference_checkpoint,
    )
    from multi_speaker_tts_tpu_torch.data.datasets import BucketBatcher, PatternDataset
    from multi_speaker_tts_tpu_torch.evaluate import attention_diagonality
    from multi_speaker_tts_tpu_torch.inference import resolve_device

    dev = resolve_device(device)
    hp_eval = hp.replace(Decoder={"Prenet": {"Dropout_Rate": 0.0}})
    r = int(hp.Decoder.get("N_Frames_Per_Step", 1))
    lh = hp.get("Linear_Head")
    use_linear = lh is not None and lh.Use

    # Eval-config torch models with the trained weights (the dropout rate is
    # baked into the module closures when they are built).
    taco_eval = build_reference_tacotron(hp_eval)
    taco_eval.load_state_dict(taco.state_dict())
    taco_eval.to(dev).eval()
    ge2e_eval = build_reference_ge2e(hp_eval)
    ge2e_eval.load_state_dict(ge2e.state_dict())
    ge2e_eval.to(dev).eval()

    with tempfile.TemporaryDirectory() as td:
        path = f"{td}/S_trained.pt"
        save_reference_checkpoint(path, tacotron=taco_eval, ge2e=ge2e_eval)
        converted = convert_full_checkpoint(path, hp_eval)
    taco_p, ge2e_p = converted_models(converted, hp_eval, dev)

    # Identical batches: collected once (deterministic order and crops).
    batcher = BucketBatcher(
        PatternDataset(pattern_dir),
        batch_size=int(hp.Train.get("Eval_Batch_Size", 8)),
        token_buckets=list(hp.Train.Batch_Bucketing.Token_Buckets),
        mel_buckets=list(hp.Train.Batch_Bucketing.Mel_Buckets),
        mel_dim=int(hp.Sound.Mel_Dim),
        n_frames_per_step=r,
        ref_window=int(hp.Speaker_Embedding.GE2E.Window_Length),
        spect_dim=int(hp.Sound.Spectrogram_Dim) if use_linear else None,
        shuffle=False,
        seed=seed,
    )
    batches = []
    for _, batch in batcher:
        batches.append(batch)
        if len(batches) >= n_batches:
            break
    assert batches, f"no batches under {pattern_dir}"

    keys = ["mel_pre", "mel_post", "stop_logits", "alignments"]
    if use_linear:
        keys.append("linear")
    max_diff = {k: 0.0 for k in keys + ["speaker_embedding"]}
    m_t = {"mel_l1_pre": [], "mel_l1_post": [], "stop_accuracy": [], "diag": []}
    m_p = {k: [] for k in m_t}

    for batch in batches:
        tokens = torch.from_numpy(batch["tokens"]).long().to(dev)
        token_lengths = torch.from_numpy(batch["token_lengths"]).long().to(dev)
        mels = torch.from_numpy(batch["mels"]).to(dev)
        ref_mels = torch.from_numpy(batch["ref_mels"]).to(dev)
        with torch.no_grad():
            spk_t = ge2e_eval(ref_mels)
            out_t = taco_eval(tokens, token_lengths, mels, spk_t)
            spk_p = ge2e_p(ref_mels)
            out_p = taco_p(tokens, token_lengths, mels, spk_p)
        out_t = {k: out_t[k].float().cpu().numpy() for k in keys}
        out_p = {k: out_p[k].float().cpu().numpy() for k in keys}
        max_diff["speaker_embedding"] = max(
            max_diff["speaker_embedding"], float((spk_t - spk_p).abs().max()))
        for k in keys:
            max_diff[k] = max(max_diff[k], float(np.abs(out_t[k] - out_p[k]).max()))
        for out, m in ((out_t, m_t), (out_p, m_p)):
            m["mel_l1_pre"].append(_np_masked_l1(out["mel_pre"], batch["mels"],
                                                 batch["mel_lengths"]))
            m["mel_l1_post"].append(_np_masked_l1(out["mel_post"], batch["mels"],
                                                  batch["mel_lengths"]))
            m["stop_accuracy"].append(_np_stop_accuracy(out["stop_logits"],
                                                        batch["mel_lengths"], r))
            m["diag"].append(attention_diagonality(out["alignments"], batch["token_lengths"],
                                                   batch["mel_lengths"], r))

    report = {
        "n_batches": len(batches),
        "device": str(dev),
        "elementwise_max_abs_diff": {k: round(v, 8) for k, v in max_diff.items()},
        "torch": {k: round(float(np.mean(v)), 6) for k, v in m_t.items()},
        "port_converted": {k: round(float(np.mean(v)), 6) for k, v in m_p.items()},
    }
    report["metric_abs_delta"] = {
        k: round(abs(report["torch"][k] - report["port_converted"][k]), 8) for k in m_t
    }
    return report


def main(argv=None) -> dict:
    import argparse
    import json
    import pathlib
    import time

    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("-out", required=True)
    parser.add_argument("-steps", type=int, default=300)
    parser.add_argument("-ge2e_steps", type=int, default=300)
    parser.add_argument("-batches", type=int, default=8)
    parser.add_argument("-hp_from", default="demo/serving_ckpt.msgpack",
                        help="a compact checkpoint whose meta hp gives the widths")
    parser.add_argument("-report", default=None)
    parser.add_argument("-device", default=None, help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    t0 = time.perf_counter()

    def stage(msg):
        print(f"[torch_parity +{time.perf_counter() - t0:.0f}s] {msg}", flush=True)

    hp = Recursive_Parse(load_compact(args.hp_from)[2]["hp"]).replace(
        Decoder={"N_Frames_Per_Step": 1})
    out = pathlib.Path(args.out)
    corpus = out / "corpus"
    if not (corpus / "patterns").exists():
        stage("generating the corpus (6 speakers)")
        generate_synthetic_dataset(hp, corpus, n_speakers=6, n_utterances=20)
    from multi_speaker_tts_tpu_torch.inference import resolve_device

    dev = resolve_device(args.device)
    stage(f"training the torch reference (GE2E {args.ge2e_steps} + TTS {args.steps} steps, "
          f"{dev})")
    taco, ge2e = train_torch_reference(hp, str(corpus / "patterns"), tts_steps=args.steps,
                                       ge2e_steps=args.ge2e_steps, log=stage, device=dev)
    stage("converting and comparing on identical batches")
    report = compare_on_identical_batches(hp, taco, ge2e, str(corpus / "patterns"),
                                          n_batches=args.batches, device=dev)
    report.update(tts_steps=args.steps, ge2e_steps=args.ge2e_steps, width=args.hp_from)
    text = json.dumps(report, indent=2)
    (out / "report_torch_parity.json").write_text(text)
    if args.report:
        pathlib.Path(args.report).write_text(text)
    print("REPORT " + json.dumps(report))
    return report


if __name__ == "__main__":
    main()
