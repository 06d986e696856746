"""Driver of a GE2E training cell: a closed loop of ``GE2ETrainer.train_step``
on batches of N speakers x M utterances of mel crops (``harness/ge2e.py``:
seeded voices made on the device at set-up, a pool of distinct batches
reused in turn), each step done when its loss is on the host.

Set-up builds one trainer, loads the benchmark's weights into it, and drives
it from the seed through its first three steps, on three distinct batches,
through the window's own call: the window then goes on with that same
trainer. The check follows those three steps with the plain float32
reference (its own LSTM, GE2E loss and optimizer: clipping to a global norm
of 3, the similarity's scale and bias at 0.01 of the rate, SGD with momentum
0.9) from the same weights on the same batches, and compares each step's
loss, the first gradient as the optimizer received it (the program's
momentum trace after one step), and the parameters' change after three
steps, leaf by leaf: the gap between the program's norm and the
reference's, over the larger of the reference's norm of that leaf and of
the median leaf. Leaves whose first reference gradient is under a
thousandth of the median leaf's move by round-off alone and are left out of
the change.
"""

from __future__ import annotations

import gc

import torch

from benchmark.harness import ge2e
from benchmark.harness.cell import ROOT, Compared
from benchmark.reference import models as R
from benchmark.reference.lowp import Arith, no_tf32

CHECK_STEPS = 3
CLIP_NORM, MOMENTUM = 3.0, 0.9  # GE2E section 3; the configuration's optimizer


def setup(ctx) -> dict:
    from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer

    hp, over = ge2e.hparams(ctx)
    d = ge2e.dims(hp)
    g = hp.GE2E_Train
    logs = ROOT / ".bench_cache" / "ge2e_train"
    trainer = GE2ETrainer(hp, checkpoint_dir=str(logs / "ckpt"), log_dir=str(logs / "log"),
                          device=ctx.device)
    tree = ge2e.weights(ctx.seed, d, ctx.device)
    ge2e.load(trainer.model, tree, d)
    p = ctx.params
    pool = [ge2e.crop_batch(ctx.seed, i, g.Batch_Speakers, g.Batch_Utterances, g.Frame_Length,
                            over["Sound"], ctx.device) for i in range(p["pool_batches"])]
    init = {k: v.detach().clone() for k, v in trainer.params.items()}
    losses = []
    for i in range(CHECK_STEPS):
        losses.append(trainer.train_step(pool[i])["loss"])
        if i == 0:
            first_grad = {k: v.clone() for k, v in trainer.opt_state.items()}
    after = {k: v.detach().clone() for k, v in trainer.params.items()}
    return {"trainer": trainer, "pool": pool, "hp": hp, "over": over, "dims": d, "tree": tree,
            "init": init, "losses": losses, "first_grad": first_grad, "after": after,
            "rows_frames": g.Batch_Speakers * g.Batch_Utterances * g.Frame_Length}


def step(state, i: int) -> dict:
    pool = state["pool"]
    loss = state["trainer"].train_step(pool[(CHECK_STEPS + i) % len(pool)])["loss"]
    return {"requests": 1, "loss": loss}


def end_to_end(state, records, window_s) -> dict:
    return {"train_frame_rate": len(records) * state["rows_frames"] / window_s}


def work(state, records) -> dict:
    g = state["hp"].GE2E_Train
    return {"dims": state["dims"], "rows": g.Batch_Speakers * g.Batch_Utterances,
            "T": g.Frame_Length, "steps": len(records), "kind": "train"}


def reference_steps(state, ar: Arith, half_batch: bool = False):
    """The reference's first steps from the benchmark's weights -> (losses,
    the first gradient as the optimizer gets it, the change after the
    steps), by the program's parameter names."""
    d, hp = state["dims"], state["hp"]
    N, M = hp.GE2E_Train.Batch_Speakers, hp.GE2E_Train.Batch_Utterances
    names = {f"encoder.{k}": v for k, v in ge2e.module_names(d).items()}
    params = {k: state["init"][k].clone().requires_grad_() for k in state["init"]}
    trace = {k: torch.zeros_like(v) for k, v in params.items()}
    lr, scale = hp.GE2E_Train.Learning_Rate, hp.GE2E_Train.get("Scale_Gradient", 0.01)
    losses, first = [], None
    for i in range(CHECK_STEPS):
        G = {}
        for name, (layer, leaf) in names.items():
            G.setdefault(layer, {})[leaf] = params[name]
        n = N // 2 if half_batch else N
        emb = R.ge2e_embed(G, state["pool"][i][:n * M], ar).reshape(n, M, -1)
        loss = R.ge2e_loss(emb, params["w"], params["b"])
        grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
        with torch.no_grad():
            norm = torch.sqrt(sum((gr.float() ** 2).sum() for gr in grads.values()))
            if not bool(norm < CLIP_NORM):
                grads = {k: gr / norm * CLIP_NORM for k, gr in grads.items()}
            grads["w"], grads["b"] = grads["w"] * scale, grads["b"] * scale
            trace = {k: grads[k] + MOMENTUM * trace[k] for k in grads}
            for k, p in params.items():
                p.sub_(lr * trace[k])
            params["w"].clamp_(min=1e-6)
        losses.append(float(loss.detach()))
        if i == 0:
            first = {k: v.clone() for k, v in trace.items()}
    change = {k: (params[k] - state["init"][k]).detach() for k in params}
    return losses, first, change


def leaf_gap(prog: dict, ref: dict, keys) -> float:
    """Worst leaf: | |prog| - |ref| | over max(|ref|, the median leaf's)."""
    pn = {k: float(torch.linalg.vector_norm(prog[k].float())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].float())) for k in keys}
    med = float(torch.tensor(sorted(rn.values())).median())
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys)


def numbers(losses, first, change, prog_losses, prog_first, prog_change) -> dict:
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in first.items()}
    med = float(torch.tensor(sorted(norms.values())).median())
    moving = [k for k in first if norms[k] >= 1e-3 * med]
    return {"loss_gap": max(abs(a - b) / max(abs(b), 1e-30)
                            for a, b in zip(prog_losses, losses)),
            "grad_gap": leaf_gap(prog_first, first, list(first)),
            "update_gap": leaf_gap(prog_change, change, moving)}


def check(state, records, ctx) -> list[Compared]:
    trainer = state.pop("trainer")
    device = trainer.device
    del trainer
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    no_tf32()
    prog_change = {k: state["after"][k] - state["init"][k] for k in state["init"]}
    prog = (state["losses"], state["first_grad"], prog_change)
    ref = reference_steps(state, Arith(False))
    got = numbers(*ref, *prog)
    lim = ctx.limits
    out = [Compared(k, got[k], lim[k]) for k in ("loss_gap", "grad_gap", "update_gap")]
    if ctx.control:
        for tag, kwargs in (("control", {"ar": Arith(True)}),
                            ("half_batch", {"ar": Arith(False), "half_batch": True})):
            planted = reference_steps(state, **kwargs)
            got = numbers(*ref, *planted)
            out += [Compared(f"{k}.{tag}", got[k], lim[k])
                    for k in ("loss_gap", "grad_gap", "update_gap")]
    return out
