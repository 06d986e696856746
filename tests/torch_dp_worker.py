"""One process of the port's data-parallel CPU tests (gloo), started by
``tests/test_torch_parallel.py``; not a test module itself.

    python tests/torch_dp_worker.py INIT_URL RANK WORLD OUT_DIR [one_step]

Joins the process group, then on this rank's rows of seeded global
batches: the Tacotron trainer's gradients and three steps, and the GE2E
trainer's gradients and one step (``one_step``: the Tacotron trainer's
gradients and one step only). Writes what it saw, with its rank on its
host (``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` where the caller presents
several hosts), to ``OUT_DIR/rank<RANK>.pt``. The same functions build the
single-process references in the tests (``tests/test_torch_parallel.py``,
``tests/test_torch_multihost.py``).
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.data.collate import collate_tts
from multi_speaker_tts_tpu_torch.hparams import tiny_test_hparams
from multi_speaker_tts_tpu_torch.parallel import multihost
from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer
from multi_speaker_tts_tpu_torch.train.trainer import Trainer

GLOBAL_BATCH = 8
GE2E_N, GE2E_M, GE2E_L = 4, 2, 24


def tacotron_hp():
    """The tiny hparams with the CBHG head, the GE2E encoder trainable and
    every dropout on (conv 0.5, prenet 0.5)."""
    return tiny_test_hparams().replace(Train={"Batch_Size": GLOBAL_BATCH},
                                       Linear_Head={"Type": "CBHG"})


def ge2e_hp():
    return tiny_test_hparams().replace(GE2E_Train={
        "Batch_Speakers": GE2E_N, "Batch_Utterances": GE2E_M, "Frame_Length": GE2E_L,
        "Learning_Rate": 0.01, "Scale_Gradient": 0.01})


def tacotron_batch(hp, seed: int = 0) -> dict:
    """A seeded global batch of 8 rows of unequal lengths."""
    rng = np.random.default_rng(seed)
    M, F, S, T = hp.Sound.Mel_Dim, hp.Sound.Spectrogram_Dim, 16, 40
    pats = [{"Tokens": rng.integers(1, 30, size=S - i).astype(np.int32),
             "Mel": rng.random((T - 3 * i + 1, M)).astype(np.float32),
             "Spect": rng.random((T - 3 * i + 1, F)).astype(np.float32),
             "Speaker_ID": i % 3} for i in range(GLOBAL_BATCH)]
    return collate_tts(pats, S, T, M, 1, hp.Speaker_Embedding.GE2E.Window_Length,
                       np.random.default_rng(seed + 1), F)


def ge2e_mels(hp, seed: int = 1) -> np.ndarray:
    """(N M, L, mel) crops grouped by speaker: N speaker means plus noise."""
    rng = np.random.default_rng(seed)
    D = hp.Sound.Mel_Dim
    base = rng.normal(size=(GE2E_N, 1, 1, D)) * 2.0
    mels = base + 0.3 * rng.normal(size=(GE2E_N, GE2E_M, GE2E_L, D))
    return mels.reshape(GE2E_N * GE2E_M, GE2E_L, D).astype(np.float32)


def run_tacotron(trainer: Trainer, batch: dict, steps: int = 3) -> dict:
    """gradients() then ``steps`` train_step()s on ``batch`` (this
    process's rows): losses, gradients, metrics, the params after step 1
    and after the last, the BatchNorm statistics after the last."""
    losses, grads = trainer.gradients(batch)
    metrics = [trainer.train_step(batch)]
    params_1 = trainer.state()
    metrics += [trainer.train_step(batch) for _ in range(steps - 1)]
    return {"losses": losses, "grads": grads, "metrics": metrics, "params_1": params_1,
            "params_3": trainer.state(), "bn_3": [b.clone() for b in trainer.bn_stats()]}


def run_ge2e(trainer: GE2ETrainer, mels: np.ndarray) -> dict:
    loss, grads = trainer.gradients(mels)
    metrics = trainer.train_step(mels)
    return {"loss": float(loss), "grads": {k: g.detach().clone() for k, g in grads.items()},
            "metrics": metrics,
            "params": {k: p.detach().clone() for k, p in trainer.params.items()}}


def main(init: str, rank: int, world: int, out_dir: str, one_step: bool = False) -> None:
    torch.set_num_threads(1)
    multihost.initialize_distributed(init, world, rank, device="cpu")
    hp = tacotron_hp()
    trainer = Trainer(hp, f"{out_dir}/ck{rank}", f"{out_dir}/log{rank}", device="cpu")
    trainer.initialize()
    rows = multihost.local_rows(GLOBAL_BATCH)
    local = {k: v[rows] for k, v in tacotron_batch(hp).items()}
    result = {"rank": rank, "world": multihost.process_count(), "local": multihost.local_rank(),
              "shard": multihost.host_shard_info(), "rows": (rows.start, rows.stop),
              "is_main": trainer.is_main,
              "tacotron": run_tacotron(trainer, local, 1 if one_step else 3)}
    if one_step:
        torch.save(result, f"{out_dir}/rank{rank}.pt")
        multihost.shutdown()
        return
    hp_g = ge2e_hp()
    ge2e = GE2ETrainer(hp_g, f"{out_dir}/ge2e{rank}", f"{out_dir}/glog{rank}", device="cpu")
    result["ge2e"] = run_ge2e(ge2e, ge2e_mels(hp_g)[multihost.local_rows(GE2E_N * GE2E_M)])
    torch.save(result, f"{out_dir}/rank{rank}.pt")
    multihost.shutdown()


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5:] == ["one_step"])
