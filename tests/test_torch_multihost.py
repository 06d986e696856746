"""Data parallelism across hosts in the port, on the CPU.

- Four gloo processes of ``tests/torch_dp_worker.py`` presenting two hosts
  of two processes each (``LOCAL_RANK`` 0, 1 on each host,
  ``LOCAL_WORLD_SIZE`` 2, global ranks 0-3): one Tacotron step on each
  process's rows of the global batch of 8 equals the single-process step
  on the whole batch within the data-parallel tests' tolerances (losses
  rtol 2e-4, gradients 1e-5 of the largest, params atol 5e-4); the shards
  and rows stay global; the ranks hold bit-equal params after the step.
- The card of a process comes from its rank on its host: a world of 16 over
  two hosts of 8 cards passes the card check (it raised when the world was
  checked against one host's cards); more processes on a host than its
  cards still raise under NCCL; without a local rank the run is one host.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from multi_speaker_tts_tpu_torch.parallel import multihost
from multi_speaker_tts_tpu_torch.train import __main__ as cli
from multi_speaker_tts_tpu_torch.train.trainer import Trainer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
HOSTS, PER_HOST = 2, 2
WORLD = HOSTS * PER_HOST
JOIN_TIMEOUT = 120


@pytest.fixture(scope="module")
def two_hosts(tmp_path_factory):
    """The four processes, each with its host's LOCAL_RANK and
    LOCAL_WORLD_SIZE, and the single-process reference on the whole
    batch."""
    work = tmp_path_factory.mktemp("hosts")
    init = f"file://{work}/rendezvous"
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
                   LOCAL_RANK=str(rank % PER_HOST), LOCAL_WORLD_SIZE=str(PER_HOST))
        err = open(work / f"rank{rank}.err", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "tests/torch_dp_worker.py", init, str(rank), str(WORLD), str(work),
             "one_step"], cwd=ROOT, env=env, stdout=subprocess.DEVNULL, stderr=err), err))
    try:
        rcs = [p.wait(timeout=JOIN_TIMEOUT) for p, _ in procs]
    finally:
        for p, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            err.close()
    for rank, rc in enumerate(rcs):
        assert rc == 0, (rank, (work / f"rank{rank}.err").read_text()[-3000:])
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    hp = worker.tacotron_hp()
    trainer = Trainer(hp, work / "ref_ck", work / "ref_log", device="cpu")
    trainer.initialize()
    ref = worker.run_tacotron(trainer, worker.tacotron_batch(hp), steps=1)
    return {"ranks": ranks, "ref": ref}


def test_two_hosts_join_as_one_group_of_four(two_hosts):
    """Global ranks 0-3, each its host's rank (0, 1) of two; shards and
    rows by the global rank; process 0 of the world alone checkpoints and
    logs (rank 2 is its host's rank 0 too)."""
    ranks = two_hosts["ranks"]
    assert [r["is_main"] for r in ranks] == [True, False, False, False]
    assert [r["rank"] for r in ranks] == list(range(WORLD))
    assert all(r["world"] == WORLD for r in ranks)
    assert [r["local"] for r in ranks] == [(i % PER_HOST, PER_HOST) for i in range(WORLD)]
    assert [r["shard"] for r in ranks] == [(i, WORLD) for i in range(WORLD)]
    assert [r["rows"] for r in ranks] == [(2 * i, 2 * i + 2) for i in range(WORLD)]


def test_two_hosts_step_matches_single_process(two_hosts):
    """The first step's losses, summed gradients, gradient norm and params
    against the single-process step on the global batch."""
    got, ref = two_hosts["ranks"][0]["tacotron"], two_hosts["ref"]
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=2e-4, err_msg=k)
    scale = max(np.abs(g).max() for g in ref["grads"].values())
    for k, g in ref["grads"].items():
        assert np.abs(got["grads"][k] - g).max() <= 1e-5 * scale, k
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], ref["metrics"][0]["grad_norm"],
                               rtol=1e-5)
    for k, v in ref["params_1"].items():
        np.testing.assert_allclose(got["params_1"][k], v, atol=5e-4, err_msg=k)


def test_two_hosts_ranks_bit_equal_after_the_step(two_hosts):
    first = two_hosts["ranks"][0]["tacotron"]["params_1"]
    for r in two_hosts["ranks"][1:]:
        assert all(np.array_equal(first[k], r["tacotron"]["params_1"][k]) for k in first)


@pytest.fixture
def eight_cards(monkeypatch):
    """A pretended host of 8 cards, no launcher variables."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    for name in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


@pytest.mark.parametrize("process_id", [0, 5, 8, 15])
def test_sixteen_processes_over_two_hosts_of_eight_cards(eight_cards, process_id):
    """Global rank g on host g // 8 takes card g % 8: by the arguments and
    by the launcher's variables alike."""
    assert multihost.local_card(process_id, 16, "nccl", process_id % 8, 8) == process_id % 8
    eight_cards.setenv("LOCAL_RANK", str(process_id % 8))
    eight_cards.setenv("LOCAL_WORLD_SIZE", "8")
    assert multihost.local_placement(process_id, 16) == (process_id % 8, 8)
    assert multihost.local_card(process_id, 16, "nccl") == process_id % 8


def test_the_card_check_is_this_hosts(eight_cards):
    """Without a local rank the world is one host's (16 processes on 8
    cards raise, as before); with one, more processes on this host than
    its cards raise under NCCL and share the cards under gloo; a local rank
    past the host's process count raises."""
    with pytest.raises(ValueError, match="one card a process"):
        multihost.local_card(9, 16, "nccl")
    assert multihost.local_placement(3, 4) == (3, 4)
    with pytest.raises(ValueError, match="12 processes on this host over 8"):
        multihost.local_card(3, 24, "nccl", 3, 12)
    assert multihost.local_card(11, 24, "gloo", 11, 12) == 3
    with pytest.raises(ValueError, match="does not fit"):
        multihost.local_placement(3, 16, 8, 8)
    assert multihost.local_placement(3, 16, 3) == (3, 4)


def test_train_cli_passes_the_local_rank(monkeypatch):
    """``-local_rank`` / ``-local_processes`` reach initialize_distributed."""
    seen = {}

    class _Stop(Exception):
        pass

    def fake_init(*args, **kwargs):
        seen.update(args=args, kwargs=kwargs)
        raise _Stop

    monkeypatch.setattr(multihost, "initialize_distributed", fake_init)
    with pytest.raises(_Stop):
        cli.main(["-mode", "ge2e", "-distributed", "-coordinator", "host0:1234",
                  "-num_processes", "16", "-process_id", "9", "-local_rank", "1",
                  "-local_processes", "8"])
    assert seen["args"] == ("host0:1234", 16, 9)
    assert seen["kwargs"]["local_rank"] == 1 and seen["kwargs"]["local_processes"] == 8
