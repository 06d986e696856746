"""Data parallelism and sharded synthesis in the port, on the CPU.

- Four gloo processes (``tests/torch_dp_worker.py``, one process group for
  the module, rendezvous through a file in ``tmp_path``) against the
  single-process step on the same global batch of 8, every dropout on:
  the Tacotron trainer (CBHG head, GE2E trainable) to the JAX multichip
  test's tolerances (losses rtol 2e-4, params atol 5e-4) and its summed
  gradients to 1e-5 of the largest gradient, so that a gradient W times
  too large fails; the GE2E trainer (loss rtol 2e-5, params atol 1e-5) and
  its gradients within 1e-5 (the 1/W scaling of the gathered loss); the
  ranks bit-equal after three steps.
- The training CLI with ``-distributed`` in two processes, both modes:
  equal final losses on both ranks, within rtol 1e-4 / atol 1e-5 of the
  single-process run; only process 0 writes checkpoints; a resume starts
  at the saved step.
- Refusals: ``n_devices`` other than the process count, a batch that does
  not split over the processes, NCCL on fewer cards than processes.
- ``synthesize(sharded=True)`` on a mesh of four CPU devices against the
  unsharded call (rows that stop at different steps, the CBHG head on);
  ``pad_batch=False`` and ``return_device=True`` against the JAX
  ``Synthesizer`` on the small checkpoint at f32.
"""

import json
import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dp_worker as worker
from multi_speaker_tts_tpu.hparams import Recursive_Parse as JaxRecursiveParse
from multi_speaker_tts_tpu.inference import Synthesizer as JaxSynthesizer
from multi_speaker_tts_tpu_torch import weights
from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse, tiny_test_hparams
from multi_speaker_tts_tpu_torch.inference import Synthesizer
from multi_speaker_tts_tpu_torch.models.ge2e import GE2E
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
from multi_speaker_tts_tpu_torch.parallel import mesh as mesh_lib
from multi_speaker_tts_tpu_torch.parallel import multihost
from multi_speaker_tts_tpu_torch.train import __main__ as cli
from multi_speaker_tts_tpu_torch.train.checkpoints import CheckpointManager
from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer
from multi_speaker_tts_tpu_torch.train.trainer import Trainer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = ROOT / "demo" / "serving_ckpt.msgpack"
WORLD = 4
JOIN_TIMEOUT = 300


def _launch(argvs: list[list[str]], work: pathlib.Path, tag: str) -> list[str]:
    """Start one process per argv (one thread each, the repo importable),
    join them with a timeout and return their stdout; any exit code other
    than 0 fails with that process's stderr."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for i, argv in enumerate(argvs):
        out, err = work / f"{tag}{i}.out", work / f"{tag}{i}.err"
        logs.append((out, err))
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append(subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                          stdout=fo, stderr=fe))
    try:
        rcs = [p.wait(timeout=JOIN_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, (out, err) in zip(rcs, logs):
        assert rc == 0, f"{out.name}: exit {rc}\n{err.read_text()[-3000:]}"
    return [out.read_text() for out, _ in logs]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Four gloo processes, each on its rows; the single-process references
    on the whole batch."""
    work = tmp_path_factory.mktemp("dp")
    init = f"file://{work}/rendezvous"
    _launch([["tests/torch_dp_worker.py", init, str(r), str(WORLD), str(work)]
             for r in range(WORLD)], work, "rank")
    ranks = [torch.load(work / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    hp = worker.tacotron_hp()
    trainer = Trainer(hp, work / "ref_ck", work / "ref_log", device="cpu")
    trainer.initialize()
    ref = worker.run_tacotron(trainer, worker.tacotron_batch(hp))
    hp_g = worker.ge2e_hp()
    ge2e = GE2ETrainer(hp_g, work / "ref_g", work / "ref_glog", device="cpu")
    ref_g = worker.run_ge2e(ge2e, worker.ge2e_mels(hp_g))
    return {"ranks": ranks, "ref": ref, "ref_g": ref_g}


def test_workers_ran_as_one_group_of_four(dp):
    assert [r["rank"] for r in dp["ranks"]] == list(range(WORLD))
    assert all(r["world"] == WORLD for r in dp["ranks"])


def test_dp_tacotron_step_matches_single_process(dp):
    """Losses and the params after one step (dropout on, conv and prenet)."""
    got, ref = dp["ranks"][0]["tacotron"], dp["ref"]
    assert set(got["losses"]) == set(ref["losses"]) >= {"linear", "guided_attention"}
    for k, v in ref["losses"].items():
        np.testing.assert_allclose(got["losses"][k], v, rtol=2e-4, err_msg=k)
    np.testing.assert_allclose(got["metrics"][0]["total"], ref["metrics"][0]["total"], rtol=2e-4)
    for k, v in ref["params_1"].items():
        np.testing.assert_allclose(got["params_1"][k], v, atol=5e-4, err_msg=k)


def test_dp_tacotron_gradients_are_the_global_batchs(dp):
    """The summed gradients equal the single process's to 1e-5 of the
    largest gradient (a sum W times too large, or a share left unsummed,
    is off by far more); so does the gradient norm."""
    got, ref = dp["ranks"][0]["tacotron"], dp["ref"]
    scale = max(np.abs(g).max() for g in ref["grads"].values())
    moved = 0
    for k, g in ref["grads"].items():
        err = np.abs(got["grads"][k] - g).max()
        assert err <= 1e-5 * scale, (k, err, scale)
        moved += np.abs(g).max() > 1e-3 * scale
    assert moved >= len(ref["grads"]) // 2  # the check has gradients to bite on
    np.testing.assert_allclose(got["metrics"][0]["grad_norm"], ref["metrics"][0]["grad_norm"],
                               rtol=1e-5)


def test_dp_tacotron_further_steps_finite_and_ranks_bit_equal(dp):
    """Steps 2 and 3: finite, and every rank holds the same params and
    BatchNorm statistics, bit for bit, and reports the same metrics."""
    first = dp["ranks"][0]["tacotron"]
    for m in first["metrics"]:
        assert all(np.isfinite(v) for v in m.values()) and not m["skipped_nonfinite"]
    for k, v in dp["ref"]["params_3"].items():
        np.testing.assert_allclose(first["params_3"][k], v, atol=5e-4, err_msg=k)
    for other in dp["ranks"][1:]:
        o = other["tacotron"]
        assert o["metrics"] == first["metrics"]
        for k, v in first["params_3"].items():
            np.testing.assert_array_equal(o["params_3"][k], v, err_msg=k)
        assert all(torch.equal(a, b) for a, b in zip(o["bn_3"], first["bn_3"]))


def test_dp_ge2e_step_matches_single_process(dp):
    got, ref = dp["ranks"][0]["ge2e"], dp["ref_g"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=2e-5)
    np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=2e-5)
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)
    for other in dp["ranks"][1:]:
        for k, v in got["params"].items():
            assert torch.equal(other["ge2e"]["params"][k], v), k


def test_ge2e_gathered_loss_is_scaled_by_one_over_w(dp):
    """Every process computes the global GE2E loss on the gathered
    embeddings; each scales it by 1/W, so the summed gradients are the
    single process's within 1e-5, a check that a factor W would fail on
    every tensor listed below."""
    got, ref = dp["ranks"][0]["ge2e"]["grads"], dp["ref_g"]["grads"]
    assert got.keys() == ref.keys()
    for k, g in ref.items():
        assert float((got[k] - g).abs().max()) <= 1e-5, k
    big = [k for k, g in ref.items() if (WORLD - 1) * float(g.abs().max()) > 1e-5]
    # (b's gradient vanishes: b shifts every logit of a row alike)
    assert {"w", "encoder.projection.kernel", "encoder.lstm.0.w_ih"} <= set(big)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("dpcorpus")
    generate_synthetic_dataset(tiny_test_hparams(), root, n_speakers=3, n_utterances=2)
    return root / "patterns"


def _cli_hp():
    return tiny_test_hparams().replace(
        Train={"Checkpoint_Save_Interval": 2, "Logging_Interval": 1,
               "Batch_Bucketing": {"Token_Buckets": [50], "Mel_Buckets": [320]}},
        GE2E_Train={"Batch_Speakers": 3, "Batch_Utterances": 2, "Frame_Length": 24})


def _losses(stdout: str) -> dict[int, float]:
    return {int(s): float(v) for s, v in re.findall(r"^step (\d+): loss (\S+)", stdout, re.M)}


def test_cli_trains_data_parallel_in_two_processes(corpus, tmp_path, capsys):
    """``-distributed -num_processes 2`` in both modes, then a resume,
    against the same runs in one process (``main(argv)``): both ranks print
    the same losses, within rtol 1e-4 / atol 1e-5 of the single process's;
    the checkpoints agree. Process 1 is given its own checkpoint and log
    paths, which it must never create."""
    hp_file = tmp_path / "hp.json"
    hp_file.write_text(json.dumps(_cli_hp().to_dict()))
    common = ["-hp", str(hp_file), "-train_pattern", str(corpus), "-device", "cpu"]

    def distributed(tag, mode, steps):
        init = f"file://{tmp_path}/{tag}_rendezvous"
        return _launch([["-m", "multi_speaker_tts_tpu_torch.train", *common, "-mode", mode,
                         "-checkpoint", str(tmp_path / f"{mode}_ck{r}"),
                         "-log", str(tmp_path / f"{mode}_log{r}"), "-max_step", str(steps),
                         "-distributed", "-coordinator", init, "-num_processes", "2",
                         "-process_id", str(r)] for r in range(2)], tmp_path, tag)

    def single(mode, steps):
        capsys.readouterr()
        cli.main(common + ["-mode", mode, "-checkpoint", str(tmp_path / f"{mode}_single"),
                           "-log", str(tmp_path / f"{mode}_single_log"), "-max_step", str(steps)])
        return capsys.readouterr().out

    def same_params(a, b, atol):
        got, _ = CheckpointManager(tmp_path / a).restore()
        want, _ = CheckpointManager(tmp_path / b).restore()
        assert got["step"] == want["step"]
        flat = lambda s: s["params"] if "encoder" not in s["params"] else s["params"]["encoder"]  # noqa: E731
        for k, v in flat(want).items():
            np.testing.assert_allclose(flat(got)[k].numpy(), v.numpy(), atol=atol, err_msg=k)

    distributed("ge2e", "ge2e", 2)
    single("ge2e", 2)
    same_params("ge2e_ck0", "ge2e_single", 1e-5)

    runs = [(distributed("tts", "tts", 2), single("tts", 2))]
    assert CheckpointManager(tmp_path / "tts_ck0").steps() == [2]
    same_params("tts_ck0", "tts_single", 5e-4)
    runs.append((distributed("resume", "tts", 3), single("tts", 3)))
    assert "resumed from checkpoint step 2" in runs[1][0][0]
    assert CheckpointManager(tmp_path / "tts_ck0").steps() == [2, 3]
    same_params("tts_ck0", "tts_single", 5e-4)
    assert not any((tmp_path / f"{m}_{k}1").exists() for m in ("ge2e", "tts") for k in ("ck", "log"))
    for (outs, one), steps in zip(runs, ([1, 2], [3])):
        assert "distributed: process 0/2 on cpu" in outs[0]
        l0, l1, ref = _losses(outs[0]), _losses(outs[1]), _losses(one)
        assert sorted(l0) == sorted(l1) == sorted(ref) == steps  # the resume starts at step 3
        for s, v in ref.items():
            np.testing.assert_allclose(l1[s], l0[s], rtol=1e-6)
            np.testing.assert_allclose(l0[s], v, rtol=1e-4, atol=1e-5)


def test_refusals(monkeypatch, tmp_path):
    hp = tiny_test_hparams().replace(Train={"Batch_Size": 8})
    with pytest.raises(ValueError, match="one process per card"):
        Trainer(hp, device="cpu", n_devices=2)
    with pytest.raises(ValueError, match="one process per card"):
        GE2ETrainer(hp, tmp_path / "g", tmp_path / "l", device="cpu", n_devices=2)
    assert Trainer(hp, device="cpu", n_devices=1).process_count == 1
    # A world of three processes: 8 rows do not split over it.
    monkeypatch.setattr(multihost, "process_count", lambda: 3)
    with pytest.raises(ValueError, match="divisible by the process count"):
        Trainer(hp, device="cpu")
    with pytest.raises(ValueError, match="do not split"):
        multihost.local_rows(8)
    monkeypatch.undo()
    # NCCL takes one card a process; gloo shares; no process group alone.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one card a process"):
        multihost.initialize_distributed("127.0.0.1:1", 2, 0, device="cuda")
    assert multihost.initialize_distributed(None, 1, 0, device="cpu") == torch.device("cpu")
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize_distributed("127.0.0.1:1", 2, 0, device="cuda")


def test_mesh_helpers():
    mesh = mesh_lib.create_mesh(devices=["cpu"] * 4)
    assert mesh == [torch.device("cpu")] * 4
    assert mesh_lib.create_mesh(2, devices=mesh) == mesh[:2]
    x = torch.arange(8).reshape(8, 1)
    assert [mesh_lib.shard_rows(x, 4, i)[:, 0].tolist() for i in range(4)] == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    with pytest.raises(ValueError):
        mesh_lib.shard_rows(x, 3, 0)
    m = torch.nn.Linear(2, 2)
    assert mesh_lib.replicate(m, mesh) == {torch.device("cpu"): m}


def _cbhg_small():
    """The small checkpoint's trained encoder, decoder and postnet with a
    seeded random CBHG head in place of its Conv head (the CBHG head reads
    the whole decode bucket), in f32: a row's decode then moves by
    summation order alone (~1e-6) with the rows beside it, where bf16
    roundings that flip carry it to ~1e-3 within 90 AR steps."""
    params, batch_stats, meta = load_compact(SMALL)
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Type": "CBHG"},
                                             Train={"Use_Mixed_Precision": False})
    trained = weights.params_from_jax(params, batch_stats,
                                      hp.replace(Linear_Head={"Use": False}))
    taco, ge2e = Tacotron(hp), GE2E.from_hp(hp, torch.float32)
    weights.random_init(hp, torch.Generator().manual_seed(0), ge2e=ge2e, tacotron=taco)
    state = weights.module_state(ge2e=ge2e, tacotron=taco)
    state.update(trained)
    return hp, *weights.params_to_jax(state, hp)


TEXTS = ["hello world.", "the quick brown fox jumps over the lazy dog.", "a b c",
         "synthesis in shards.", "one", "a much longer sentence, to stop later than the rest."]


def test_sharded_synthesis_matches_unsharded():
    hp, params, batch_stats = _cbhg_small()
    mesh = mesh_lib.create_mesh(devices=["cpu"] * 4)
    synth = Synthesizer(hp, params, batch_stats, device="cpu", mesh=mesh)
    assert synth.mesh == mesh and synth.device == torch.device("cpu")
    emb = synth.enroll(str(ROOT / "demo" / "enroll_spk0_utt0.wav"))
    whole = synth.synthesize(TEXTS, emb, pcm16=True)
    sharded = synth.synthesize(TEXTS, emb, sharded=True, pcm16=True)
    lengths = [x["mel_length"] for x in whole]
    assert len(set(lengths)) >= 3, lengths  # rows stop at different steps
    for a, b in zip(whole, sharded):
        assert a["mel_length"] == b["mel_length"]
        assert np.abs(a["mel"] - b["mel"]).max() <= 1e-4
        assert a["linear"].shape[-1] == hp.Sound.Spectrogram_Dim
        assert np.abs(a["linear"] - b["linear"]).max() <= 1e-4
        assert a["wav"].dtype == b["wav"].dtype == np.int16 and a["wav"].shape == b["wav"].shape
    # Eight rows (6 texts padded to 8) in shards of two; the program keys
    # record the sharded call as the JAX package's do.
    assert any(k[0] == "infer" and k[2] == 8 and k[5] for k in synth.compile_counts)
    # The exact batch over the mesh, and a batch that does not split.
    exact = synth.synthesize(TEXTS[:4], emb, vocode=False, sharded=True, pad_batch=False)
    for a, b in zip(exact, synth.synthesize(TEXTS[:4], emb, vocode=False, pad_batch=False)):
        assert a["mel_length"] == b["mel_length"] and np.abs(a["mel"] - b["mel"]).max() <= 1e-4
    with pytest.raises(ValueError, match="do not split"):
        synth.synthesize(TEXTS[:3], emb, vocode=False, sharded=True, pad_batch=False)


def test_exact_batch_and_device_output_match_jax():
    """``pad_batch=False`` (no pow2 rounding) and ``return_device=True``
    (the untrimmed dict) against the JAX Synthesizer's same call on the
    small checkpoint, f32, prenet dropout 0: equal lengths, mel within
    1e-4."""
    params, batch_stats, meta = load_compact(SMALL)
    over = dict(Train={"Use_Mixed_Precision": False}, Decoder={"Prenet": {"Dropout_Rate": 0.0}})
    jax_synth = JaxSynthesizer(JaxRecursiveParse(meta["hp"]).replace(**over), params, batch_stats)
    port = Synthesizer(Recursive_Parse(meta["hp"]).replace(**over), params, batch_stats,
                       device="cpu")
    emb = port.enroll(str(ROOT / "demo" / "enroll_spk0_utt0.wav"))
    texts = TEXTS[:3]
    got = port.synthesize(texts, emb, max_steps=96, pad_batch=False, return_device=True)
    want = jax_synth.synthesize(texts, emb, max_steps=96, pad_batch=False, return_device=True)
    assert set(got) == set(want) == {"mel_post", "alignments", "mel_lengths", "linear"}
    for k in got:
        assert tuple(got[k].shape) == tuple(np.asarray(want[k]).shape), k
    assert got["mel_post"].shape[0] == 3  # no pow2 rounding
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), np.asarray(want["mel_lengths"]))
    for i, T in enumerate(got["mel_lengths"].tolist()):
        assert np.abs(got["mel_post"][i, :T].numpy() - np.asarray(want["mel_post"])[i, :T]).max() \
            <= 1e-4
    rows = port.synthesize(texts, emb, max_steps=96, pad_batch=False, vocode=False)
    assert [r["mel_length"] for r in rows] == got["mel_lengths"].tolist()
