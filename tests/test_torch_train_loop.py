"""The port's training loop, checkpoints and CLI, on the CPU at tiny size.

- ``default_hparams()`` / ``tiny_test_hparams()`` equal the JAX package's
  (the YAML, loaded by pyyaml);
- a fresh init has the JAX init's parameter names and shapes and draws
  each from its family (constants equal; uniform bounds; normal spreads);
- LUT training: one ``train_step`` against the JAX ``make_train_step`` from
  the same weights (f32, dropout 0: losses 1e-4 relative, params 1e-5);
- ``Trainer.train`` on a synthetic corpus: finite losses, checkpoints at
  the interval; save, restore and resume (params, optimizer state, step and
  generator bit-equal); ``Synthesizer.from_checkpoint`` / ``from_state`` on
  the saved directory;
- ``export_compact`` both ways: the port's file read by the JAX
  ``load_compact`` (and byte-equal to the JAX writer's), the JAX file read
  by the port;
- ``python -m multi_speaker_tts_tpu_torch.train`` through ``main(argv)``
  with ``-device cpu`` in both modes, and ``-distributed`` without a
  process count (one process).
"""

import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.hparams import default_hparams as jax_default_hparams
from multi_speaker_tts_tpu.hparams import tiny_test_hparams as jax_tiny
from multi_speaker_tts_tpu.train import checkpoints as jckpt
from multi_speaker_tts_tpu.train import trainer as jtrainer
from multi_speaker_tts_tpu_torch import weights
from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.data.collate import collate_tts
from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse, default_hparams, tiny_test_hparams
from multi_speaker_tts_tpu_torch.inference import Synthesizer
from multi_speaker_tts_tpu_torch.train import __main__ as cli
from multi_speaker_tts_tpu_torch.train.checkpoints import CheckpointManager, export_compact
from multi_speaker_tts_tpu_torch.train.trainer import Trainer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

LOSS_TOL, PARAM_TOL = 1e-4, 1e-5
NO_DROPOUT = dict(Decoder={"Prenet": {"Dropout_Rate": 0.0}}, Encoder={"Conv": {"Dropout_Rate": 0.0}},
                  Postnet={"Conv": {"Dropout_Rate": 0.0}},
                  Linear_Head={"Type": "CBHG", "Conv": {"Dropout_Rate": 0.0}})
LUT = {"Type": "LUT", "Num_Speakers": 4}


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def _batch(hp, seed=0, B=3, S=12, T=20):
    rng = np.random.default_rng(seed)
    M, F = hp.Sound.Mel_Dim, hp.Sound.Spectrogram_Dim
    pats = [{"Tokens": rng.integers(1, 30, size=S - 2 * i).astype(np.int32),
             "Mel": rng.random((T - 4 * i + 1, M)).astype(np.float32),
             "Spect": rng.random((T - 4 * i + 1, F)).astype(np.float32),
             "Speaker_ID": 3 - i} for i in range(B)]
    return collate_tts(pats, S, T, M, 1, None, np.random.default_rng(seed + 1), F)


def test_default_hparams_equal_the_jax_yaml():
    assert default_hparams().to_dict() == jax_default_hparams().to_dict()
    assert tiny_test_hparams().to_dict() == jax_tiny().to_dict()
    over = default_hparams(Train={"Batch_Size": 3})
    assert over.Train.Batch_Size == 3 and over.Train.Max_Step == 300000


@pytest.fixture(scope="module")
def lut_reference():
    """JAX: a LUT model's init and one train step (tiny, f32, dropout 0)."""
    hp_j = jax_tiny().replace(Speaker_Embedding=LUT, **NO_DROPOUT)
    batch = _batch(hp_j)
    models = jtrainer.build_models(hp_j)
    state = jtrainer.init_state(hp_j, models, jax.random.PRNGKey(0), batch)
    new_state, metrics = jax.jit(jtrainer.make_train_step(hp_j, models))(
        state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"hp": Recursive_Parse(hp_j.to_dict()), "batch": batch, "params": tree(state.params),
            "batch_stats": tree(state.batch_stats), "new_params": tree(new_state.params),
            "metrics": {k: float(v) for k, v in metrics.items()}}


def test_lut_train_step_matches_jax(lut_reference):
    ref = lut_reference
    trainer = Trainer.from_params(ref["hp"], ref["params"], ref["batch_stats"], device="cpu")
    assert trainer.ge2e is None and "speaker_lut.table.weight" in trainer.param_names
    metrics = trainer.train_step(ref["batch"])
    for key, want in ref["metrics"].items():
        assert abs(metrics[key] - want) <= LOSS_TOL * max(abs(want), 1e-12), key
    got = dict(_leaves(weights.params_to_jax(trainer.state(), ref["hp"])[0]))
    want = dict(_leaves(ref["new_params"]))
    assert got.keys() == want.keys() and "speaker_lut/table/embedding" in want
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= PARAM_TOL, k
    # The table trains: the rows of the batch's speakers moved, the others not.
    table = got["speaker_lut/table/embedding"] - ref["params"]["speaker_lut"]["table"]["embedding"]
    assert np.abs(table[1:]).max() > 0 and np.abs(table[0]).max() == 0


def test_fresh_init_has_the_jax_names_shapes_and_families(lut_reference, tmp_path):
    """The port's random init against the JAX init of the same LUT model:
    every path and shape; biases, BatchNorm scales and statistics exactly;
    recurrent weights inside U(-1/sqrt(H), 1/sqrt(H)); kernels, tables and
    recurrent tensors of 64 values or more at the same spread (within 25%)."""
    trainer = Trainer(lut_reference["hp"], tmp_path / "ck", tmp_path / "log", device="cpu", seed=3)
    trainer.initialize()
    assert trainer.step == 0  # an empty checkpoint directory: nothing to resume
    params, batch_stats = weights.params_to_jax(trainer.state(), lut_reference["hp"])
    for got, want in ((params, lut_reference["params"]),
                      (batch_stats, lut_reference["batch_stats"])):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert got.keys() == want.keys()
        for k in want:
            g, w = got[k], want[k]
            assert g.shape == w.shape, k
            if np.all(w == w.flat[0]):
                assert np.array_equal(g, w), k
            elif k.rsplit("/", 1)[-1] in ("w_ih", "w_hh", "b", "b_ih", "b_hh"):
                bound = (g.shape[-1] // (3 if "/gru/" in k else 4)) ** -0.5
                assert max(np.abs(g).max(), np.abs(w).max()) <= bound, k
                assert g.size < 64 or abs(g.std() / w.std() - 1) < 0.25, k
            elif g.size >= 64:
                assert abs(g.std() / w.std() - 1) < 0.25, k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    generate_synthetic_dataset(tiny_test_hparams(), root, n_speakers=3, n_utterances=2)
    return root / "patterns"


def _hp(**over):
    return tiny_test_hparams().replace(
        Train={"Checkpoint_Save_Interval": 2, "Logging_Interval": 1,
               "Batch_Bucketing": {"Token_Buckets": [50], "Mel_Buckets": [320]}},
        GE2E_Train={"Batch_Speakers": 3, "Batch_Utterances": 2, "Frame_Length": 24}, **over)


def test_train_saves_restores_and_resumes(corpus, tmp_path):
    hp = _hp()
    first = Trainer(hp, tmp_path / "ck", tmp_path / "log", device="cpu", seed=1)
    metrics = first.train(str(corpus), max_steps=3)
    assert first.step == 3 and np.isfinite(metrics["total"]) and not metrics["skipped_nonfinite"]
    assert first.checkpoints.steps() == [2, 3]
    state, step = CheckpointManager(tmp_path / "ck").restore()
    assert step == 3 and state["hp"] == hp.to_dict()
    second = Trainer(hp, tmp_path / "ck", tmp_path / "log", device="cpu", seed=7)
    second.initialize()
    assert second.step == 3
    for a, b in zip(first.params + first.opt_state.mu + first.opt_state.nu,
                    second.params + second.opt_state.mu + second.opt_state.nu):
        assert torch.equal(a, b)
    assert second.opt_state.count == first.opt_state.count
    assert torch.equal(first.generator.get_state(), second.generator.get_state())
    assert all(torch.equal(a, b) for a, b in zip(first.bn_stats(), second.bn_stats()))
    more = second.train(str(corpus), max_steps=4)
    assert second.step == 4 and np.isfinite(more["total"])
    # Inference from the directory and from the state.
    synth = Synthesizer.from_path(str(tmp_path / "ck"), device="cpu")  # the directory
    again = Synthesizer.from_state(hp, second.checkpoint_state(), device="cpu")
    emb = np.ones(hp.Speaker_Embedding.Embedding_Size, np.float32) / 4.0
    a = synth.synthesize(["a short test."], emb, max_steps=16, vocode=False)[0]
    b = again.synthesize(["a short test."], emb, max_steps=16, vocode=False)[0]
    assert a["mel_length"] == b["mel_length"] > 0 and np.array_equal(a["mel"], b["mel"])


def test_evaluate_inference_sample_and_profile(corpus, tmp_path):
    """``evaluate`` returns finite mean losses, ``inference_step`` logs an
    alignment and audio sample, and a ``profile_steps`` window writes a
    trace."""
    trainer = Trainer(_hp(), tmp_path / "ck", tmp_path / "log", device="cpu")
    trainer.profile_steps = (1, 2)
    trainer.train(str(corpus), max_steps=2)
    assert (tmp_path / "log" / "profile" / "trace.json").stat().st_size > 0
    means = trainer.evaluate(str(corpus), step=2, max_batches=1)
    assert {"total", "mel_pre", "mel_post", "stop"} <= set(means)
    assert all(np.isfinite(v) for v in means.values())
    logged = []
    trainer.logger.add_audio = lambda tag, wav, step, sr: logged.append((tag, wav.shape, sr))
    trainer.inference_step(str(corpus), step=2)
    assert logged and logged[0][0] == "Inference/Audio" and logged[0][1][0] > 0


def test_export_compact_round_trips_with_jax(lut_reference, tmp_path):
    params, batch_stats = lut_reference["params"], lut_reference["batch_stats"]
    meta = {"hp": lut_reference["hp"].to_dict()}
    export_compact(tmp_path / "port.msgpack", params, batch_stats, meta)
    jckpt.export_compact(tmp_path / "jax.msgpack", params, batch_stats, meta)
    assert (tmp_path / "port.msgpack").read_bytes() == (tmp_path / "jax.msgpack").read_bytes()
    for read, path in ((jckpt.load_compact, "port.msgpack"), (load_compact, "jax.msgpack")):
        got_p, got_bs, got_meta = read(tmp_path / path)
        assert got_meta == meta
        for got, want in ((got_p, params), (got_bs, batch_stats)):
            got, want = dict(_leaves(got)), dict(_leaves(want))
            assert got.keys() == want.keys()
            for k in want:
                assert np.array_equal(got[k], want[k].astype(np.float16).astype(np.float32)), k


def test_cli_trains_both_modes_on_the_cpu(corpus, tmp_path):
    hp_file = tmp_path / "hp.json"
    hp_file.write_text(json.dumps(_hp().to_dict()))
    common = ["-hp", str(hp_file), "-train_pattern", str(corpus), "-log", str(tmp_path / "log"),
              "-device", "cpu"]
    cli.main(common + ["-mode", "ge2e", "-checkpoint", str(tmp_path / "ge2e"), "-max_step", "2"])
    assert CheckpointManager(tmp_path / "ge2e").steps() == [2]
    cli.main(common + ["-mode", "tts", "-checkpoint", str(tmp_path / "tts"), "-ge2e_checkpoint",
                       str(tmp_path / "ge2e"), "-freeze_ge2e", "-max_step", "2"])
    state, step = CheckpointManager(tmp_path / "tts").restore()
    ge2e, _ = CheckpointManager(tmp_path / "ge2e").restore()
    assert step == 2 and state["hp"]["Speaker_Embedding"]["GE2E"]["Freeze"]
    # The frozen encoder is the pretrained one, grafted and never updated.
    for k, v in ge2e["params"]["encoder"].items():
        assert torch.equal(state["params"][f"ge2e.{k}"], v), k
    # -distributed alone (no process count) runs in this one process, as the
    # JAX CLI does; the data-parallel runs are tests/test_torch_parallel.py's.
    cli.main(common + ["-mode", "ge2e", "-checkpoint", str(tmp_path / "ge2e"), "-max_step", "3",
                       "-distributed"])
    assert CheckpointManager(tmp_path / "ge2e").steps() == [2, 3]
