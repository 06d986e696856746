"""The port's evaluation (``multi_speaker_tts_tpu_torch/evaluate.py``)
against the JAX package's ``evaluate.py`` on the CPU: the two numpy metrics
on seeded inputs (1e-12), ``evaluate`` (teacher-forced losses, attention
diagonality) and ``speaker_verification`` (EER, cosines, centroid accuracy)
on a tiny synthetic pattern set with the same weights (the port's fresh
init carried over by ``weights.params_to_jax``; f32, every dropout 0:
losses 1e-4, EER and cosines 1e-5), and the CLI on a compact export and on
a checkpoint directory."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu import evaluate as jeval
from multi_speaker_tts_tpu.hparams import Recursive_Parse as JaxRecursiveParse
from multi_speaker_tts_tpu.train import trainer as jtrainer
from multi_speaker_tts_tpu_torch import evaluate, weights
from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
from multi_speaker_tts_tpu_torch.hparams import tiny_test_hparams
from multi_speaker_tts_tpu_torch.train.checkpoints import export_compact
from multi_speaker_tts_tpu_torch.train.trainer import Trainer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

LOSS_TOL, SV_TOL = 1e-4, 1e-5
NO_DROPOUT = dict(Decoder={"Prenet": {"Dropout_Rate": 0.0}}, Encoder={"Conv": {"Dropout_Rate": 0.0}},
                  Postnet={"Conv": {"Dropout_Rate": 0.0}},
                  Linear_Head={"Conv": {"Dropout_Rate": 0.0}})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_attention_diagonality_matches_jax(seed):
    rng = np.random.default_rng(seed)
    B, T, S = 5, 40, 17
    al = rng.random((B, T, S))
    al /= al.sum(-1, keepdims=True)
    tl = rng.integers(1, S + 1, size=B)
    for r in (1, 2):
        ml = rng.integers(1, r * T + 1, size=B)  # frames: up to T steps of r
        got = evaluate.attention_diagonality(al, tl, ml, r)
        assert abs(got - jeval.attention_diagonality(al, tl, ml, r)) <= 1e-12


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_compute_eer_matches_jax(seed):
    rng = np.random.default_rng(seed)
    labels = rng.random(300) < 0.3
    scores = rng.normal(size=300) + 1.2 * labels
    if seed == 3:  # ties and a perfect split
        scores = np.round(scores * 2) / 2
    got = evaluate.compute_eer(scores, labels)
    assert abs(got - jeval.compute_eer(scores, labels)) <= 1e-12 and 0.0 <= got <= 1.0
    assert evaluate.compute_eer(np.r_[np.ones(4), np.zeros(4)], np.r_[[True] * 4, [False] * 4]) == 0.0
    with pytest.raises(ValueError):
        evaluate.compute_eer(scores[:3], np.ones(3, bool))


def _hp():
    return tiny_test_hparams().replace(
        Train={"Batch_Bucketing": {"Token_Buckets": [50], "Mel_Buckets": [320]}}, **NO_DROPOUT)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """A synthetic corpus (4 speakers x 3 utterances), a fresh port trainer
    and the JAX models on its weights."""
    root = tmp_path_factory.mktemp("evalcorpus")
    generate_synthetic_dataset(tiny_test_hparams(), root, n_speakers=4, n_utterances=3)
    hp = _hp()
    trainer = Trainer(hp, root / "ck", root / "log", device="cpu", seed=5)
    trainer.initialize()
    params, batch_stats = weights.params_to_jax(trainer.state(), hp)
    hp_j = JaxRecursiveParse(hp.to_dict())
    models = jtrainer.build_models(hp_j)
    state = jtrainer.TrainState(step=jnp.zeros([], jnp.int32),
                                params=jax.tree.map(jnp.asarray, params),
                                batch_stats=jax.tree.map(jnp.asarray, batch_stats),
                                opt_state=None)
    return {"root": root, "patterns": str(root / "patterns"), "hp": hp, "hp_j": hp_j,
            "trainer": trainer, "models": models, "state": state, "params": params,
            "batch_stats": batch_stats}


def test_evaluate_matches_jax(setup):
    s = setup
    got = evaluate.evaluate(s["hp"], s["trainer"], s["patterns"], max_batches=2)
    want = jeval.evaluate(s["hp_j"], s["state"], s["models"], s["patterns"], max_batches=2)
    assert got.keys() == want.keys() and got["num_batches"] == want["num_batches"] == 2
    assert {"mel_pre", "mel_post", "stop", "linear", "total"} <= set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= LOSS_TOL * max(abs(v), 1.0), (k, got[k], v)


def test_speaker_verification_matches_jax(setup):
    s = setup
    got = evaluate.speaker_verification(s["hp"], s["trainer"].ge2e, s["patterns"],
                                        batch_size=5, return_embeddings=True)
    want = jeval.speaker_verification(s["hp_j"], s["state"].params, s["models"], s["patterns"],
                                      batch_size=5, return_embeddings=True)
    assert got["sv_num_utterances"] == want["sv_num_utterances"] == 12
    assert got["sv_num_speakers"] == want["sv_num_speakers"] == 4
    np.testing.assert_array_equal(got["speaker_of"], want["speaker_of"])
    assert np.abs(got["embeddings"] - np.asarray(want["embeddings"])).max() <= SV_TOL
    for k in ("sv_eer", "sv_own_cos", "sv_cross_cos", "sv_margin"):
        assert abs(got[k] - want[k]) <= SV_TOL, (k, got[k], want[k])
    assert got["sv_centroid_accuracy"] == want["sv_centroid_accuracy"]


def test_prenet_masks_are_the_same_on_every_device(setup):
    """The evaluation's prenet draws come from a CPU generator seeded with
    the call's seed: equal seeds give equal losses; another seed, other
    draws (dropout on)."""
    hp = _hp().replace(Decoder={"Prenet": {"Dropout_Rate": 0.5}})
    trainer = Trainer(hp, device="cpu")
    trainer.load_params(setup["params"], setup["batch_stats"])
    a = evaluate.evaluate(hp, trainer, setup["patterns"], max_batches=1, seed=3)
    b = evaluate.evaluate(hp, trainer, setup["patterns"], max_batches=1, seed=3)
    c = evaluate.evaluate(hp, trainer, setup["patterns"], max_batches=1, seed=4)
    assert a == b and a["total"] != c["total"]


def test_cli_on_an_export_and_a_checkpoint_directory(setup, capsys):
    s = setup
    export = s["root"] / "model.msgpack"
    export_compact(export, s["params"], s["batch_stats"], {"hp": s["hp"].to_dict()})
    s["trainer"].save(0)
    want = evaluate.evaluate(s["hp"], s["trainer"], s["patterns"], max_batches=1)
    for path in (export, s["root"] / "ck"):
        got = evaluate.main(["-checkpoint", str(path), "-pattern", s["patterns"], "-batches", "1",
                             "-sv", "-device", "cpu"])
        printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert printed.keys() == got.keys() and "sv_eer" in got
        # The export holds f16 weights; the directory the trainer's own.
        tol = 2e-2 if path == export else 1e-6
        for k in want:
            assert abs(got[k] - want[k]) <= tol * max(abs(want[k]), 1.0), (path, k)
    with pytest.raises(SystemExit):
        evaluate.main(["-checkpoint", str(s["root"] / "empty"), "-pattern", s["patterns"],
                       "-device", "cpu"])
