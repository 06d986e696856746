"""The port's GE2E speaker-encoder training against the JAX package's, on
the CPU: the leave-one-out similarity matrix and the softmax loss; the
optimizer chain (clip to a global norm of 3, w / b scaled by
``Scale_Gradient``, SGD with momentum) against optax; one and two
``GE2ETrainer`` steps against the JAX ``make_ge2e_train_step`` from the same
init (tiny hparams, f32): loss 1e-5 relative, every parameter 1e-5 absolute.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_speaker_tts_tpu.hparams import tiny_test_hparams as jax_tiny
from multi_speaker_tts_tpu.models import GE2E as JaxGE2E
from multi_speaker_tts_tpu.models import ge2e as jge2e
from multi_speaker_tts_tpu.train import ge2e_trainer as jtrain
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.models.ge2e import ge2e_loss, ge2e_similarity_matrix
from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2EOptimizer, GE2ETrainer
from multi_speaker_tts_tpu_torch.weights import params_from_jax

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

N, M, L = 3, 4, 24
PARAM_TOL = 1e-5


def _embeddings(seed, n=N, m=M, e=16):
    x = np.random.default_rng(seed).normal(size=(n, m, e)).astype(np.float32)
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.mark.parametrize("w, b", [(10.0, -5.0), (-2.0, 0.5)], ids=["init", "w_clamped"])
def test_similarity_and_loss_match_jax(w, b):
    e = _embeddings(0)
    want = np.asarray(jge2e.ge2e_similarity_matrix(jnp.asarray(e), w, b))
    got = ge2e_similarity_matrix(torch.from_numpy(e), torch.tensor(w), torch.tensor(b))
    assert np.abs(want - got.numpy()).max() <= 1e-5
    want_l = float(jge2e.ge2e_loss(jnp.asarray(e), w, b))
    got_l = float(ge2e_loss(torch.from_numpy(e), torch.tensor(w), torch.tensor(b)))
    assert abs(want_l - got_l) <= 1e-5 * abs(want_l)


@pytest.mark.parametrize("scale", [0.01, 1e3], ids=["below_clip", "clipped"])
def test_optimizer_matches_optax(scale):
    """Two updates of random gradients (global norm below 3, and far above
    it) through the port's chain and through optax's."""
    hp = jax_tiny().replace(GE2E_Train={"Learning_Rate": 0.05})
    tx = jtrain.make_ge2e_optimizer(hp)
    rng = np.random.default_rng(1)
    params = {"encoder": {"k": rng.normal(size=(3, 4)).astype(np.float32)},
              "w": np.asarray(10.0, np.float32), "b": np.asarray(-5.0, np.float32)}
    port = GE2EOptimizer(0.05, 0.01)
    names = {"encoder.k": ("encoder", "k"), "w": ("w",), "b": ("b",)}
    state, trace = tx.init(params), port.init({k: torch.zeros(()) if k != "encoder.k"
                                               else torch.zeros(3, 4) for k in names})
    for _ in range(2):
        g = {"encoder": {"k": (rng.normal(size=(3, 4)) * scale).astype(np.float32)},
             "w": np.asarray(rng.normal() * scale, np.float32),
             "b": np.asarray(rng.normal() * scale, np.float32)}
        want, state = tx.update(g, state, params)
        got, trace = port.update({"encoder.k": torch.from_numpy(g["encoder"]["k"]),
                                  "w": torch.tensor(g["w"]), "b": torch.tensor(g["b"])}, trace)
        for k, path in names.items():
            w = want
            for p in path:
                w = w[p]
            assert np.allclose(np.asarray(w), got[k].numpy(), rtol=1e-6, atol=1e-9), k


@pytest.fixture(scope="module")
def reference():
    """JAX: a GE2E init and two train steps on two seeded batches."""
    hp_j = jax_tiny().replace(GE2E_Train={"Batch_Speakers": N, "Batch_Utterances": M,
                                          "Frame_Length": L, "Learning_Rate": 0.05})
    model = JaxGE2E.from_hp(hp_j)
    rng = np.random.default_rng(4)
    batches = [rng.random((N * M, L, hp_j.Sound.Mel_Dim)).astype(np.float32) for _ in range(2)]
    state = jtrain.init_ge2e_state(hp_j, model, jax.random.PRNGKey(0), batches[0])
    init = jax.tree.map(np.asarray, state.params)
    step = jax.jit(jtrain.make_ge2e_train_step(hp_j, model))
    after, metrics = [], []
    for mels in batches:
        state, m = step(state, jnp.asarray(mels))
        after.append(jax.tree.map(np.asarray, state.params))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"hp": Recursive_Parse(hp_j.to_dict()), "init": init, "batches": batches,
            "after": after, "metrics": metrics}


def _port_trainer(ref, tmp_path):
    trainer = GE2ETrainer(ref["hp"], checkpoint_dir=tmp_path / "ck", log_dir=tmp_path / "log",
                          device="cpu")
    state = params_from_jax({"ge2e": ref["init"]["encoder"]}, {}, ref["hp"])
    with torch.no_grad():
        for k, p in trainer.params.items():
            p.copy_(torch.tensor(np.array(state[f"ge2e.{k[len('encoder.'):]}"]
                                          if k.startswith("encoder.") else ref["init"][k])))
    return trainer


def test_two_steps_match_jax(reference, tmp_path):
    trainer = _port_trainer(reference, tmp_path)
    for mels, want, m in zip(reference["batches"], reference["after"], reference["metrics"]):
        got = trainer.train_step(mels)
        assert abs(got["loss"] - m["loss"]) <= 1e-5 * abs(m["loss"])
        enc = params_from_jax({"ge2e": want["encoder"]}, {}, reference["hp"])
        for k, p in trainer.params.items():
            w = enc[f"ge2e.{k[len('encoder.'):]}"] if k.startswith("encoder.") else want[k]
            assert np.abs(np.asarray(w) - p.detach().numpy()).max() <= PARAM_TOL, k
        assert got["w"] == pytest.approx(float(want["w"]), abs=PARAM_TOL)
    assert trainer.step == 2


def test_train_saves_and_resumes(reference, tmp_path):
    """``train`` on a synthetic corpus: a checkpoint at the end; a second
    trainer on the same directory resumes from it with the same state."""
    from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset

    hp = reference["hp"]
    generate_synthetic_dataset(hp, tmp_path / "corpus", n_speakers=N, n_utterances=2)
    pats = str(tmp_path / "corpus" / "patterns")
    first = GE2ETrainer(hp, tmp_path / "ck", tmp_path / "log", device="cpu")
    m = first.train(pats, max_steps=2)
    assert np.isfinite(m["loss"]) and first.checkpoints.steps() == [2]
    second = GE2ETrainer(hp, tmp_path / "ck", tmp_path / "log", device="cpu", seed=9)
    second.train(pats, max_steps=2)  # resumes at 2: no step
    assert second.step == 2
    for k, p in first.params.items():
        assert torch.equal(p, second.params[k]), k
    for k, t in first.opt_state.items():
        assert torch.equal(t, second.opt_state[k]), k
