"""The port's training path against the JAX package's, on the CPU.

One tiny-hparams configuration (``tiny_test_hparams`` with the CBHG head,
f32, every dropout rate 0, GE2E trainable) and one batch, shared by the
module: the JAX package initializes the weights and runs ``make_train_step``
and ``make_eval_step`` once; the port's ``Trainer`` starts from the same
weights (carried across by ``weights.params_from_jax``) and is held to it:
losses 1e-4 relative, gradients 1e-3 of each tensor's peak, updated params
and batch_stats 1e-5 (f32 on both sides; the frameworks differ only in the
order of f32 sums). Beside it: the losses, the optimizer chain, ``collate_tts``
and ``spectrogram`` against their JAX counterparts, the ``Freeze`` switch,
the non-finite guard, a second step on the first step's weights, the
``params_to_jax`` round trip, and that serving builds no autograd graph.
"""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_speaker_tts_tpu.audio import dsp as jdsp
from multi_speaker_tts_tpu.data.datasets import collate_tts as jax_collate
from multi_speaker_tts_tpu.hparams import tiny_test_hparams
from multi_speaker_tts_tpu.models import losses as jlosses
from multi_speaker_tts_tpu.train import trainer as jtrainer
from multi_speaker_tts_tpu.train.optim import make_optimizer as jax_make_optimizer
from multi_speaker_tts_tpu_torch import weights
from multi_speaker_tts_tpu_torch.audio import dsp
from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.data.collate import collate_tts
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.models import losses
from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, lstm_kernel
from multi_speaker_tts_tpu_torch.train.optim import make_optimizer
from multi_speaker_tts_tpu_torch.train.trainer import Trainer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPTS = ["demo/serving_ckpt.msgpack", "demo/serving_ckpt_full.msgpack"]
LOSS_TOL = 1e-4  # relative, f32 on both sides
GRAD_TOL = 1e-3  # of each gradient tensor's peak
PARAM_TOL = 1e-5  # absolute, after one update


def _tiny_hp():
    return tiny_test_hparams().replace(
        Decoder={"Prenet": {"Dropout_Rate": 0.0}},
        Encoder={"Conv": {"Dropout_Rate": 0.0}},
        Postnet={"Conv": {"Dropout_Rate": 0.0}},
        Linear_Head={"Type": "CBHG", "Conv": {"Dropout_Rate": 0.0}},
    )


def _patterns(hp, rng, B=3, S=12, T=20):
    M, F = hp.Sound.Mel_Dim, hp.Sound.Spectrogram_Dim
    return [{"Tokens": rng.integers(1, 30, size=S - 2 * i).astype(np.int32),
             "Mel": rng.random((T - 4 * i + 1, M)).astype(np.float32),
             "Ref_Mel": rng.random((T + 10 - 9 * i, M)).astype(np.float32),
             "Spect": rng.random((T - 4 * i + 1, F)).astype(np.float32),
             "Speaker_ID": i} for i in range(B)]


def _batch(hp, seed=0):
    pats = _patterns(hp, np.random.default_rng(seed))
    return collate_tts(pats, 12, 20, hp.Sound.Mel_Dim, 1, hp.Speaker_Embedding.GE2E.Window_Length,
                       np.random.default_rng(seed + 1), hp.Sound.Spectrogram_Dim)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def reference():
    """JAX: init, one train step and one eval step on one batch."""
    hp_j = _tiny_hp()
    batch = _batch(hp_j)
    models = jtrainer.build_models(hp_j)
    state = jtrainer.init_state(hp_j, models, jax.random.PRNGKey(0), batch)
    dev_batch = jax.tree.map(jnp.asarray, batch)
    new_state, metrics = jax.jit(jtrainer.make_train_step(hp_j, models))(
        state, dev_batch, jax.random.PRNGKey(1))
    eval_losses, _ = jax.jit(jtrainer.make_eval_step(hp_j, models))(
        state, dev_batch, jax.random.PRNGKey(2))
    # The raw gradients, from RAdam's first moment after one update:
    # mu = (1 - b1) * clip(g), and clip scales by max_norm / |g| when
    # |g| >= max_norm.
    gn = float(metrics["grad_norm"])
    unclip = max(gn / hp_j.Train.Gradient_Norm, 1.0)
    mu = new_state.opt_state[1][0].mu
    grads = jax.tree.map(lambda m: np.asarray(m) / (1.0 - hp_j.Train.ADAM.Beta1) * unclip, mu)
    return {
        "hp": Recursive_Parse(hp_j.to_dict()), "batch": batch,
        "params": _np_tree(state.params), "batch_stats": _np_tree(state.batch_stats),
        "metrics": {k: float(v) for k, v in metrics.items()},
        "eval": {k: float(v) for k, v in eval_losses.items()},
        "grads": grads, "new_params": _np_tree(new_state.params),
        "new_batch_stats": _np_tree(new_state.batch_stats),
    }


def _trainer(ref, **hp_changes):
    hp = ref["hp"].replace(**hp_changes) if hp_changes else ref["hp"]
    return Trainer.from_params(hp, ref["params"], ref["batch_stats"], device="cpu")


def _rel(want, got) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_train_step_matches_jax(reference):
    ref = reference
    trainer = _trainer(ref)
    metrics = trainer.train_step(ref["batch"])
    assert metrics["skipped_nonfinite"] == 0.0
    for key, want in ref["metrics"].items():
        if key != "skipped_nonfinite":
            assert _rel(want, metrics[key]) <= LOSS_TOL, key
    params, batch_stats = weights.params_to_jax(trainer.state(), ref["hp"])
    for got, want in ((params, ref["new_params"]), (batch_stats, ref["new_batch_stats"])):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert got.keys() == want.keys()
        for k in want:
            assert np.abs(got[k] - want[k]).max() <= PARAM_TOL, k


def test_gradients_match_jax(reference):
    ref = reference
    got_losses, grads = _trainer(ref).gradients(ref["batch"])
    assert _rel(ref["metrics"]["total"], got_losses["total"]) <= LOSS_TOL
    got = dict(_leaves(weights.params_to_jax(grads, ref["hp"])[0]))
    want = dict(_leaves(ref["grads"]))
    assert got.keys() == want.keys()
    # A conv bias ahead of a train-mode BatchNorm has an exact gradient of
    # 0, so both sides hold f32 round-off there (~1e-8): beside 1e-3 of each
    # tensor's peak, a floor of 1e-6 of the global gradient norm.
    floor = 1e-6 * ref["metrics"]["grad_norm"]
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= GRAD_TOL * np.abs(want[k]).max() + floor, k


def test_eval_step_matches_jax(reference):
    ref = reference
    trainer = _trainer(ref)
    before = [b.clone() for b in trainer.bn_stats()]
    got, outputs = trainer.eval_step(ref["batch"])
    for key, want in ref["eval"].items():
        assert _rel(want, got[key]) <= LOSS_TOL, key
    assert all(torch.equal(a, b) for a, b in zip(before, trainer.bn_stats()))
    assert not any(v.requires_grad for v in outputs.values())


def test_freeze_leaves_the_speaker_encoder_unchanged(reference):
    ref = reference
    trainer = _trainer(ref, Speaker_Embedding={"GE2E": {"Freeze": True}})
    before = {k: v for k, v in trainer.state().items() if k.startswith("ge2e.")}
    launches = lstm_kernel.BWD_KERNEL.launches
    metrics = trainer.train_step(ref["batch"])
    assert metrics["skipped_nonfinite"] == 0.0
    after = trainer.state()
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v, err_msg=k)
    assert lstm_kernel.BWD_KERNEL.launches == launches
    assert not np.array_equal(after["tacotron.decoder.lstm.0.w_hh"],
                              ref["params"]["tacotron"]["decoder"]["cell"]["lstm_0"]["w_hh"])


def test_nonfinite_guard_restores_everything(reference):
    ref = reference
    trainer = _trainer(ref)
    state0 = trainer.state()  # params and BatchNorm statistics
    poisoned = dict(ref["batch"], mels=ref["batch"]["mels"].copy())
    poisoned["mels"][0, 0, 0] = np.nan
    metrics = trainer.train_step(poisoned)
    assert metrics["skipped_nonfinite"] == 1.0 and not np.isfinite(metrics["total"])
    for k, v in trainer.state().items():
        np.testing.assert_array_equal(v, state0[k], err_msg=k)
    assert trainer.opt_state.count == 0 and trainer.step == 1
    assert all(not m.any() for m in trainer.opt_state.mu + trainer.opt_state.nu)
    # A clean batch still updates, exactly as the first step of a fresh run.
    metrics = trainer.train_step(ref["batch"])
    assert metrics["skipped_nonfinite"] == 0.0
    assert _rel(ref["metrics"]["total"], metrics["total"]) <= LOSS_TOL


def test_second_step_sees_the_first_steps_weights(reference):
    """The update is in place; the second step computes on the updated
    weights (as a trainer built from them does), and every kernel layout
    packed from a weight before the update is rebuilt after it."""
    ref = reference
    trainer = _trainer(ref)
    lstm0 = trainer.ge2e.lstm[0].params
    gru = trainer.tacotron.linear_head.cbhg.gru.forward_dir.params
    layouts = [(lstm_kernel._kernel_layout, (lstm0.w_ih, lstm0.w_hh, lstm0.b)),
               (lstm_kernel._bf16, (lstm0.w_hh,)),
               (birnn_kernel._transposed_bf16, (gru.w_hh,)),
               (birnn_kernel._f32, (gru.b_hh,))]
    before = [_build.packed(make, *ws) for make, ws in layouts]
    trainer.train_step(ref["batch"])
    for (make, ws), old in zip(layouts, before):
        new = _build.packed(make, *ws)
        assert new is not old  # rebuilt: the in-place update bumped the versions
        fresh = make(*(w.detach().clone() for w in ws))
        for a, b in zip(*(x if isinstance(x, tuple) else (x,) for x in (new, fresh))):
            assert torch.equal(a, b) and not a.requires_grad
    params, batch_stats = weights.params_to_jax(trainer.state(), ref["hp"])
    second = trainer.train_step(ref["batch"])
    fresh = Trainer.from_params(ref["hp"], params, batch_stats, device="cpu")
    fresh_losses, _ = fresh.gradients(ref["batch"])
    for key, value in fresh_losses.items():
        assert second[key] == value, key
    assert second["total"] != ref["metrics"]["total"]


def _random_outputs(rng, B=3, T=12, r=2, S=9, M=8, F=10):
    n = T // r
    return {"mel_pre": rng.normal(size=(B, T, M)), "mel_post": rng.normal(size=(B, T, M)),
            "stop_logits": rng.normal(size=(B, n)) * 3,
            "alignments": rng.dirichlet(np.ones(S), size=(B, n)),
            "linear": rng.normal(size=(B, T, F))}


@pytest.mark.parametrize("sigma", [0.2, None])
def test_losses_match_jax(sigma):
    rng = np.random.default_rng(5)
    out = {k: v.astype(np.float32) for k, v in _random_outputs(rng).items()}
    mels = rng.normal(size=(3, 12, 8)).astype(np.float32)
    spects = rng.normal(size=(3, 12, 10)).astype(np.float32)
    mel_lengths = np.array([12, 7, 3], np.int32)
    token_lengths = np.array([9, 5, 1], np.int32)
    want = jlosses.tacotron_losses(
        {k: jnp.asarray(v) for k, v in out.items()}, jnp.asarray(mels), jnp.asarray(mel_lengths),
        jnp.asarray(token_lengths), spects=jnp.asarray(spects), n_frames_per_step=2,
        guided_attention_sigma=sigma)
    got = losses.tacotron_losses(
        {k: torch.from_numpy(v) for k, v in out.items()}, torch.from_numpy(mels),
        torch.from_numpy(mel_lengths), torch.from_numpy(token_lengths),
        spects=torch.from_numpy(spects), n_frames_per_step=2, guided_attention_sigma=sigma)
    assert got.keys() == want.keys()
    for k in want:
        assert _rel(float(want[k]), float(got[k])) <= 1e-6, k


# 3 steps at the shipped Beta2 stay below RAdam's rectification threshold
# (rho_t >= 5); 8 steps at Beta2 = 0.9 cross it at step 6. (At Beta2 = 0.999
# the threshold is crossed at step 6 too, but there rho_t = 1999 - 1993 in
# f32, so the one ulp by which XLA's power differs from a correctly rounded
# one moves r by ~0.4%: no f32 implementation can match it closer.)
@pytest.mark.parametrize("steps, beta2", [(3, 0.999), (8, 0.9)])
def test_optimizer_matches_optax(steps, beta2):
    hp = Recursive_Parse(_tiny_hp().to_dict()).replace(
        Train={"Learning_Rate": {"Initial": 1e-2, "Warmup_Step": 4}, "Weight_Decay": 1e-2,
               "ADAM": {"Beta2": beta2}})
    rng = np.random.default_rng(6)
    shapes = {"a": (3, 4), "b": (5,)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jopt = jax_make_optimizer(_tiny_hp().replace(Train=hp.Train.to_dict()))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    jstate = jopt.init(jp)
    topt = make_optimizer(hp)
    tp = [torch.from_numpy(p0[k].copy()) for k in shapes]
    tstate = topt.init(tp)
    for step in range(steps):
        scale = 10.0 if step == 1 else 0.1  # one step over the clipping norm
        g = {k: (rng.normal(size=s) * scale).astype(np.float32) for k, s in shapes.items()}
        upd, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tu, tstate = topt.update([torch.from_numpy(g[k]) for k in shapes], tstate, tp)
        tp = [p + u for p, u in zip(tp, tu)]
        for k, t in zip(shapes, tp):
            want = np.asarray(jp[k])
            assert np.abs(t.numpy() - want).max() <= 1e-6 * np.abs(want).max(), (step, k)


def test_collate_matches_jax():
    hp = _tiny_hp()
    pats = _patterns(hp, np.random.default_rng(7), B=4)
    pats[3]["Ref_Mel"] = pats[3]["Ref_Mel"][:5]  # shorter than the window: wrap-padded
    args = (12, 20, hp.Sound.Mel_Dim, 2, 24)
    want = jax_collate(pats, *args, rng=np.random.default_rng(8),
                       spect_dim=hp.Sound.Spectrogram_Dim)
    got = collate_tts(pats, *args, rng=np.random.default_rng(8),
                      spect_dim=hp.Sound.Spectrogram_Dim)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_spectrogram_matches_jax():
    hp = _tiny_hp()
    cfg_j = jdsp.DSPConfig.from_hp(hp)
    cfg = dsp.DSPConfig.from_hp(Recursive_Parse(hp.to_dict()))
    wav = np.random.default_rng(9).standard_normal((2, 64 * 30)).astype(np.float32) * 0.3
    want = np.asarray(jdsp.spectrogram(jnp.asarray(wav), cfg_j))
    got = dsp.spectrogram(torch.from_numpy(wav), cfg).numpy()
    assert got.shape == want.shape == (2, 31, hp.Sound.Spectrogram_Dim)
    assert np.abs(got - want).max() <= 1e-4  # the mel front-end's gate


@pytest.mark.parametrize("path", CKPTS)
def test_params_to_jax_round_trip(path):
    params, batch_stats, meta = load_compact(ROOT / path)
    hp = Recursive_Parse(meta["hp"])
    back = weights.params_to_jax(weights.params_from_jax(params, batch_stats, hp), hp)
    for got, want in zip(back, (params, batch_stats)):
        got, want = dict(_leaves(got)), dict(_leaves(want))
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_serving_builds_no_autograd_graph():
    """Parameters are trainable now; enroll and synthesize still run every
    module with autograd off, so no output of any module needs a gradient."""
    from multi_speaker_tts_tpu_torch.inference import Synthesizer

    synth = Synthesizer.from_compact(str(ROOT / CKPTS[0]), device="cpu")
    seen = []

    def hook(module, args, out):
        outs = out if isinstance(out, (tuple, list)) else [out]
        seen.append(torch.is_grad_enabled() or any(
            isinstance(o, torch.Tensor) and o.requires_grad for o in outs))

    for module in (synth.ge2e, synth.tacotron):
        for m in module.modules():
            m.register_forward_hook(hook)
    emb = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    out = synth.synthesize(["a b"], emb, max_steps=16)
    assert seen and not any(seen)
    assert all(p.requires_grad for p in synth.tacotron.parameters())
    assert np.isfinite(out[0]["wav"]).all()


@pytest.mark.parametrize("fn", ["lstm", "bilstm", "bigru"])
def test_backward_wrappers_refuse_f32_on_the_card(fn, monkeypatch):
    """On a CUDA tensor a backward launches its kernel or raises; the
    kernels compute in bf16 only."""
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    z = torch.zeros
    with pytest.raises(NotImplementedError, match="bf16"):
        if fn == "lstm":
            lstm_kernel.lstm_seq_layer_bwd(z(8, 32), z(2, 2, 32), z(2, 2, 8), None, None,
                                           torch.float32)
        elif fn == "bilstm":
            birnn_kernel.bilstm_bwd(z(2, 2, 32), z(2, 2, 8), z(2, 2, 32), z(2, 2, 8), z(8, 32),
                                    z(8, 32), z(2, 2, 8), z(2, 2, 8), torch.float32)
        else:
            birnn_kernel.bigru_bwd(*[z(2, 2, 24), z(2, 2, 24), z(2, 2, 8)] * 2, z(8, 24),
                                   z(8, 24), z(2, 2, 8), z(2, 2, 8), torch.float32)


def test_cpu_training_never_counts_launches(reference):
    kernels = (lstm_kernel.KERNEL, lstm_kernel.RES_KERNEL, lstm_kernel.BWD_KERNEL,
               birnn_kernel.KERNEL, birnn_kernel.RES_KERNEL, birnn_kernel.BWD_KERNEL,
               birnn_kernel.GRU_KERNEL, birnn_kernel.GRU_RES_KERNEL, birnn_kernel.GRU_BWD_KERNEL)
    before = [k.launches for k in kernels]
    _trainer(reference).train_step(reference["batch"])
    assert [k.launches for k in kernels] == before


def test_trainer_runs_on_the_card_unless_asked(reference, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer.from_params(reference["hp"], reference["params"], reference["batch_stats"])
