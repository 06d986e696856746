"""An f32 checkpoint through the port by the reference's routing, on the CPU.

The JAX package sends f32 compute to its XLA recurrences: its capability
checks (``lstm_pallas.supported``, ``birnn_pallas.supported``) require bf16.
The port states the dtype half of that rule once (``_build.supported``) and
its three dispatchers (``lstm_stack_seq``, ``bilstm``, ``bigru``) follow it:
f32 runs the plain recurrences (``lstm_stack``, ``bilstm_fused``,
``bigru_fused``) on the tensors' device, under autograd where a gradient is
needed; the kernel wrappers are not called (on the card they would raise).
Held here: the predicate against JAX's checks over a table of cases; each
dispatcher's f32 output and gradients against the JAX function the reference
runs (1e-4 of the peak, ``tests/test_torch_train_grad.py``'s f32 bound); and
the f32 teacher-forced forward and train step of ``tiny_test_hparams``
(which is f32) against JAX's, within ``tests/test_torch_train.py``'s bounds
(losses 1e-4 relative, updated params 1e-5), with no kernel path taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.hparams import tiny_test_hparams
from multi_speaker_tts_tpu.ops import birnn_pallas, lstm_pallas
from multi_speaker_tts_tpu.ops import gru as jgru
from multi_speaker_tts_tpu.ops import lstm as jlstm
from multi_speaker_tts_tpu.train import trainer as jtrainer
from multi_speaker_tts_tpu_torch import weights
from multi_speaker_tts_tpu_torch.data.collate import collate_tts
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.ops import _build, birnn_kernel, lstm_kernel
from multi_speaker_tts_tpu_torch.ops.gru import GRUParams
from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams
from multi_speaker_tts_tpu_torch.train.trainer import Trainer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

F32_TOL = 1e-4  # tests/test_torch_train_grad.py
LOSS_TOL = 1e-4  # tests/test_torch_train.py
PARAM_TOL = 1e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-9))


@pytest.fixture()
def kernel_path(monkeypatch):
    """Counts of every call into the kernel path: the three autograd
    Functions and the forward and backward wrappers."""
    calls = {}

    def spy(owner, name):
        original = getattr(owner, name)
        calls[name] = 0

        def wrapped(*a, **k):
            calls[name] += 1
            return original(*a, **k)

        monkeypatch.setattr(owner, name, wrapped)

    for cls in (lstm_kernel._LSTMStack, birnn_kernel._BiLSTM, birnn_kernel._BiGRU):
        spy(cls, "apply")
        calls[cls.__name__] = calls.pop("apply")
    for name in ("lstm_seq_layer_fwd", "lstm_seq_layer_bwd"):
        spy(lstm_kernel, name)
    for name in ("bilstm_recurrence", "bilstm_bwd", "bigru_recurrence", "bigru_bwd"):
        spy(birnn_kernel, name)
    return calls


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("H", [128, 96])
def test_predicate_is_the_dtype_half_of_the_jax_checks(dtype, H):
    """``_build.supported`` agrees with JAX's checks wherever their width
    half holds (H a lane multiple), and the port keeps no width half: at H
    96 JAX falls back for width, the port's kernels take bf16."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    layer = jlstm.LSTMParams(jnp.zeros((8, 4 * H)), jnp.zeros((H, 4 * H)), jnp.zeros(4 * H))
    jax_says = (lstm_pallas.supported([layer], jdt), birnn_pallas.supported(H, jdt))
    if H % 128 == 0:
        assert jax_says == (_build.supported(tdt),) * 2
    else:
        assert jax_says == (False, False)
    assert _build.supported(tdt) == (dtype == "bfloat16")


def _stack_case(rng, B=3, T=9, D=16, H=24, L=2):
    layers, d = [], D
    for _ in range(L):
        layers.append([(rng.standard_normal(s) * 0.2).astype(np.float32)
                       for s in ((d, 4 * H), (H, 4 * H), (4 * H,))])
        d = H
    return layers, rng.standard_normal((B, T, D)).astype(np.float32)


def _bi_case(rng, n_gates, n_bias, B=3, T=9, D=16, H=24):
    shapes = ((D, n_gates * H), (H, n_gates * H)) + ((n_gates * H,),) * n_bias
    return ([[(rng.standard_normal(s) * 0.2).astype(np.float32) for s in shapes]
             for _ in range(2)], rng.standard_normal((B, T, D)).astype(np.float32))


def _jax_and_port(name, weights_np, x, grad):
    """(outputs and gradients of JAX's f32 route, of the port's dispatcher)
    under the loss sum(out * cos)."""
    if name == "ge2e_lstm":
        jfn = lambda w, xx: jlstm.lstm_stack_wavefront(  # noqa: E731
            [jlstm.LSTMParams(*p) for p in w], xx, compute_dtype=jnp.float32)[1]
        tfn = lambda w, xx: lstm_kernel.lstm_stack_seq(  # noqa: E731
            [LSTMParams(*p) for p in w], xx, torch.float32)[1]
    elif name == "bilstm":
        jfn = lambda w, xx: jlstm.bilstm_fused(  # noqa: E731
            jlstm.LSTMParams(*w[0]), jlstm.LSTMParams(*w[1]), xx, compute_dtype=jnp.float32)
        tfn = lambda w, xx: birnn_kernel.bilstm(  # noqa: E731
            LSTMParams(*w[0]), LSTMParams(*w[1]), xx, torch.float32)
    else:
        jfn = lambda w, xx: jgru.bigru_fused(  # noqa: E731
            jgru.GRUParams(*w[0]), jgru.GRUParams(*w[1]), xx, compute_dtype=jnp.float32)
        tfn = lambda w, xx: birnn_kernel.bigru(  # noqa: E731
            GRUParams(*w[0]), GRUParams(*w[1]), xx, torch.float32)
    jw = [tuple(map(jnp.asarray, p)) for p in weights_np]
    out_j = np.asarray(jfn(jw, jnp.asarray(x)))
    probe = np.cos(np.arange(out_j.size).reshape(out_j.shape) * 0.01).astype(np.float32)
    want = [out_j]
    if grad:
        gw, gx = jax.grad(lambda w, xx: (jfn(w, xx) * probe).sum(), argnums=(0, 1))(
            jw, jnp.asarray(x))
        want += [np.asarray(a) for p in gw for a in p] + [np.asarray(gx)]
    tw = [[torch.tensor(a, requires_grad=grad) for a in p] for p in weights_np]
    tx = torch.tensor(x, requires_grad=grad)
    out_t = tfn(tw, tx)
    got = [out_t.detach().numpy()]
    if grad:
        (out_t * torch.from_numpy(probe)).sum().backward()
        got += [a.grad.numpy() for p in tw for a in p] + [tx.grad.numpy()]
    return want, got


@pytest.mark.parametrize("grad", [False, True], ids=["inference", "autograd"])
@pytest.mark.parametrize("name", ["ge2e_lstm", "bilstm", "bigru"])
def test_f32_dispatch_runs_the_references_route(name, grad, kernel_path):
    rng = np.random.default_rng(len(name))
    w, x = (_stack_case(rng) if name == "ge2e_lstm"
            else _bi_case(rng, 4, 1) if name == "bilstm" else _bi_case(rng, 3, 2))
    want, got = _jax_and_port(name, w, x, grad)
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.shape == b.shape and _rel(a, b) <= F32_TOL
    assert not any(kernel_path.values()), kernel_path


def test_bf16_dispatch_still_takes_the_kernel_path(kernel_path):
    rng = np.random.default_rng(1)
    (wf, wb), x = _bi_case(rng, 3, 2, H=16)
    birnn_kernel.bigru(GRUParams(*map(torch.tensor, wf)), GRUParams(*map(torch.tensor, wb)),
                       torch.tensor(x), torch.bfloat16)
    assert kernel_path["bigru_recurrence"] == 1


def _tiny_hp():
    return tiny_test_hparams().replace(
        Decoder={"Prenet": {"Dropout_Rate": 0.0}},
        Encoder={"Conv": {"Dropout_Rate": 0.0}},
        Postnet={"Conv": {"Dropout_Rate": 0.0}},
        Linear_Head={"Type": "CBHG", "Conv": {"Dropout_Rate": 0.0}},
        Speaker_Embedding={"GE2E": {"Freeze": False}},
    )


@pytest.fixture(scope="module")
def reference():
    """JAX at tiny_test_hparams (f32, CBHG head, dropout 0, GE2E trainable):
    init, one teacher-forced forward and one train step on one batch."""
    hp_j = _tiny_hp()
    assert not hp_j.Train.Use_Mixed_Precision
    rng = np.random.default_rng(0)
    M, F = hp_j.Sound.Mel_Dim, hp_j.Sound.Spectrogram_Dim
    pats = [{"Tokens": rng.integers(1, 30, size=12 - 2 * i).astype(np.int32),
             "Mel": rng.random((21 - 4 * i, M)).astype(np.float32),
             "Ref_Mel": rng.random((30 - 9 * i, M)).astype(np.float32),
             "Spect": rng.random((21 - 4 * i, F)).astype(np.float32),
             "Speaker_ID": i} for i in range(3)]
    batch = collate_tts(pats, 12, 20, M, 1, hp_j.Speaker_Embedding.GE2E.Window_Length,
                        np.random.default_rng(1), F)
    models = jtrainer.build_models(hp_j)
    state = jtrainer.init_state(hp_j, models, jax.random.PRNGKey(0), batch)
    dev_batch = jax.tree.map(jnp.asarray, batch)
    spk = models.ge2e.apply({"params": state.params["ge2e"]}, dev_batch["ref_mels"])
    fwd = jax.jit(lambda p, bs, b, s: models.tacotron.apply(
        {"params": p, "batch_stats": bs}, b["tokens"], b["token_lengths"], b["mels"], s,
        False, rngs={"prenet": jax.random.PRNGKey(3)}))(
        state.params["tacotron"], state.batch_stats["tacotron"], dev_batch, spk)
    new_state, metrics = jax.jit(jtrainer.make_train_step(hp_j, models))(
        state, dev_batch, jax.random.PRNGKey(1))
    tree = jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats,
                                     "new_params": new_state.params})
    return {"hp": Recursive_Parse(hp_j.to_dict()), "batch": batch, **tree,
            "spk": np.asarray(spk), "forward": {k: np.asarray(v) for k, v in fwd.items()},
            "metrics": {k: float(v) for k, v in metrics.items()}}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", np.asarray(v)


def test_f32_forward_matches_jax(reference, kernel_path):
    """The f32 teacher-forced forward (GE2E included) on the CPU: every
    output within 1e-4 of its peak, the recurrences on the plain route."""
    ref = reference
    trainer = Trainer.from_params(ref["hp"], ref["params"], ref["batch_stats"], device="cpu")
    b = {k: torch.from_numpy(np.asarray(v)) for k, v in ref["batch"].items()}
    with torch.no_grad():
        spk = trainer.ge2e(b["ref_mels"])
        out = trainer.tacotron(b["tokens"].long(), b["token_lengths"].long(), b["mels"], spk)
    assert _rel(ref["spk"], spk.numpy()) <= F32_TOL
    for key, want in ref["forward"].items():
        assert _rel(want, out[key].numpy()) <= F32_TOL, key
    assert not any(kernel_path.values()), kernel_path


def test_f32_train_step_matches_jax(reference, kernel_path):
    ref = reference
    trainer = Trainer.from_params(ref["hp"], ref["params"], ref["batch_stats"], device="cpu")
    metrics = trainer.train_step(ref["batch"])
    assert metrics["skipped_nonfinite"] == 0.0
    for key, want in ref["metrics"].items():
        if key != "skipped_nonfinite":
            assert abs(metrics[key] - want) / max(abs(want), 1e-12) <= LOSS_TOL, key
    params, _ = weights.params_to_jax(trainer.state(), ref["hp"])
    got, want = dict(_leaves(params)), dict(_leaves(ref["new_params"]))
    assert got.keys() == want.keys()
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= PARAM_TOL, k
    assert not any(kernel_path.values()), kernel_path


def test_bf16_pallas_runs_on_an_f32_checkpoint(monkeypatch):
    """``quantize="bf16_pallas"`` on an f32 checkpoint runs (the JAX package
    allows it, rounding the gates to bf16): on the CPU through the decode
    kernel's plain version, the recurrences on the plain route. On the card
    ``chip_smoke.py`` pass (m) runs it with the kernel."""
    import pathlib

    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.inference import Synthesizer
    from multi_speaker_tts_tpu_torch.ops import decode_kernel

    root = pathlib.Path(__file__).resolve().parents[1]
    params, batch_stats, meta = load_compact(root / "demo" / "serving_ckpt.msgpack")
    hp = Recursive_Parse(meta["hp"]).replace(Train={"Use_Mixed_Precision": False})
    calls = []
    plain = decode_kernel.decode_segment_plain
    monkeypatch.setattr(decode_kernel, "decode_segment_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    synth = Synthesizer(hp, params, batch_stats, device="cpu", quantize="bf16_pallas")
    emb = synth.enroll([np.random.default_rng(0).normal(size=8192).astype(np.float32) * 0.1])
    out = synth.synthesize(["a short one.", "and another"], emb, max_steps=32, vocode=False)
    assert calls and all(o["mel_length"] > 0 and np.isfinite(o["mel"]).all() for o in out)
