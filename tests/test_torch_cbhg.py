"""The port's CBHG linear head against the JAX package, on the CPU: the GRU
primitives, the BiGRU's plain recurrence against the Pallas kernel in
interpret mode, ``Highway`` / ``CBHG`` / ``CBHGHead`` / ``LinearHead``
against the flax modules (``model.init`` parameters carried over by
``params_from_jax``), and ``Tacotron.infer`` with a CBHG head."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.models import cbhg as jcbhg
from multi_speaker_tts_tpu.models import layers as jlayers
from multi_speaker_tts_tpu.models import tacotron as jtaco
from multi_speaker_tts_tpu.ops import birnn_pallas
from multi_speaker_tts_tpu.ops import gru as jgru
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.models import cbhg, layers, tacotron
from multi_speaker_tts_tpu_torch.ops import birnn_kernel, gru
from multi_speaker_tts_tpu_torch.weights import load_into, params_from_jax

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

# f32 on both sides: sums in another order only.
F32_TOL = 1e-4
HEAD = "tacotron.linear_head."


def _gru_params(rng, D, H, scale=0.3):
    shapes = ((D, 3 * H), (H, 3 * H), (3 * H,), (3 * H,))
    arrays = [(rng.standard_normal(s) * scale).astype(np.float32) for s in shapes]
    return (jgru.GRUParams(*map(jnp.asarray, arrays)),
            gru.GRUParams(*map(torch.from_numpy, arrays)))


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_matches(reverse):
    rng = np.random.default_rng(0)
    jp, tp = _gru_params(rng, 6, 8)
    x = rng.standard_normal((3, 11, 6)).astype(np.float32)
    want, want_h = jgru.gru(jp, jnp.asarray(x), reverse=reverse)
    got, got_h = gru.gru(tp, torch.from_numpy(x), reverse=reverse)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5
    assert np.abs(got_h.numpy() - np.asarray(want_h)).max() <= 1e-5


def test_gru_cell_step_matches():
    rng = np.random.default_rng(1)
    jp, tp = _gru_params(rng, 5, 8)
    gx = rng.standard_normal((4, 24)).astype(np.float32)
    h = rng.standard_normal((4, 8)).astype(np.float32)
    want = jgru.gru_cell_step(jp, jnp.asarray(gx), jnp.asarray(h))
    got = gru.gru_cell_step(tp, torch.from_numpy(gx), torch.from_numpy(h))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-5


def test_bigru_fused_matches_and_equals_the_kernel_path_in_f32():
    rng = np.random.default_rng(2)
    (jf, tf), (jb, tb) = _gru_params(rng, 6, 8), _gru_params(rng, 6, 8)
    x = rng.standard_normal((3, 13, 6)).astype(np.float32)
    want = np.asarray(jgru.bigru_fused(jf, jb, jnp.asarray(x)))
    got = gru.bigru_fused(tf, tb, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (3, 13, 16)
    assert np.abs(got - want).max() <= 1e-5
    # Hoisted gates + recurrence (the kernel path's plain version) in f32
    # is the same function.
    via_hoist = birnn_kernel.bigru(tf, tb, torch.from_numpy(x), torch.float32).numpy()
    assert np.abs(via_hoist - want).max() <= 1e-5


@pytest.mark.parametrize("B", [3, 8])
def test_bigru_plain_matches_the_pallas_kernel_in_interpret_mode(B):
    """bf16 hoisted gates, bf16 operand h, f32 carry, bf16 outputs on both
    sides; 5e-3 is the JAX package's own ``bigru_pallas_vs_fused`` gate (a
    bf16 output ulp near 1 is 4e-3)."""
    rng = np.random.default_rng(B)
    H, T, D = 128, 24, 128
    (jf, tf), (jb, tb) = _gru_params(rng, D, H, 0.1), _gru_params(rng, D, H, 0.1)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    want = np.asarray(birnn_pallas.bigru_pallas(jf, jb, jnp.asarray(x), jnp.bfloat16,
                                                interpret=True))
    before = birnn_kernel.GRU_KERNEL.launches
    got = birnn_kernel.bigru(tf, tb, torch.from_numpy(x), torch.bfloat16).numpy()
    assert birnn_kernel.GRU_KERNEL.launches == before  # a CPU tensor launches nothing
    assert got.shape == want.shape == (B, T, 2 * H)
    assert np.abs(got - want).max() <= 5e-3


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _randomized(variables, rng):
    """``model.init`` variables with every leaf perturbed, so biases, BatchNorm
    scales and running statistics are not at their trivial initial values."""
    params = jax.tree.map(
        lambda a: np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1,
        _np_tree(variables["params"]))
    stats = jax.tree.map(
        lambda a: np.abs(np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.2)
        + 0.1, _np_tree(variables.get("batch_stats", {})))
    return params, stats


def _nest(path, tree):
    for key in reversed(path.split("/")):
        tree = {key: tree}
    return tree


HEAD_HP = Recursive_Parse({"Linear_Head": {"Use": True}})


def _load(module, params, stats, jax_path, port_prefix):
    """Carry a flax subtree rooted at ``jax_path`` into ``module``."""
    state = params_from_jax(_nest(jax_path, params), _nest(jax_path, stats) if stats else {},
                            HEAD_HP)
    load_into(module, state, port_prefix)
    return module


def test_highway_matches():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    model = jlayers.Highway(16)
    params, _ = _randomized(model.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = np.asarray(model.apply({"params": params}, jnp.asarray(x)))
    port = _load(layers.Highway(16), params, None, "tacotron/linear_head/cbhg/highway_0",
                 HEAD + "cbhg.highways.0.")
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= 1e-5


# (Bank_K, highway size): an even and an odd bank (even kernels pad one more
# frame on the right); 24 != mel 16 brings in ``pre_highway``.
CBHG_CASES = [(4, 16), (3, 24)]


def _cbhg_pair(bank_k, highway, rng, dtype, with_head):
    kw = dict(bank_k=bank_k, bank_channels=16, projection_channels=16, highway_layers=2,
              highway_size=highway, gru_size=16)
    x = rng.standard_normal((2, 21, 16)).astype(np.float32)
    if with_head:
        model = jcbhg.CBHGHead(spect_dim=33, compute_dtype=dtype, **kw)
        port, path, prefix = cbhg.CBHGHead(16, 33, **kw), "tacotron/linear_head", HEAD
    else:
        model = jcbhg.CBHG(compute_dtype=dtype, **kw)
        port, path, prefix = cbhg.CBHG(16, **kw), "tacotron/linear_head/cbhg", HEAD + "cbhg."
    params, stats = _randomized(model.init(jax.random.PRNGKey(1), jnp.asarray(x)), rng)
    want = np.asarray(model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    _load(port, params, stats, path, prefix)
    return port, x, want


@pytest.mark.parametrize("bank_k, highway", CBHG_CASES)
@pytest.mark.parametrize("with_head", [False, True], ids=["CBHG", "CBHGHead"])
def test_cbhg_matches_f32(bank_k, highway, with_head):
    rng = np.random.default_rng(10 * bank_k + with_head)
    port, x, want = _cbhg_pair(bank_k, highway, rng, jnp.float32, with_head)
    assert (port.cbhg if with_head else port).pre_highway is None or highway != 16
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.float32).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= F32_TOL


@pytest.mark.parametrize("bank_k, highway", CBHG_CASES)
def test_cbhg_head_matches_bf16(bank_k, highway):
    """Mixed precision: the convolutions round as flax does, so they agree
    to a bf16 ulp or two; the port's BiGRU rounds its hoisted gates to bf16
    (the kernel path) where the JAX package on the CPU keeps them f32
    (``bigru_fused``). Measured max difference 3.8e-3 on outputs of
    magnitude ~2; 2e-2 is one bf16 ulp there and leaves room for other
    draws."""
    rng = np.random.default_rng(20 + bank_k)
    port, x, want = _cbhg_pair(bank_k, highway, rng, jnp.bfloat16, True)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.bfloat16).numpy()
    assert np.abs(got - want).max() <= 2e-2
    assert np.abs(want).max() > 0.3


@pytest.mark.parametrize("dtype, tol", [(jnp.float32, F32_TOL), (jnp.bfloat16, 5e-2)],
                         ids=["f32", "bf16"])
def test_conv_linear_head_matches(dtype, tol):
    """The Conv variant; its projection runs in the compute dtype. bf16:
    one output ulp at magnitude ~4 is 3e-2."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 17, 16)).astype(np.float32)
    model = jtaco.LinearHead(spect_dim=33, conv_stacks=2, conv_channels=32,
                             conv_kernel_size=5, compute_dtype=dtype)
    params, stats = _randomized(model.init(jax.random.PRNGKey(2), jnp.asarray(x)), rng)
    want = np.asarray(model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))
    port = _load(tacotron.LinearHead(16, 33, 2, 32, 5), params, stats,
                 "tacotron/linear_head", HEAD)
    torch_dtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch_dtype).numpy()
    assert np.abs(got - want).max() <= tol


def test_tacotron_infer_with_cbhg_head_matches(tiny_hp):
    """``linear`` against the JAX ``infer`` (f32, dropout 0). The head runs
    on the postnet output over the whole decode bucket and is masked
    afterwards: were it fed the masked mel, or only the decoded frames, the
    frames next to each utterance's end would differ."""
    over = dict(Linear_Head={"Type": "CBHG"}, Decoder={"Prenet": {"Dropout_Rate": 0.0}},
                Speaker_Embedding={"Type": None})
    jhp = tiny_hp.replace(**over)
    hp = Recursive_Parse(jhp.to_dict())
    rng = np.random.default_rng(5)
    tokens = rng.integers(1, 30, (2, 9)).astype(np.int32)
    lengths = np.asarray([9, 6], np.int32)
    model = jtaco.Tacotron.from_hp(jhp)
    variables = model.init({"params": jax.random.PRNGKey(3), "prenet": jax.random.PRNGKey(4)},
                           jnp.asarray(tokens), jnp.asarray(lengths), None, 16, 0.5,
                           method=model.infer)
    params, stats = _randomized(variables, rng)
    # Stop logits that cross the threshold inside the bucket, at different
    # steps per row: a steep ramp on the stop bias is not available, so the
    # threshold is taken from the logits themselves (fixed-length pass).
    apply = lambda th, early: model.apply(  # noqa: E731
        {"params": params, "batch_stats": stats}, jnp.asarray(tokens), jnp.asarray(lengths),
        None, 16, th, early, method=model.infer, rngs={"prenet": jax.random.PRNGKey(4)})
    probs = np.asarray(jax.nn.sigmoid(apply(0.5, False)["stop_logits"]))
    th = float((probs[:, 3:9].max(axis=1).min() + probs[:, :3].max()) / 2)
    want = apply(th, True)
    want_len = np.asarray(want["mel_lengths"])

    port = tacotron.Tacotron(hp)
    load_into(port, params_from_jax({"tacotron": params}, {"tacotron": stats}, hp), "tacotron.")
    got = port.infer(torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long(), None,
                     16, th)
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), want_len)
    lin, lin_want = got["linear"].numpy(), np.asarray(want["linear"])
    assert lin.shape == lin_want.shape == (2, 16, 129)
    for i, n in enumerate(want_len):
        assert np.abs(lin[i, :n] - lin_want[i, :n]).max() <= F32_TOL  # inside
        assert np.abs(lin[i, n:] - lin_want[i, n:]).max(initial=0.0) <= F32_TOL  # outside
    assert np.abs(got["mel_post"].numpy() - np.asarray(want["mel_post"])).max() <= F32_TOL
    # The fixed-length decode (lengths from the first stop logit over the
    # threshold) against the JAX one.
    want_fixed = apply(th, False)
    fixed = port.infer(torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long(), None,
                       16, th, early_exit=False)
    np.testing.assert_array_equal(fixed["mel_lengths"].numpy(),
                                  np.asarray(want_fixed["mel_lengths"]))
    for key in ("stop_logits", "mel_post", "linear"):
        assert np.abs(fixed[key].numpy() - np.asarray(want_fixed[key])).max() <= F32_TOL, key
    if want_len.min() < 16:
        # The trap, made visible: the head on the masked mel differs inside.
        i, n = int(want_len.argmin()), int(want_len.min())
        masked = port.linear_head(got["mel_post"], torch.float32).detach().numpy()
        assert np.abs(masked[i, :n] - lin_want[i, :n]).max() > 10 * F32_TOL


@pytest.mark.parametrize("H, B, ok", [
    (128, 4, True), (128, 32, True), (64, 17, True), (16, 1, True), (48, 40, True),
    (144, 4, True), (192, 4, True), (208, 4, True), (256, 32, True), (1024, 32, True),
    (1248, 4, True), (1264, 4, True), (4096, 4, True),
    (8, 4, False), (72, 4, False), (200, 4, False), (4896, 4, False),
])
def test_bigru_kernel_shape_rule(H, B, ok):
    """``csrc/bigru.cu`` takes H % 16 == 0 and 16 <= H <= 192 (one
    direction's W_hh in a block's registers and shared memory) and
    ``csrc/bigru_wide.cu`` every H % 16 above, up to what one row's launch
    fits on an H100 (4,880, the W_hh slice partly streamed), any T and B;
    the reason names the rule otherwise."""
    reason = birnn_kernel.bigru_shape_reason((400, B, 3 * H), [(H, 3 * H)] * 2)
    assert (reason is None) == ok
    if not ok:
        assert "H % 16 == 0 and 16 <= H <= 4880" in reason


def test_bigru_kernel_shape_rule_checks_the_weights():
    assert "weights" in birnn_kernel.bigru_shape_reason((4, 2, 384), [(128, 384), (128, 256)])
    assert "gates" in birnn_kernel.bigru_shape_reason((4, 0, 384), [(128, 384)] * 2)


@pytest.mark.parametrize("residuals", [False, True])
def test_bigru_kernel_refuses_cpu_tensors(residuals):
    """The kernel entry raises on CPU tensors before anything reaches a card,
    and counts no launch in either mode."""
    p = gru.GRUParams(torch.zeros(8, 48), torch.zeros(16, 48), torch.zeros(48), torch.zeros(48))
    g = torch.zeros(3, 2, 48, dtype=torch.bfloat16)
    kernels = (birnn_kernel.GRU_KERNEL, birnn_kernel.GRU_RES_KERNEL)
    before = [k.launches for k in kernels]
    with pytest.raises(ValueError, match="CUDA"):
        birnn_kernel.bigru_recurrence_kernel(g, g, p, p, residuals)
    assert [k.launches for k in kernels] == before
