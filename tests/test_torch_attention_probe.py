"""The attention-step probe of the port (``tools/attention_probe.py`` and
``ops/attention_step_kernel.py``, plain version on the CPU) against the
JAX probe: its fused Pallas step ``_fused_attn_kernel`` in interpret mode,
``decoder_scan._attention_block`` + the context einsum, and its XLA loop.
Inputs come from numpy and go to both packages. ``tools/`` is no package,
so the JAX probe is loaded from its file."""

import argparse
import importlib.util
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from jax.experimental import pallas as pl

from multi_speaker_tts_tpu.ops import decoder_scan as jdscan
from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask
from multi_speaker_tts_tpu_torch.ops.decoder_scan import AttentionParams
from multi_speaker_tts_tpu_torch.tools import attention_probe as probe

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("jax_attention_probe",
                                               ROOT / "tools" / "attention_probe.py")
JT = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(JT)

B, S, A, D, H, K, C = 4, 12, 16, 32, 64, 31, 8
HALF = (K - 1) // 2
# f32 on both sides; only the order of the sums differs.
TOL = 1e-5


def _inputs(seed: int, masked: bool) -> dict:
    """Weights at scale 0.5 (energies of order 1, so the softmax is far from
    uniform), previous weights a softmax, cumulative weights above them; the
    masked case zeroes the last third of every row."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return (rng.normal(size=shape) * 0.5).astype(np.float32)

    x = {"wq": f(H, A), "conv_kernel": f(K, 2, C), "wloc": f(C, A), "v": f(A, 1),
         "keys": f(B, S, A), "memory": f(B, S, D), "h0": f(B, H)}
    e = np.exp(rng.normal(size=(B, S)))
    x["w"] = (e / e.sum(-1, keepdims=True)).astype(np.float32)
    x["cum"] = (x["w"] + rng.uniform(0.0, 2.0, size=(B, S))).astype(np.float32)
    x["mask"] = np.ones((B, S), np.float32)
    if masked:
        x["mask"][:, 2 * S // 3:] = 0.0
    return x


def _pad(a):
    return np.pad(a, ((0, 0), (HALF, K - 1 - HALF)))


def _port(x):
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    ap = AttentionParams(t["wq"], t["conv_kernel"], t["wloc"], t["v"])
    return t, ap


def _jax_ap(x):
    return jdscan.AttentionParams(wq=jnp.asarray(x["wq"]), conv_kernel=jnp.asarray(x["conv_kernel"]),
                                  wloc=jnp.asarray(x["wloc"]), v=jnp.asarray(x["v"]))


def _plain_step(x):
    t, ap = _port(x)
    maskadd = ask.maskadd_of(t["mask"])
    return ask.attention_step_plain(t["h0"], torch.from_numpy(_pad(x["w"])),
                                    torch.from_numpy(_pad(x["cum"])), t["keys"], t["memory"],
                                    maskadd, ap)


def _close(got, want, tol=TOL):
    for g, w, name in zip(got, want, ("w", "cum", "ctx")):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0, atol=tol, err_msg=name)


CASES = [(0, False), (1, False), (0, True), (2, True)]
IDS = ["seed0", "seed1", "seed0-masked", "seed2-masked"]


@pytest.mark.parametrize("seed, masked", CASES, ids=IDS)
def test_plain_step_matches_the_fused_pallas_kernel(seed, masked):
    """``_fused_attn_kernel`` in interpret mode, whole arrays as its blocks
    (the output shapes of ``make_pallas_loop``)."""
    x = _inputs(seed, masked)
    maskadd = np.where(x["mask"] > 0, 0.0, -1e9).astype(np.float32)
    step = pl.pallas_call(
        JT._fused_attn_kernel,
        out_shape=[jax.ShapeDtypeStruct((B, S), jnp.float32),
                   jax.ShapeDtypeStruct((B, S), jnp.float32),
                   jax.ShapeDtypeStruct((B, D), jnp.float32)],
        interpret=True,
    )
    want = step(x["h0"], _pad(x["w"]), _pad(x["cum"]), x["keys"], x["memory"], maskadd,
                x["wq"], x["conv_kernel"], x["wloc"], x["v"])
    got = _plain_step(x)
    _close(got, want)
    np.testing.assert_array_equal(ask.maskadd_of(torch.from_numpy(x["mask"])).numpy(), maskadd)
    if masked:
        assert float(got[0][:, 2 * S // 3:].abs().max()) == 0.0


@pytest.mark.parametrize("seed, masked", CASES, ids=IDS)
def test_plain_step_matches_attention_block_and_einsum(seed, masked):
    x = _inputs(seed, masked)
    w, cum = jdscan._attention_block(jnp.asarray(x["h0"]), jnp.asarray(x["w"]),
                                     jnp.asarray(x["cum"]), jnp.asarray(x["keys"]), _jax_ap(x),
                                     jnp.asarray(x["mask"]))
    ctx = jnp.einsum("bs,bsd->bd", w, jnp.asarray(x["memory"]))
    _close(_plain_step(x), (w, cum, ctx))


def _loop_inputs(seed: int, masked: bool):
    x = _inputs(seed, masked)
    x["w"] = np.zeros((B, S), np.float32)
    x["w"][:, 0] = 1.0
    x["cum"] = x["w"].copy()
    return x


@pytest.mark.parametrize("make", [probe.make_plain_loop, probe.make_kernel_loop],
                         ids=["plain", "kernel"])
@pytest.mark.parametrize("seed, masked", CASES[:3], ids=IDS[:3])
def test_loops_match_make_xla_loop(make, seed, masked):
    """Five dependent steps (D <= H, so the context folds into h). On the
    CPU the kernel loop runs the fused step's plain version."""
    x = _loop_inputs(seed, masked)
    want = JT.make_xla_loop(_jax_ap(x), jnp.asarray(x["keys"]), jnp.asarray(x["memory"]),
                            jnp.asarray(x["mask"]), 5)(
        jnp.asarray(x["h0"]), jnp.asarray(x["w"]), jnp.asarray(x["cum"]))
    t, ap = _port(x)
    got = make(ap, t["keys"], t["memory"], t["mask"], 5)(t["h0"], t["w"], t["cum"])
    _close(got, want)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch():
    x = _inputs(3, True)
    t, ap = _port(x)
    args = (t["h0"], torch.from_numpy(_pad(x["w"])), torch.from_numpy(_pad(x["cum"])),
            t["keys"], t["memory"], ask.maskadd_of(t["mask"]), ap)
    before = ask.KERNEL.launches
    got = ask.attention_step(*args)
    assert ask.KERNEL.launches == before
    for g, w in zip(got, ask.attention_step_plain(*args)):
        assert torch.equal(g, w)


def test_kernel_entry_refuses_cpu_tensors():
    args = probe.parser().parse_args(["-B", "2", "-S", "8", "-A", "32", "-D", "32", "-H", "64"])
    ap, keys, memory, mask, h0, w0, cum0 = probe.probe_inputs(args, 0, "cpu")
    borders = (15, 15)
    before = ask.KERNEL.launches
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        ask.attention_step_kernel(h0, F.pad(w0, borders), F.pad(cum0, borders), keys, memory,
                                  ask.maskadd_of(mask), ap)
    assert ask.KERNEL.launches == before


@pytest.mark.parametrize("S_, A_, D_, C_, match", [
    (257, 128, 512, 32, "at most 256 memory positions"),
    (100, 48, 512, 32, "multiple of 32"),
    (100, 544, 512, 32, "up to 512"),
    (100, 128, 520, 32, "memory width"),
    (100, 128, 512, 33, "location channels"),
    (100, 128, 65536, 32, "bytes of shared memory"),
])
def test_shape_reason_refuses(S_, A_, D_, C_, match):
    reason = ask.shape_reason(S_, A_, D_, C_)
    assert reason is not None and match in reason


@pytest.mark.parametrize("S_, A_, D_, B_", [
    (100, 128, 512, 96), (100, 128, 512, 7), (100, 128, 512, 1),
    (64, 128, 768, 32), (256, 512, 1024, 5),
])
def test_shape_reason_takes_the_probe_and_train_shapes(S_, A_, D_, B_):
    """Every width the first design took, and a launch plan that fits a
    block's shared memory at any batch, at 16 clusters on the card."""
    assert ask.shape_reason(S_, A_, D_, 32) is None
    plan = ask.kernel_plan(B_, S_, A_, D_, 31, 32, 16)
    assert plan is not None and plan["smem"] <= ask.SMEM_LIMIT
    assert plan["R"] * plan["clusters"] >= B_ > plan["R"] * (plan["clusters"] - 1)


def test_kernel_plan_at_the_probe_shape():
    """At the probe's shape on 16 clusters: 6 rows a cluster, 128 blocks,
    five of a block's six memory chunks in flight from the start."""
    plan = ask.kernel_plan(96, 100, 128, 512, 31, 32, 16)
    assert (plan["R"], plan["blocks"], plan["chunk"], plan["slots"]) == (6, 128, 13, 5)
    assert ask.smem_bytes(100, 128, 512, 31, 32, 6, 13, 5) == plan["smem"]


class _Stop(Exception):
    pass


def test_probe_defaults_match_the_jax_tool(monkeypatch):
    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen.update(vars(real(self, [])))
        raise _Stop

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(_Stop):
        JT.main()
    monkeypatch.undo()
    ours = vars(probe.parser().parse_args([]))
    assert seen == {k: ours[k] for k in seen} and set(ours) - set(seen) == {"device"}
    assert ours["device"] is None  # resolve_device: the card, or raise


def test_probe_inputs_are_the_jax_mains_draws(monkeypatch):
    """The JAX ``main`` under seed 0, stopped at its first timing: every
    array it drew equals :func:`probe_inputs`'s."""
    seen = {}

    def fake_loop(ap, keys, memory, mask, n_iters):
        seen.update(ap=ap, keys=keys, memory=memory, mask=mask)
        return None

    def fake_time(fn, h0, w0, cum0):
        seen.update(h0=h0, w0=w0, cum0=cum0)
        raise _Stop

    argv = ["-B", "3", "-S", "10", "-A", "16", "-D", "24", "-H", "40"]
    monkeypatch.setattr(JT, "make_xla_loop", fake_loop)
    monkeypatch.setattr(JT, "time_loop", fake_time)
    monkeypatch.setattr(sys, "argv", ["attention_probe.py", *argv])
    with pytest.raises(_Stop):
        JT.main()
    ap, keys, memory, mask, h0, w0, cum0 = probe.probe_inputs(probe.parser().parse_args(argv),
                                                               0, "cpu")
    for got, want in ((ap.wq, seen["ap"].wq), (ap.conv_kernel, seen["ap"].conv_kernel),
                      (ap.wloc, seen["ap"].wloc), (ap.v, seen["ap"].v), (keys, seen["keys"]),
                      (memory, seen["memory"]), (mask, seen["mask"]), (h0, seen["h0"]),
                      (w0, seen["w0"]), (cum0, seen["cum0"])):
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_probe_runs_on_the_cpu_when_asked(capsys):
    probe.main(["-B", "2", "-S", "8", "-A", "32", "-D", "32", "-H", "64", "-iters", "3",
                "-device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device: cpu")
    assert [line.split(":")[0].strip() for line in out[1:3]] == ["plain", "kernel"]
    assert all(line.endswith("0.00e+00") for line in out[3:6])  # the same plain step
    assert out[-1].startswith("verdict: kernel/plain = ")


def test_probe_refuses_to_guess_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe.main(["-B", "2", "-S", "8", "-iters", "1"])


def test_stamp_tool_finds_every_phase_in_the_kernel_source():
    """tools/attention_stamps.py stamps the kernel at its phase anchors: each
    is in csrc/attention_step.cu once, so the tool measures this kernel."""
    from multi_speaker_tts_tpu_torch.ops import _build
    from multi_speaker_tts_tpu_torch.tools import attention_stamps

    text = attention_stamps.stamped_source((_build.CSRC / "attention_step.cu").read_text())
    assert text.count("MSTTS_STAMP(") == len(attention_stamps.ANCHORS) + 2 + 1  # + the macro
    with pytest.raises(ValueError, match="anchor not found"):
        attention_stamps.stamped_source("#include \"common.cuh\"\n")
