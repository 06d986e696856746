"""The torch port as a package: it imports without JAX, imports nothing of
the JAX package or its top-level ``tools/``, refuses to guess a device, reads the compact checkpoints
without msgpack/flax, and carries every used tensor across exactly once."""

import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.hparams import Recursive_Parse as JaxRecursiveParse
from multi_speaker_tts_tpu.train.checkpoints import load_compact as jax_load_compact
from multi_speaker_tts_tpu_torch import checkpoints, weights
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.inference import Synthesizer, resolve_device
from multi_speaker_tts_tpu_torch.models.ge2e import GE2E
from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "multi_speaker_tts_tpu_torch"
CKPTS = ["demo/serving_ckpt.msgpack", "demo/serving_ckpt_full.msgpack"]


def _port_modules():
    return sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_port_imports_with_jax_blocked():
    """Every module of the port imports in a process where ``import jax``
    (and flax, msgpack, yaml) fails."""
    code = (
        "import sys\n"
        "for name in ('jax', 'jaxlib', 'flax', 'msgpack', 'yaml', 'tools'):\n"
        "    sys.modules[name] = None\n"
        "import importlib\n"
        f"for mod in {_port_modules()!r}:\n"
        "    importlib.import_module(mod)\n"
        "assert not any(m == 'multi_speaker_tts_tpu' or m.startswith('multi_speaker_tts_tpu.')"
        " for m in sys.modules), 'JAX package imported'\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")), ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    banned = ("jax", "jaxlib", "flax", "multi_speaker_tts_tpu", "tools")
    for node in ast.walk(ast.parse(path.read_text())):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names = [node.module]
        for name in names:
            top = name.split(".")[0]
            assert top not in banned, f"{path.name} imports {name}"


def test_synthesizer_needs_an_explicit_cpu_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Synthesizer.from_compact(str(ROOT / CKPTS[0]),
                                 hp=_mel_only_hp(str(ROOT / CKPTS[0])))
    assert resolve_device("cpu") == torch.device("cpu")


def _mel_only_hp(path):
    _, _, meta = checkpoints.load_compact(path)
    return Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False})


def _same_tree(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), where
        for k in a:
            _same_tree(a[k], b[k], f"{where}/{k}")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


@pytest.mark.parametrize("path", CKPTS)
def test_msgpack_reader_equals_flax_loader(path):
    ours = checkpoints.load_compact(ROOT / path)
    theirs = jax_load_compact(ROOT / path)
    for a, b in zip(theirs, ours):
        _same_tree(a, b)


def test_msgpack_reader_scalar_types():
    """The subset flax writes beyond arrays: ints of every width, floats,
    nil/bool, str and bin of every length class."""
    import flax.serialization as fs

    tree = {"i": [0, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -33, -129,
                  -32769, -2**31 - 1], "f": 1.5, "n": None, "t": True,
            "s": "x" * 40, "b": b"y" * 300, "a": np.arange(6, dtype=np.int32).reshape(2, 3),
            "h": np.float16(2.5), "z": {"d": -2.25e300}}
    got = checkpoints.unpackb(fs.msgpack_serialize(tree))
    want = fs.msgpack_restore(fs.msgpack_serialize(tree))
    assert got.keys() == want.keys()
    for k in tree:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(got[k], want[k])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("path", CKPTS)
def test_checkpoint_with_its_linear_head_maps_every_tensor_once(path):
    """The checkpoints as they are (Conv head in the small one, CBHG in the
    full one): every tensor of both trees lands in the state exactly once,
    and the state fills ``Tacotron`` and ``GE2E`` strictly."""
    params, batch_stats, meta = jax_load_compact(ROOT / path)
    hp = Recursive_Parse(meta["hp"])
    assert hp.Linear_Head.Use and weights.unused_subtrees(hp) == set()
    state = weights.params_from_jax(params, batch_stats, hp)
    n_leaves = sum(1 for _ in _leaves(params)) + sum(1 for _ in _leaves(batch_stats))
    assert len(state) == n_leaves
    taco = Tacotron(hp)
    weights.load_into(taco, state, "tacotron.")  # strict: nothing missing, nothing left over
    head = params["tacotron"]["linear_head"]
    if hp.Linear_Head.Type == "CBHG":
        np.testing.assert_array_equal(
            taco.linear_head.cbhg.gru.backward_dir.b_hh.detach().numpy(),
            head["cbhg"]["gru"]["backward"]["b_hh"])
        np.testing.assert_array_equal(
            taco.linear_head.cbhg.bank[7].weight.detach().numpy(),
            np.transpose(head["cbhg"]["bank_7"]["Conv_0"]["kernel"], (2, 1, 0)))
        np.testing.assert_array_equal(
            taco.linear_head.cbhg.highways[3].T.bias.detach().numpy(),
            head["cbhg"]["highway_3"]["T"]["bias"])
        assert taco.linear_head.cbhg.bank[1].bn_var.shape == (128,)
    else:
        np.testing.assert_array_equal(taco.linear_head.projection.kernel.detach().numpy(),
                                      head["projection"]["kernel"])
    ge2e = GE2E.from_hp(hp, torch.float32)
    weights.load_into(ge2e, state, "ge2e.")


@pytest.mark.parametrize("path", CKPTS)
def test_checkpoint_maps_every_used_tensor_once(path):
    params, batch_stats, meta = jax_load_compact(ROOT / path)
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False})
    assert weights.unused_subtrees(hp) == {"tacotron/linear_head"}
    state = weights.params_from_jax(params, batch_stats, hp)
    with torch.device("meta"):
        ge2e = GE2E.from_hp(hp, torch.float32)
        taco = Tacotron(hp)
    expected = {f"ge2e.{k}": v for k, v in ge2e.state_dict().items()}
    expected |= {f"tacotron.{k}": v for k, v in taco.state_dict().items()}
    assert set(state) == set(expected)
    for key, value in state.items():
        assert value.shape == tuple(expected[key].shape), key
    # Every checkpoint tensor outside the unused linear head is in `state`.
    n_leaves = sum(1 for _ in _leaves(params)) + sum(1 for _ in _leaves(batch_stats))
    n_head = sum(1 for _ in _leaves(params["tacotron"]["linear_head"]))
    n_head += sum(1 for _ in _leaves(batch_stats["tacotron"].get("linear_head", {})))
    assert len(state) == n_leaves - n_head


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def test_mapping_refuses_unknown_and_linear_head_configs():
    params, batch_stats, meta = jax_load_compact(ROOT / CKPTS[0])
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False})
    extra = dict(params, ge2e=dict(params["ge2e"], stray={"kernel": np.zeros(3)}))
    with pytest.raises(ValueError, match="ge2e/stray/kernel"):
        weights.params_from_jax(extra, batch_stats, hp)
    # With the linear head in the config its subtree is no longer skipped: a
    # tensor there that no rule knows is refused too, and a head the
    # hparams do not describe (CBHG asked, Conv stored) does not load.
    head = params["tacotron"]["linear_head"]
    stray = dict(params, tacotron=dict(params["tacotron"],
                                       linear_head=dict(head, extra={"kernel": np.zeros(3)})))
    with pytest.raises(ValueError, match="linear_head/extra/kernel"):
        weights.params_from_jax(stray, batch_stats, Recursive_Parse(meta["hp"]))
    cbhg_hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Type": "CBHG"})
    state = weights.params_from_jax(params, batch_stats, cbhg_hp)
    with pytest.raises(ValueError, match="missing"):
        weights.load_into(Tacotron(cbhg_hp), state, "tacotron.")


def test_hparams_copy_matches_the_jax_package():
    _, _, meta = jax_load_compact(ROOT / CKPTS[0])
    ours = Recursive_Parse(meta["hp"]).replace(Decoder={"Prenet": {"Dropout_Rate": 0.0}})
    theirs = JaxRecursiveParse(meta["hp"]).replace(Decoder={"Prenet": {"Dropout_Rate": 0.0}})
    assert ours.to_dict() == theirs.to_dict()
    assert ours.Decoder.Prenet.Sizes == [64, 64]
    assert ours.Decoder.get("missing", 3) == 3


def test_text_frontend_copy_matches_the_jax_package():
    from multi_speaker_tts_tpu import text as jax_text
    from multi_speaker_tts_tpu_torch import text as port_text

    hp = _mel_only_hp(str(ROOT / CKPTS[0]))
    for s in ["Hello, Dr. Smith: 42 apples!", "  the  QUICK brown fox; 1999 "]:
        np.testing.assert_array_equal(port_text.encode_text(s, hp),
                                      jax_text.encode_text(s, hp))
    assert port_text.vocab_size(hp) == jax_text.vocab_size(hp)
    assert port_text.PAD_ID == jax_text.PAD_ID


def test_cpu_wrappers_never_count_launches():
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.ops.gru import GRUParams
    from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

    rng = np.random.default_rng(0)
    p = LSTMParams(*(torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
                     for s in ((8, 32), (8, 32), (32,))))
    g = GRUParams(*(torch.from_numpy(rng.normal(size=s).astype(np.float32) * 0.1)
                    for s in ((8, 24), (8, 24), (24,), (24,))))
    kernels = (lstm_kernel.KERNEL, birnn_kernel.KERNEL, birnn_kernel.GRU_KERNEL)
    before = [k.launches for k in kernels]
    lstm_kernel.lstm_stack_seq([p], torch.randn(2, 5, 8))
    birnn_kernel.bilstm(p, p, torch.randn(2, 5, 8))
    birnn_kernel.bigru(g, g, torch.randn(2, 5, 8))
    assert [k.launches for k in kernels] == before


def test_new_kernel_sources_carry_their_provenance():
    """Each hand-written source names the TPU function it replaces."""
    for source, replaces in (("bigru.cu", "birnn_pallas.py::_bigru_fwd_impl"),
                             ("decode.cu", "decode_pallas.py::decode_segment_pallas"),
                             ("lstm_bwd.cu", "lstm_pallas.py::lstm_seq_layer_bwd"),
                             ("bilstm_bwd.cu", "birnn_pallas.py::_bilstm_vjp_bwd"),
                             ("bigru_bwd.cu", "birnn_pallas.py::_bigru_vjp_bwd"),
                             ("griffin_lim_dense.cu", "griffin_lim_kernel.py::griffin_lim_pallas"),
                             ("griffin_lim.cu", "griffin_lim_staged.py::griffin_lim_staged"),
                             ("attention_step.cu", "attention_probe.py::make_pallas_loop")):
        text = (PORT / "csrc" / source).read_text()
        assert replaces in text and "MSTTS_EXPORT" in text
        assert "cudaGetLastError" in (PORT / "csrc" / "common.cuh").read_text()


@pytest.mark.parametrize("header, replaces", [
    ("lstm_persistent.cuh", ("lstm_pallas.py::lstm_seq_layer_fwd",
                             "birnn_pallas.py::_bilstm_fwd_impl")),
    ("lstm_bwd.cuh", ("lstm_pallas.py::lstm_seq_layer_bwd", "birnn_pallas.py::_bilstm_vjp_bwd")),
])
def test_lstm_kernels_step_on_tensor_cores(header, replaces):
    """The persistent LSTM kernels name the TPU functions they replace and
    compute their step products with mma.sync: no CUDA-core dot-product
    loop (fmaf) is left in them."""
    text = (PORT / "csrc" / header).read_text()
    assert all(r in text for r in replaces)
    assert "mstts_mma_bf16" in text and "fmaf(" not in text
    assert "mma.sync.aligned.m16n8k16" in (PORT / "csrc" / "common.cuh").read_text()


@pytest.mark.parametrize("entry", ["lstm_fwd", "lstm_fwd_residuals", "lstm_bwd", "bilstm_fwd",
                                   "bilstm_bwd"])
def test_lstm_kernel_entries_refuse_cpu_tensors(entry):
    """The persistent LSTM kernels' entry points raise on CPU tensors before
    anything reaches a card, and count no launch."""
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel, lstm_kernel
    from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

    T, B, D, H = 3, 2, 8, 8

    def bf(*shape):
        return torch.zeros(shape, dtype=torch.bfloat16)

    p = LSTMParams(torch.zeros(D, 4 * H), torch.zeros(H, 4 * H), torch.zeros(4 * H))
    gates, c_prev, dy = bf(T, B, 4 * H), bf(T, B, H), torch.zeros(T, B, H)
    kernel, call = {
        "lstm_fwd": (lstm_kernel.KERNEL,
                     lambda: lstm_kernel.lstm_seq_layer_kernel(p, bf(T, B, D))),
        "lstm_fwd_residuals": (lstm_kernel.RES_KERNEL,
                               lambda: lstm_kernel.lstm_seq_layer_kernel(p, bf(T, B, D), True)),
        "lstm_bwd": (lstm_kernel.BWD_KERNEL, lambda: lstm_kernel.lstm_seq_layer_bwd_kernel(
            p.w_hh, gates, c_prev, torch.zeros(B, H), dy)),
        "bilstm_fwd": (birnn_kernel.KERNEL, lambda: birnn_kernel.bilstm_recurrence_kernel(
            gates, gates, p.w_hh, p.w_hh)),
        "bilstm_bwd": (birnn_kernel.BWD_KERNEL, lambda: birnn_kernel.bilstm_bwd_kernel(
            gates, c_prev, gates, c_prev, p.w_hh, p.w_hh, dy, dy)),
    }[entry]
    before = kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        call()
    assert kernel.launches == before


@pytest.mark.parametrize("floor", ["barrier", "gru_chain"])
def test_recurrence_floor_needs_a_card(floor):
    from multi_speaker_tts_tpu_torch.ops import recurrence_floor

    call = {"barrier": lambda: recurrence_floor.barrier_floor(4, 1, 64, "cpu"),
            "gru_chain": lambda: recurrence_floor.gru_chain_floor(4, 4, 128, "cpu")}[floor]
    before = recurrence_floor.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA"):
        call()
    assert recurrence_floor.KERNEL.launches == before


def test_packed_weight_layout_is_built_once_per_weight_state():
    from multi_speaker_tts_tpu_torch.ops import _build

    calls = []

    def layout(w, b):
        calls.append(1)
        return torch.cat([w.t().reshape(-1), b])

    w, b = torch.ones(3, 2), torch.zeros(2)
    first = _build.packed(layout, w, b)
    assert _build.packed(layout, w, b) is first and len(calls) == 1
    b.add_(1.0)  # an in-place change of any weight rebuilds
    assert torch.equal(_build.packed(layout, w, b), torch.cat([torch.ones(6), torch.ones(2)]))
    w.data = torch.full((3, 2), 2.0)  # so does new storage
    assert torch.equal(_build.packed(layout, w, b)[:6], torch.full((6,), 2.0))
    assert len(calls) == 3


def test_import_checks_cover_the_data_parallel_evaluation_and_phoneme_modules():
    mods = _port_modules()
    for name in ("parallel", "parallel.mesh", "parallel.multihost", "evaluate", "text.phonemes"):
        assert f"multi_speaker_tts_tpu_torch.{name}" in mods, name
