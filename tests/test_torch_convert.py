"""The port's ``convert/`` against the JAX package's, on the CPU.

- Every converter bit-equal to the JAX converter on seeded numpy tensors;
  ``full_mapping`` equal to the JAX table key for key (both linear heads,
  with and without GE2E); the port's copy of the reference torch model
  equal to the JAX package's (the same ``state_dict`` keys and shapes, the
  same initial values under one seed, the same forward).
- A ``.pt`` written by the JAX package's ``save_reference_checkpoint``
  converts to a tree array-equal to the JAX converter's, with the same step;
  the converted port models reproduce the torch reference's teacher-forced
  forward and GE2E embeddings within 1e-4 (the JAX test's bound); the
  port's CLI writes a file byte-equal to the JAX CLI's.
- ``chip_smoke.reference_models_from_tree`` (the inverse mapping of pass
  (l)) round-trips both demo checkpoints bit-exactly.
- Trained weights: the port's ``tools/torch_parity.py`` at the sizes of
  ``tests/test_convert_trained.py``, held to that test's bounds.
"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.convert import mapping as jmapping
from multi_speaker_tts_tpu.convert import reference_torch as jref
from multi_speaker_tts_tpu.convert import torch_to_jax as jcv
from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.convert import mapping, reference_torch, state_dict as cv
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
from multi_speaker_tts_tpu_torch.tools import torch_parity

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FWD_TOL = 1e-4  # tests/test_convert_e2e.py's bound


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _assert_trees_equal(got: dict, want: dict):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w)
    for k in w:
        a, b = np.asarray(g[k]), np.asarray(w[k])
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), k


@pytest.fixture(scope="module", params=["Conv", "CBHG"])
def parity_hp(request):
    """tiny_test_hparams with prenet dropout 0 (the reference keeps it on;
    at rate 0 both sides are the identity), one of the two linear heads."""
    from multi_speaker_tts_tpu.hparams import tiny_test_hparams

    hp = tiny_test_hparams().replace(Decoder={"Prenet": {"Dropout_Rate": 0.0}},
                                     Linear_Head={"Type": request.param})
    return Recursive_Parse(hp.to_dict())


@pytest.fixture(scope="module")
def jax_torch_models(parity_hp):
    """The JAX package's reference models, a few train-mode steps in (so the
    BatchNorm running statistics are not the identity)."""
    torch.manual_seed(7)
    taco, ge2e = jref.build_reference_tacotron(parity_hp), jref.build_reference_ge2e(parity_hp)
    g = torch.Generator().manual_seed(0)
    taco.train()
    for _ in range(3):
        tokens = torch.randint(1, 20, (2, 12), generator=g)
        mels = torch.rand((2, 16, parity_hp.Sound.Mel_Dim), generator=g)
        spk = torch.nn.functional.normalize(torch.randn(
            (2, parity_hp.Speaker_Embedding.Embedding_Size), generator=g), dim=-1)
        taco(tokens, torch.tensor([12, 9]), mels, spk)
    return taco.eval(), ge2e.eval()


@pytest.fixture(scope="module")
def saved(jax_torch_models, tmp_path_factory):
    path = tmp_path_factory.mktemp("ref_ckpt") / "S_100.pt"
    jref.save_reference_checkpoint(str(path), *jax_torch_models, steps=100)
    return path


# -- converters and tables ----------------------------------------------------


_CONVERTER_ARGS = {
    "convert_dense": [(7, 12), (7,)],
    "convert_conv1d": [(5, 12, 3), (5,)],
    "convert_lstm": [(24, 12), (24, 6), (24,), (24,)],
    "convert_gru": [(18, 12), (18, 6), (18,), (18,)],
    "convert_batchnorm": [(12,), (12,), (12,), (12,)],
    "convert_embedding": [(11, 4)],
}


@pytest.mark.parametrize("as_tensor", [True, False], ids=["tensor", "ndarray"])
@pytest.mark.parametrize("name", list(_CONVERTER_ARGS))
def test_converters_bit_equal_to_jax(name, as_tensor):
    rng = np.random.default_rng(len(name))
    args = [rng.standard_normal(s).astype(np.float32) for s in _CONVERTER_ARGS[name]]
    if as_tensor:
        args = [torch.from_numpy(a) for a in args]
    got, want = getattr(cv, name)(*args), getattr(jcv, name)(*args)
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            _assert_trees_equal(g, w)
    else:
        _assert_trees_equal(got, want)


def test_converters_without_optional_biases_match_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((6, 4)).astype(np.float32)
    _assert_trees_equal(cv.convert_dense(w), jcv.convert_dense(w))
    k = rng.standard_normal((6, 4, 3)).astype(np.float32)
    _assert_trees_equal(cv.convert_conv1d(k), jcv.convert_conv1d(k))
    wi, wh = (rng.standard_normal(s).astype(np.float32) for s in ((8, 4), (8, 2)))
    _assert_trees_equal(cv.convert_lstm(wi, wh), jcv.convert_lstm(wi, wh))


@pytest.mark.parametrize("ge2e", [True, False], ids=["ge2e", "no_ge2e"])
@pytest.mark.parametrize("head", ["Conv", "CBHG", "none"])
def test_full_mapping_equals_jax_key_for_key(head, ge2e):
    from multi_speaker_tts_tpu.hparams import tiny_test_hparams

    hp = tiny_test_hparams().replace(
        Linear_Head={"Use": head != "none", "Type": "CBHG" if head == "CBHG" else "Conv"},
        Speaker_Embedding={"Type": "GE2E" if ge2e else "LUT"})
    got, want = mapping.full_mapping(Recursive_Parse(hp.to_dict())), jmapping.full_mapping(hp)
    assert list(got) == list(want)
    for path in want:
        assert got[path][0].__name__ == want[path][0].__name__, path
        assert got[path][1] == want[path][1], path
    assert any(p.startswith("ge2e/") for p in got) == ge2e


def test_state_dict_strict_and_bad_files(tmp_path):
    with pytest.raises(KeyError, match="not in state_dict"):
        cv.convert_state_dict({}, {"a/b": (cv.convert_dense, ["nope.weight"])})
    lin = torch.nn.Linear(4, 3)
    tree = cv.convert_state_dict({"w": lin.weight}, {"a/x": (cv.convert_dense, ["w"]),
                                                     "a/y": (cv.convert_dense, ["nope"])},
                                 strict=False)
    assert list(tree["params"]["a"]) == ["x"]
    bad = tmp_path / "bad.pt"
    torch.save([1, 2, 3], bad)
    with pytest.raises(ValueError, match="unrecognized checkpoint structure"):
        cv.load_torch_checkpoint(str(bad))
    bare = tmp_path / "bare.pt"
    torch.save({"proj.weight": lin.weight.detach()}, bare)
    sd, extras = cv.load_torch_checkpoint(str(bare))
    assert list(sd) == ["proj.weight"] and extras == {}


def test_reference_model_copy_equals_the_jax_packages(parity_hp):
    """The port's copy of the reference model: the same state_dict keys and
    shapes, the same initial values under one seed, the same forward."""
    models = {}
    for name, mod in (("jax", jref), ("port", reference_torch)):
        torch.manual_seed(11)
        models[name] = (mod.build_reference_tacotron(parity_hp).eval(),
                        mod.build_reference_ge2e(parity_hp).eval())
    for i in range(2):
        a, b = models["port"][i].state_dict(), models["jax"][i].state_dict()
        assert list(a) == list(b)
        for k in b:
            assert a[k].shape == b[k].shape and torch.equal(a[k], b[k]), k
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(1, 20, (2, 12))).long()
    mels = torch.from_numpy(rng.random((2, 16, parity_hp.Sound.Mel_Dim), np.float32))
    spk = torch.nn.functional.normalize(torch.from_numpy(
        rng.standard_normal((2, parity_hp.Speaker_Embedding.Embedding_Size)).astype(np.float32)),
        dim=-1)
    with torch.no_grad():
        outs = [m[0](tokens, torch.tensor([12, 9]), mels, spk) for m in
                (models["port"], models["jax"])]
        embs = [m[1](mels) for m in (models["port"], models["jax"])]
    assert sorted(outs[0]) == sorted(outs[1])
    for k in outs[1]:
        assert torch.equal(outs[0][k], outs[1][k]), k
    assert torch.equal(*embs)


# -- a JAX-written reference checkpoint -----------------------------------------


def test_jax_written_checkpoint_converts_to_the_jax_tree(parity_hp, saved):
    got = mapping.convert_full_checkpoint(str(saved), parity_hp)
    want = jmapping.convert_full_checkpoint(str(saved), parity_hp)
    assert got["step"] == want["step"] == 100
    _assert_trees_equal({"params": got["params"], "batch_stats": got["batch_stats"]},
                        {"params": want["params"], "batch_stats": want["batch_stats"]})


def test_mapping_covers_the_whole_state_dict(parity_hp, jax_torch_models):
    taco, ge2e = jax_torch_models
    state = dict(taco.state_dict())
    state.update({f"ge2e.{k}": v for k, v in ge2e.state_dict().items()})
    mapped = {k for _, keys in mapping.full_mapping(parity_hp).values() for k in keys}
    assert {k for k in state if k not in mapped and "num_batches_tracked" not in k} == set()


def test_converted_port_models_match_the_torch_forward(parity_hp, jax_torch_models, saved):
    """Teacher-forced mel pre / post, stop logits, alignments and linear of
    the converted port Tacotron, and the GE2E embeddings, against the live
    torch reference, within 1e-4 (f32, CPU)."""
    taco_t, ge2e_t = jax_torch_models
    tree = mapping.convert_full_checkpoint(str(saved), parity_hp)
    taco_p, ge2e_p = torch_parity.converted_models(tree, parity_hp, torch.device("cpu"))
    rng = np.random.default_rng(3)
    B, S, T = 2, 12, 16
    tokens = torch.from_numpy(rng.integers(1, 20, (B, S))).long()
    lengths = torch.tensor([S, S - 3])
    mels = torch.from_numpy(rng.random((B, T, parity_hp.Sound.Mel_Dim), np.float32))
    spk = rng.standard_normal((B, parity_hp.Speaker_Embedding.Embedding_Size))
    spk = torch.from_numpy((spk / np.linalg.norm(spk, axis=-1, keepdims=True)).astype(np.float32))
    with torch.no_grad():
        want = taco_t(tokens, lengths, mels, spk)
        got = taco_p(tokens, lengths, mels, spk)
    for key in ("mel_pre", "mel_post", "stop_logits", "alignments", "linear"):
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), atol=FWD_TOL,
                                   rtol=FWD_TOL, err_msg=key)
    L = parity_hp.Speaker_Embedding.GE2E.Window_Length
    windows = torch.from_numpy(rng.random((3, L, parity_hp.Sound.Mel_Dim), np.float32))
    with torch.no_grad():
        np.testing.assert_allclose(ge2e_p(windows).numpy(), ge2e_t(windows).numpy(),
                                   atol=FWD_TOL, rtol=FWD_TOL)


def test_cli_output_is_byte_equal_to_the_jax_clis(parity_hp, saved, tmp_path, monkeypatch,
                                                 capsys):
    """The same -in, -hp and -out name through both CLIs: the same bytes, and
    the port's file serves (``Synthesizer.from_compact`` on the CPU)."""
    import yaml

    from multi_speaker_tts_tpu.convert.__main__ import main as jax_main
    from multi_speaker_tts_tpu_torch.convert.__main__ import main as port_main
    from multi_speaker_tts_tpu_torch.inference import Synthesizer

    hp_yaml = tmp_path / "hp.yaml"
    hp_yaml.write_text(yaml.safe_dump(parity_hp.to_dict()))
    blobs = {}
    for name in ("jax", "port"):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        argv = ["-in", str(saved), "-hp", str(hp_yaml), "-out", "converted.msgpack"]
        if name == "jax":
            monkeypatch.setattr(sys, "argv", ["convert", *argv])
            jax_main()
        else:
            port_main(argv)
        blobs[name] = (d / "converted.msgpack").read_bytes()
    printed = capsys.readouterr().out.strip().splitlines()
    assert printed[-1] == printed[-2] and printed[-1].endswith(", step 100")
    assert blobs["port"] == blobs["jax"]
    synth = Synthesizer.from_compact(str(tmp_path / "port" / "converted.msgpack"), device="cpu")
    emb = synth.enroll([np.random.default_rng(9).normal(size=4096).astype(np.float32)])
    out = synth.synthesize(["converted"], emb, max_steps=8, vocode=False)[0]
    assert out["mel_length"] >= 1 and np.isfinite(out["mel"]).all()


def test_cli_defaults_without_hp(tmp_path):
    """Without -hp the CLI uses the shipped defaults, as the JAX CLI does;
    -no_strict skips what the file lacks."""
    from multi_speaker_tts_tpu_torch.convert.__main__ import main as port_main

    lin = torch.nn.Linear(4, 3)
    src = tmp_path / "partial.pt"
    torch.save({"Model": {"decoder.stop_proj.weight": lin.weight.detach()}}, src)
    with pytest.raises(KeyError, match="not in state_dict"):
        port_main(["-in", str(src), "-out", str(tmp_path / "x.msgpack")])
    port_main(["-in", str(src), "-out", str(tmp_path / "x.msgpack"), "-no_strict"])
    params, _, meta = load_compact(tmp_path / "x.msgpack")
    assert meta["source"] == str(src) and "trained_steps" not in meta
    assert meta["hp"]["Sound"]["Mel_Dim"] == 80  # the shipped defaults


# -- the inverse mapping of chip_smoke.py pass (l) ------------------------------


@pytest.mark.parametrize("ckpt", ["demo/serving_ckpt.msgpack", "demo/serving_ckpt_full.msgpack"])
def test_inverse_mapping_round_trips_the_demo_checkpoints(ckpt, tmp_path):
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    params, batch_stats, meta = load_compact(ROOT / ckpt)
    hp = Recursive_Parse(meta["hp"])
    taco, ge2e = chip_smoke.reference_models_from_tree(params, batch_stats, hp)
    path = tmp_path / "S_7.pt"
    reference_torch.save_reference_checkpoint(str(path), taco, ge2e, steps=7)
    tree = mapping.convert_full_checkpoint(str(path), hp)
    assert tree["step"] == 7
    _assert_trees_equal({"params": tree["params"], "batch_stats": tree["batch_stats"]},
                        {"params": params, "batch_stats": batch_stats})


# -- trained weights (tools/torch_parity.py) ------------------------------------


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """tests/test_convert_trained.py's configuration, corpus and steps,
    through the port's tool on the CPU."""
    from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
    from multi_speaker_tts_tpu_torch.hparams import tiny_test_hparams

    hp = tiny_test_hparams().replace(
        Train={"Batch_Size": 4,
               "Batch_Bucketing": {"Token_Buckets": [48], "Mel_Buckets": [320]}},
        GE2E_Train={"Batch_Speakers": 3, "Batch_Utterances": 4, "Frame_Length": 16,
                    "Learning_Rate": 0.01, "Scale_Gradient": 0.01},
    )
    root = tmp_path_factory.mktemp("trained_conv_corpus")
    generate_synthetic_dataset(hp, root, n_speakers=3, n_utterances=6)
    corpus = str(root / "patterns")
    taco, ge2e = torch_parity.train_torch_reference(hp, corpus, tts_steps=40, ge2e_steps=20,
                                                    seed=0, log=lambda *_: None)
    report = torch_parity.compare_on_identical_batches(hp, taco, ge2e, corpus, n_batches=4,
                                                       device="cpu")
    return hp, corpus, report


def test_trained_weights_convert_with_parity(trained):
    """The JAX test's bounds: elementwise 1e-4 (stop logits 5e-4), metric
    deltas 1e-5 (mel L1), 1e-6 (stop accuracy), 1e-4 (diagonality); and
    the torch model trained (it beats a fresh one)."""
    hp, corpus, report = trained
    diff = report["elementwise_max_abs_diff"]
    for key in ("mel_pre", "mel_post", "alignments", "linear", "speaker_embedding"):
        assert diff[key] <= 1e-4, (key, diff)
    assert diff["stop_logits"] <= 5e-4, diff
    delta = report["metric_abs_delta"]
    assert delta["mel_l1_pre"] <= 1e-5 and delta["mel_l1_post"] <= 1e-5, report
    assert delta["stop_accuracy"] <= 1e-6 and delta["diag"] <= 1e-4, report
    assert report["port_converted"]["stop_accuracy"] >= 0.5, report
    torch.manual_seed(123)
    fresh = torch_parity.compare_on_identical_batches(
        hp, reference_torch.build_reference_tacotron(hp),
        reference_torch.build_reference_ge2e(hp), corpus, n_batches=4, device="cpu")
    assert report["torch"]["mel_l1_pre"] < fresh["torch"]["mel_l1_pre"]
    assert report["torch"]["stop_accuracy"] > fresh["torch"]["stop_accuracy"]


def test_tool_losses_equal_the_jax_tools(trained):
    """The tool's torch losses are the JAX tool's functions, on one batch of
    the trained corpus and seeded embeddings."""
    sys.path.insert(0, str(ROOT))
    from tools import torch_parity as jtool

    from multi_speaker_tts_tpu_torch.data.datasets import BucketBatcher, PatternDataset

    hp, corpus, _ = trained
    batcher = BucketBatcher(PatternDataset(corpus), 4, [48], [320], hp.Sound.Mel_Dim,
                            ref_window=hp.Speaker_Embedding.GE2E.Window_Length,
                            spect_dim=hp.Sound.Spectrogram_Dim, shuffle=False)
    _, batch = next(iter(batcher))
    torch.manual_seed(0)
    taco = reference_torch.build_reference_tacotron(hp).eval()
    spk = torch.nn.functional.normalize(torch.randn(4, hp.Speaker_Embedding.Embedding_Size), dim=-1)
    args = [torch.from_numpy(batch[k]) for k in ("tokens", "token_lengths", "mels")]
    args[0], args[1] = args[0].long(), args[1].long()
    with torch.no_grad():
        out = taco(*args, spk)
    rest = (args[2], torch.from_numpy(batch["mel_lengths"]).long(), args[1],
            torch.from_numpy(batch["spects"]), 1)
    got, want = (m.torch_tacotron_losses(out, *rest) for m in (torch_parity, jtool))
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    emb = torch.nn.functional.normalize(torch.randn(3, 4, 8), dim=-1)
    w, b = torch.tensor(10.0), torch.tensor(-5.0)
    assert torch.equal(torch_parity.torch_ge2e_loss(emb, w, b), jtool.torch_ge2e_loss(emb, w, b))
