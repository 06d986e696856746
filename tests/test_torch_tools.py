"""The port's ``tools/stream_quality.py`` and ``tools/profile_train.py`` on
the CPU: the re-analysis metric against the JAX tool's, each tool end to
end at a small size, and the profiler's bookkeeping. Their card runs are
``chip_smoke.py`` pass (n)."""

import json
import pathlib
import sys

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu_torch.tools import (
    decode_kernel_ab, decode_probe, gates_probe, ge2e_roofline, profile_train, stream_quality,
    sv_harmonic_control,
)

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = str(ROOT / "demo" / "serving_ckpt.msgpack")


def test_reanalyzed_l1_equals_the_jax_tools():
    """The same wav and mel through both tools' metric (the port's FFT
    front-end against the JAX package's), within 1e-4."""
    sys.path.insert(0, str(ROOT))
    from tools import stream_quality as jtool

    from multi_speaker_tts_tpu.audio import dsp as jdsp
    from multi_speaker_tts_tpu_torch.inference import Synthesizer

    synth = Synthesizer.from_compact(CKPT, device="cpu")

    class JaxSide:  # what the JAX metric reads of its synthesizer
        dsp_cfg = jdsp.DSPConfig(**{f: getattr(synth.dsp_cfg, f)
                                    for f in jdsp.DSPConfig.__dataclass_fields__})
    rng = np.random.default_rng(0)
    T, M = 37, synth.dsp_cfg.n_mels
    mel = rng.random((T, M)).astype(np.float32)
    for n in ((T - 1) * synth.dsp_cfg.hop, (T + 5) * synth.dsp_cfg.hop):  # short and long wavs
        wav = (rng.standard_normal(n) * 0.2).astype(np.float32)
        got = stream_quality.reanalyzed_l1(wav, mel, synth)
        want = jtool.reanalyzed_l1(wav, mel, JaxSide)
        assert abs(got - want) <= 1e-4


def test_stream_quality_runs_on_the_cpu(capsys):
    report = stream_quality.main(["-ckpt", CKPT, "-device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == report and report["device"] == "cpu" and report["n_texts"] == 4
    for key in ("wav_mel_l1_batch", "wav_mel_l1_stream_crossfade",
                "wav_mel_l1_stream_warmstart"):
        assert np.isfinite(report[key]) and 0.0 < report[key] < 1.0
    assert all(len(v) == 4 for v in report["per_utt"].values())


def test_profile_train_tiny_on_the_cpu(capsys):
    """The tool at tiny widths on the CPU: the decoder scan's forward and
    backward each timed once a step, no device numbers claimed."""
    result = profile_train.main(["-device", "cpu", "-tiny", "-steps", "2"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == json.loads(json.dumps(result))
    assert result["device"] == "cpu" and result["steps"] == 2
    assert result["step_ms"] is None and result["per_category_ms"] is None
    assert result["device_busy_ms_per_step"] is None
    sh = result["scan_host_ms"]
    assert sh["calls_per_step"] == {"forward": 1.0, "backward": 1.0}
    assert sh["forward"] > 0 and sh["backward"] > 0 and 0 < sh["share_of_step_wall"] < 1


def test_profile_train_restores_the_scan():
    from multi_speaker_tts_tpu_torch.ops import decoder_scan

    before = dict(decoder_scan._TFScan.__dict__)
    with profile_train.scan_host_timer() as times:
        assert decoder_scan._TFScan.__dict__["forward"] is not before["forward"]
    assert times == {"forward": [], "backward": []}
    for k in ("forward", "backward"):
        assert decoder_scan._TFScan.__dict__[k] is before[k]


@pytest.mark.parametrize("name, cat", [
    ("_ZN38_GLOBAL__N__mel_fft_kernelEPKf", "csrc kernels"),
    ("(anonymous namespace)::bigru_bwd_kernel<128>", "csrc kernels"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", "gemms"),
    ("cudnn::implicit_convolve_sgemm", "convs"),
    ("void at::native::vectorized_elementwise_kernel<4, ...>", "elementwise"),
    ("void at::native::reduce_kernel<512, 1, ...>", "reductions"),
    ("Memcpy HtoD (Pageable -> Device)", "copies"),
    ("void at::native::index_put_kernel", "other"),
])
def test_profile_categories(name, cat):
    assert profile_train.category(name) == cat


def test_profile_train_top_ops_carry_their_source(monkeypatch):
    """The top operations are grouped by operation and the port's frames
    that called it (the profiler's Python events). On the CPU there is no
    device time, so the events' CPU time stands in for it here."""
    from torch.autograd import profiler_util

    monkeypatch.setattr(profiler_util.FunctionEvent, "self_device_time_total",
                        property(lambda self: self.self_cpu_time_total))
    result = profile_train.main(["-device", "cpu", "-tiny", "-steps", "1", "-top", "1000"])
    ops = result["top_ops"]
    assert ops and all(o["ms"] > 0 and o["source"] for o in ops)
    assert [o["ms"] for o in ops] == sorted((o["ms"] for o in ops), reverse=True)
    frames = {f for o in ops for f in o["source"]}
    assert any(f.startswith("ops/lstm.py") for f in frames), frames
    assert any(f.startswith("ops/decoder_scan.py") for f in frames), frames


# -- ge2e_roofline, decode_probe, gates_probe, decode_kernel_ab, sv_harmonic_control

def _jax_tool(name: str):
    """A top-level JAX tool by its file (``tools/`` is no package)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("N, M, T", ge2e_roofline.SWEEP)
def test_ge2e_analytic_budget_equals_the_jax_tools(N, M, T):
    jtool = _jax_tool("ge2e_roofline")
    assert ge2e_roofline.analytic_budget(N, M, T) == jtool.analytic_budget(N, M, T)
    assert ge2e_roofline.SWEEP == [tuple(s) for s in (
        (16, 10, 160), (8, 10, 160), (32, 10, 160), (64, 10, 160), (16, 5, 160),
        (16, 20, 160), (16, 10, 80), (16, 10, 240))]


@pytest.mark.parametrize("r", [1.0, 1.3, 1.69, 2.0, 2.197, 2.8561, 3.71293, 1.41, 6.0])
def test_octave_distance_equals_the_jax_tools(r):
    assert sv_harmonic_control.octave_distance(r) == _jax_tool("sv_harmonic_control").octave_distance(r)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_spearman_equals_the_jax_tools(seed):
    rng = np.random.default_rng(seed)
    x, y = rng.normal(size=50), rng.normal(size=50)
    y = y + seed * x
    assert sv_harmonic_control._spearman(x, y) == _jax_tool("sv_harmonic_control")._spearman(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_eer_splits_equal_a_recomputation_with_the_jax_eer(seed):
    """``harmonic_control`` on fixed embeddings of 6 speakers x 5 utterances
    against the splits recomputed here with the JAX package's
    ``compute_eer`` and the JAX tool's ``octave_distance``."""
    from multi_speaker_tts_tpu.evaluate import compute_eer as jax_eer

    jtool = _jax_tool("sv_harmonic_control")
    rng = np.random.default_rng(seed)
    spk_of = np.repeat(np.arange(6), 5)
    centres = rng.normal(size=(6, 16))
    E = centres[spk_of] + 0.8 * rng.normal(size=(30, 16))
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    got = sv_harmonic_control.harmonic_control(E, spk_of, 0.2)

    cos = E @ E.T
    iu, ju = np.triu_indices(30, k=1)
    scores, same = cos[iu, ju], spk_of[iu] == spk_of[ju]
    f0 = 110.0 * 1.3 ** spk_of.astype(np.float64)  # the JAX tool's f0 and ratio
    ratio = np.maximum(f0[iu], f0[ju]) / np.minimum(f0[iu], f0[ju])
    odist = np.asarray([jtool.octave_distance(r) for r in ratio])

    def eer(cross):
        return round(jax_eer(np.concatenate([scores[same], scores[cross]]),
                             np.r_[np.ones(same.sum(), bool), np.zeros(cross.sum(), bool)]), 4)

    near, far = (~same) & (odist < 0.2), (~same) & (odist >= 0.2)
    adjacent, apart = (~same) & (ratio < 1.69), (~same) & (ratio >= 1.69)
    assert got["sv_eer_all"] == round(jax_eer(scores, same), 4)
    assert got["sv_eer_excl_near_harmonic"] == eer(far)
    assert got["sv_eer_near_harmonic_only"] == eer(near)
    assert got["sv_eer_excl_adjacent"] == eer(apart)
    assert got["sv_eer_adjacent_only"] == eer(adjacent)
    assert (got["near_harmonic_pairs"], got["inharmonic_pairs"]) == (near.sum(), far.sum())
    assert (got["adjacent_pairs"], got["nonadjacent_pairs"]) == (adjacent.sum(), apart.sum())
    assert got["spearman_crosscos_vs_logf0dist"] == jtool._spearman(
        scores[~same], np.abs(np.log(ratio[~same])))
    assert len(got["pairs"]) == 15 and got["own_cos"] == round(float(scores[same].mean()), 4)


# The JSON keys each JAX tool prints (read from its source), which the
# port's tool prints too, beside what the port adds.
JAX_KEYS = {
    "ge2e_roofline": {"N", "M", "T", "rows", "ms_per_step", "frames_per_sec", "step_tflops",
                      "mfu"},
    "decode_probe": {"batch", "max_steps"} | {f"{k}_{tag}_{mode}"
                                             for k in ("decode_ms", "us_per_step")
                                             for tag in ("f32", "int8")
                                             for mode in ("fixed", "early_exit")},
    "gates_probe": {"batch", "steps", "gates_us_per_step_bf16", "gates_us_per_step_int8_xla"},
    "decode_kernel_ab": {"batch", "steps", "chunk", "S"} | {
        f"us_per_step_{v}" for v in ("xla_bf16", "xla_int8", "pallas_int8", "pallas_bf16")},
    "sv_harmonic_control": {
        "sv_eer_all", "near_harmonic_pairs", "inharmonic_pairs", "cross_cos_near_harmonic",
        "cross_cos_inharmonic", "own_cos", "sv_eer_excl_near_harmonic",
        "sv_eer_near_harmonic_only", "octave_threshold", "adjacent_pairs", "nonadjacent_pairs",
        "cross_cos_adjacent", "cross_cos_nonadjacent", "sv_eer_excl_adjacent",
        "sv_eer_adjacent_only", "spearman_crosscos_vs_logf0dist", "pairs"},
}


def _printed_json(out: str, prefix: str = "") -> dict:
    lines = [x for x in out.splitlines() if x.startswith(prefix + "{")]
    return json.loads(lines[-1][len(prefix):])


def test_ge2e_roofline_main_on_the_cpu(capsys, tmp_path):
    results = ge2e_roofline.main(["-device", "cpu", "-N", "2", "-M", "2", "-T", "4",
                                  "-trace", str(tmp_path)])
    out = capsys.readouterr().out
    printed = _printed_json(out)
    assert JAX_KEYS["ge2e_roofline"] <= printed.keys() and printed == results[0]
    assert printed["device"] == "cpu" and printed["mfu"] is None  # not measured off the card
    assert printed["ms_per_step"] > 0 and printed["step_tflops"] == ge2e_roofline.analytic_budget(
        2, 2, 4)["model_tflop_per_step"]
    assert "analytic:" in out and (tmp_path / "summary.json").exists()


def test_decode_probe_main_on_the_cpu(capsys):
    report = decode_probe.main(["-device", "cpu", "-batch", "1", "-steps", "8",
                                "-ckpt", CKPT])
    printed = _printed_json(capsys.readouterr().out, "PROBE ")
    assert JAX_KEYS["decode_probe"] <= printed.keys() and printed == report
    for tag in ("bf16_pallas", "int8_pallas"):  # the port's kernel modes beside them
        assert f"us_per_step_{tag}_fixed" in printed
    assert printed["device"] == "cpu" and printed["batch"] == 1


def test_gates_probe_main_on_the_cpu(capsys):
    report = gates_probe.main(["-device", "cpu", "-batch", "2", "-steps", "2"])
    out = capsys.readouterr().out
    printed = _printed_json(out, "PROBE ")
    assert JAX_KEYS["gates_probe"] == printed.keys() - {"device", "card"} and printed == report
    assert "int8_pallas: not run" in out
    assert all(printed[k] > 0 for k in JAX_KEYS["gates_probe"] if k.startswith("gates_"))


def test_gates_probe_loop_is_the_two_dependent_products():
    """One step of the probe's loop equals both layers' gates and cells
    written out, in bf16 and through the int8 route."""
    from multi_speaker_tts_tpu_torch.ops import decoder_scan as dscan
    from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams, cell

    rng = np.random.default_rng(1)
    H, B = 32, 2
    t = lambda *s: torch.from_numpy((rng.standard_normal(s) * 0.1).astype(np.float32))  # noqa: E731
    # At H 32 the loop's stand-in context, h0[:, :768], is h0 itself.
    w0, w1, x0 = t(2 * H, 4 * H), t(3 * H, 4 * H), t(B, H)
    b0, b1 = t(4 * H), t(4 * H)
    lstm = (LSTMParams(w0[:H], w0[H:], b0), LSTMParams(w1[:2 * H], w1[2 * H:], b1))
    for fused in (dscan.fused_weights(lstm, torch.bfloat16),
                  dscan.quantize_fused(dscan.DecoderParams(lstm, None, None, None))):
        got = gates_probe.make_loop(*fused, b0, b1, x0, 1, torch.bfloat16)()
        z = torch.zeros(B, H)
        h0, _ = cell(dscan._gates(fused[0], b0, x0, z, torch.bfloat16), z)
        h1, _ = cell(dscan._gates(fused[1], b1, torch.cat([h0, h0[:, :768]], -1), z,
                                  torch.bfloat16), z)
        assert torch.equal(got, h0.mean() + h1.mean())


def test_decode_kernel_ab_main_on_the_cpu(capsys):
    report = decode_kernel_ab.main(["-device", "cpu", "-batch", "1", "-steps", "2",
                                    "-chunk", "2", "-S", "16"])
    printed = _printed_json(capsys.readouterr().out, "PROBE ")
    assert JAX_KEYS["decode_kernel_ab"] <= printed.keys() and printed == report
    # On the CPU the kernel variants run the plain version: no launch.
    assert printed["launches_per_run_pallas_int8"] == printed["launches_per_run_pallas_bf16"] == 0
    assert printed["row_groups_pallas_bf16"] == [1]


def test_sv_harmonic_control_main_on_the_cpu(capsys, tmp_path):
    from multi_speaker_tts_tpu_torch.data.pattern_generator import generate_synthetic_dataset
    from multi_speaker_tts_tpu_torch.hparams import tiny_test_hparams
    from multi_speaker_tts_tpu_torch.train.checkpoints import export_compact
    from multi_speaker_tts_tpu_torch.train.trainer import Trainer
    from multi_speaker_tts_tpu_torch import weights

    hp = tiny_test_hparams()
    generate_synthetic_dataset(hp, tmp_path, n_speakers=4, n_utterances=3)
    trainer = Trainer(hp, tmp_path / "ck", tmp_path / "log", device="cpu", seed=5)
    trainer.initialize()
    params, batch_stats = weights.params_to_jax(trainer.state(), hp)
    export = tmp_path / "model.msgpack"
    export_compact(export, params, batch_stats, {"hp": hp.to_dict()})
    report = sv_harmonic_control.main(["-checkpoint", str(export), "-pattern",
                                       str(tmp_path / "patterns"), "-device", "cpu"])
    out = capsys.readouterr().out
    lines = out.splitlines()
    start = max(i for i, x in enumerate(lines) if x == "{")  # the JAX tool's indented object
    printed = json.loads("\n".join(lines[start:]))
    assert JAX_KEYS["sv_harmonic_control"] <= printed.keys() and printed == report
    assert report["device"] == "cpu"
    assert 0.0 <= report["sv_eer_all"] <= 1.0 and len(report["pairs"]) == 6
