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

from multi_speaker_tts_tpu_torch.tools import profile_train, stream_quality

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
