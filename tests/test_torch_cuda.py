"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: they need an sm_90a card and ``nvcc`` and skip without
them (the kernels have no CPU mode; the CPU tests hold the plain versions
against the JAX package). On the card: ``python -m pytest -m cuda
tests/test_torch_cuda.py``.
"""

import pathlib

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu_torch.ops.lstm import LSTMParams

pytestmark = pytest.mark.cuda
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from multi_speaker_tts_tpu_torch.ops import _build

    try:
        _build._nvcc()
    except RuntimeError as e:
        pytest.skip(str(e))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _lstm(rng, D, H, dev, scale=0.1):
    return LSTMParams(*(torch.from_numpy((rng.normal(size=s) * scale).astype(np.float32)).to(dev)
                        for s in ((D, 4 * H), (H, 4 * H), (4 * H,))))


def test_mel_kernel(dev):
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.ops import mel_kernel

    cfg = dsp.DSPConfig(22050, 1024, 256, 80, 0.0, None, 0.97, -100.0, 20.0, 1.5, 60)
    rng = np.random.default_rng(0)
    wav = torch.from_numpy(rng.standard_normal((2, 256 * 40)).astype(np.float32) * 0.3)
    y_pad, T = mel_kernel._pad_signal(wav.to(dev), cfg)
    got = mel_kernel.melspectrogram_kernel(y_pad, T, cfg)
    want = mel_kernel.melspectrogram_plain(y_pad, T, cfg)
    assert (got - want).abs().max().item() <= 1e-4  # f32 FMAs, no TF32


@pytest.mark.parametrize("B, D, H", [(3, 80, 768), (5, 768, 768), (40, 96, 128)])
def test_lstm_layer_kernel(dev, B, D, H):
    from multi_speaker_tts_tpu_torch.ops import lstm_kernel

    rng = np.random.default_rng(B)
    p = _lstm(rng, D, H, dev)
    x = torch.from_numpy(rng.normal(size=(20, B, D)).astype(np.float32)).to(dev, torch.bfloat16)
    ys, h, c = lstm_kernel.lstm_seq_layer_kernel(p, x)
    ys_p, h_p, c_p = lstm_kernel.lstm_seq_layer_plain(p, x, torch.bfloat16)
    # bf16 operands and outputs, f32 sums in another order (KERNEL_PARITY 5e-3).
    assert (ys.float() - ys_p.float()).abs().max().item() <= 5e-3
    assert (h - h_p).abs().max().item() <= 5e-3
    assert (c - c_p).abs().max().item() <= 5e-3


def test_bilstm_kernel(dev):
    from multi_speaker_tts_tpu_torch.ops import birnn_kernel

    rng = np.random.default_rng(1)
    pf, pb = _lstm(rng, 64, 256, dev), _lstm(rng, 64, 256, dev)
    x = torch.from_numpy(rng.normal(size=(4, 33, 64)).astype(np.float32)).to(dev)
    gxf, gxb = birnn_kernel.bilstm_hoist(pf, pb, x, torch.bfloat16)
    ysf, ysb = birnn_kernel.bilstm_recurrence_kernel(gxf, gxb, pf.w_hh, pb.w_hh)
    rf, rb = birnn_kernel.bilstm_recurrence_plain(gxf, gxb, pf.w_hh, pb.w_hh, torch.bfloat16)
    assert (ysf.float() - rf.float()).abs().max().item() <= 5e-3
    assert (ysb.float() - rb.float()).abs().max().item() <= 5e-3


@pytest.mark.parametrize("B, T", [(1, 64), (3, 37)])
def test_griffin_lim_kernel(dev, B, T):
    from multi_speaker_tts_tpu_torch.ops import griffin_lim_staged as gl

    rng = np.random.default_rng(T)
    mag = torch.from_numpy(rng.random((B, T, 513)).astype(np.float32) ** 2).to(dev)
    ms = gl.staged_magnitudes(mag, torch.bfloat16)
    got = gl.griffin_lim_staged_kernel(ms, 256, 8)
    want = gl.griffin_lim_staged_plain(ms, 256, 8, torch.bfloat16)
    # bf16 leaf operands: last-bit differences of the f32 sums flip operand
    # roundings; 8 iterations keep that within 2% of the peak.
    assert ((got - want).abs().max() / want.abs().max()).item() <= 2e-2


def test_synthesizer_on_the_card(dev):
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse
    from multi_speaker_tts_tpu_torch.checkpoints import load_compact
    from multi_speaker_tts_tpu_torch.inference import Synthesizer

    params, batch_stats, meta = load_compact(ROOT / "demo" / "serving_ckpt.msgpack")
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False})
    synth = Synthesizer(hp, params, batch_stats)
    assert synth.device.type == "cuda"
    emb = synth.enroll([str(ROOT / "demo" / "enroll_spk0_utt0.wav")])
    out = synth.synthesize(["hello world.", "a b c"], emb, pcm16=True)
    for item in out:
        assert item["wav"].dtype == np.int16 and item["mel_length"] > 0
        assert np.isfinite(item["mel"]).all()
