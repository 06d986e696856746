"""The port's HiFi-GAN V1 generator (``models/hifigan.py``) and its place in
``Synthesizer``, on the CPU, against the plain generator of
``tests/reference_hifigan.py`` on seeded weights: the generator alone at
the published rates and kernels with 32 channels, in f32 and bf16; the
wrong generators the comparison has to tell apart; ``synthesize`` with
``Vocoder.Type: HiFiGAN`` on the committed small checkpoint, mel-only; the
refusals; the daemon and the CLI with the weights read from an ``.npz``."""

import base64
import io
import json
import pathlib
import urllib.request

import numpy as np
import pytest
import torch

import reference_hifigan as ref
from multi_speaker_tts_tpu_torch import inference
from multi_speaker_tts_tpu_torch.audio import wav_io
from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse, default_hparams, vocoder_type
from multi_speaker_tts_tpu_torch.inference import Synthesizer, _decode_bucket
from multi_speaker_tts_tpu_torch.models import hifigan
from multi_speaker_tts_tpu_torch.models.hifigan import V1, HiFiGAN, read_weights
from multi_speaker_tts_tpu_torch.serve import TTSServer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "demo" / "serving_ckpt.msgpack"
WAV = str(ROOT / "demo" / "enroll_spk0_utt0.wav")
SMALL = dict(V1, Upsample_Initial_Channel=32)  # the published rates and kernels, 32 channels
N_MELS, HOP = 80, 256
F32_TOL = 1e-5
# bf16: every convolution's operands rounded to 8 significant bits (2^-9
# relative), through 2 + 4 x 19 convolutions in sequence and in the MRFs'
# branches: 0.42% and 0.45% of the waveform's root mean square on these two
# seeds' weights and inputs. 1.5% leaves 3x room; the wrong generators below
# read 8.4% (final slope 0.1) and 11% (one MRF branch left out).
BF16_REL = 1.5e-2


def _hp(cfg=SMALL, **overrides):
    return default_hparams().replace(Vocoder={"Type": "HiFiGAN", "HiFiGAN": cfg}, **overrides)


def _weights(seed=0, cfg=SMALL):
    return ref.seeded_weights(cfg, N_MELS, seed)


def _numpy(W):
    return {k: v.numpy() for k, v in W.items()}


def _mel(frames=9, rows=2, seed=1):
    return torch.rand((rows, frames, N_MELS), generator=torch.Generator().manual_seed(seed))


def _rel(a, b):
    return float((a - b).pow(2).mean().sqrt() / b.pow(2).mean().sqrt())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_generator_matches_the_reference_in_f32(seed):
    W = _weights(seed)
    gen = HiFiGAN.from_hp(_hp()).load(_numpy(W))
    mel = _mel(seed=seed + 10)
    with torch.no_grad():
        out = gen(mel)
    want = ref.generate(W, mel, SMALL)
    assert float((out - want).abs().max()) <= F32_TOL


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_in_bf16_within_its_rounding(seed):
    W = _weights(seed)
    gen = HiFiGAN.from_hp(_hp(), torch.bfloat16).load(_numpy(W))
    assert gen.conv_pre.weight.dtype == torch.bfloat16
    mel = _mel(seed=seed + 20)
    with torch.no_grad():
        out = gen(mel)
    assert out.dtype == torch.float32
    assert 0.0 < _rel(out, ref.generate(W, mel, SMALL)) <= BF16_REL


@pytest.mark.parametrize("frames", [1, 7, 16])
def test_lengths_hop_samples_a_frame_and_each_conv_keeps_length(frames):
    gen = HiFiGAN.from_hp(_hp()).load(_numpy(_weights()))
    mel = _mel(frames)
    with torch.no_grad():
        x = gen.pre(mel)
        assert x.shape == (2, 32, frames)
        for i in range(4):
            x = gen.stage(i, x)
            per_frame = int(np.prod(V1["Upsample_Rates"][:i + 1]))
            assert x.shape == (2, 32 >> (i + 1), frames * per_frame)
        assert gen.post(x).shape == (2, frames * HOP)
        assert gen(mel).shape == (2, frames * HOP)


@pytest.mark.parametrize("wrong", ["final_slope", "mrf_branch"])
def test_a_wrong_generator_fails_the_comparison(wrong):
    W = _weights()
    gen = HiFiGAN.from_hp(_hp()).load(_numpy(W))
    mel = _mel()
    with torch.no_grad():
        out = gen(mel)
    bad = (ref.generate(W, mel, SMALL, final_slope=0.1) if wrong == "final_slope"
           else ref.generate(W, mel, SMALL, branches=2))
    assert float((out - bad).abs().max()) > 100 * F32_TOL
    assert _rel(out, bad) > BF16_REL


def test_v1_has_the_published_parameters():
    gen = HiFiGAN.from_hp(_hp(V1))
    assert sum(p.numel() for p in gen.parameters()) == 13_926_017  # 13.92M published


def test_rates_must_multiply_to_the_hop():
    with pytest.raises(ValueError, match="Frame_Shift"):
        HiFiGAN.from_hp(_hp(dict(SMALL, Upsample_Rates=[8, 8, 2, 1])))


def test_load_refuses_missing_extra_and_misshapen_weights():
    W = _numpy(_weights())
    gen = HiFiGAN.from_hp(_hp())
    with pytest.raises(ValueError, match="missing"):
        gen.load({k: v for k, v in W.items() if k != "conv_post.bias"})
    with pytest.raises(ValueError, match="unexpected"):
        gen.load({**W, "conv_post.weight_g": W["conv_post.bias"]})
    with pytest.raises(ValueError, match="shape"):
        gen.load({**W, "ups.0.weight": W["ups.0.weight"][:, :, :8]})


def test_vocoder_type_defaults_to_griffin_lim():
    assert vocoder_type(default_hparams()) == "Griffin_Lim"
    assert vocoder_type(_hp()) == "HiFiGAN"
    with pytest.raises(NotImplementedError, match="WaveNet"):
        vocoder_type(default_hparams().replace(Vocoder={"Type": "WaveNet"}))


# -- in the synthesizer ----------------------------------------------------------------


@pytest.fixture(scope="module")
def ckpt():
    return load_compact(CKPT)


def _synth_hp(meta, **vocoder):
    # f32, mel-only: the generator reads the postnet's mel; f32 holds it to the reference.
    return Recursive_Parse(meta["hp"]).replace(
        Linear_Head={"Use": False}, Train={"Use_Mixed_Precision": False},
        Vocoder={"Type": "HiFiGAN", "HiFiGAN": {**SMALL, **vocoder}})


@pytest.fixture(scope="module")
def synth(ckpt):
    params, batch_stats, meta = ckpt
    s = Synthesizer(_synth_hp(meta), params, batch_stats, device="cpu",
                    vocoder_params=_numpy(_weights(3)))
    return s, s.enroll([WAV])


TEXTS = ["hello world.", "a second, longer text to speak."]


def test_synthesize_vocodes_each_row_with_the_generator(synth):
    s, emb = synth
    out = s.synthesize(TEXTS, emb)
    assert s.tacotron.linear_head is None and all("linear" not in o for o in out)
    T = [o["mel_length"] for o in out]
    Tb = _decode_bucket(max(T), s.last_decode_bucket)
    mel = torch.zeros((len(out), Tb, N_MELS))  # the postnet's mel at the vocoder bucket
    for j, o in enumerate(out):
        mel[j, :o["mel_length"]] = torch.from_numpy(o["mel"])
    want = ref.generate(_weights(3), mel, SMALL)
    for j, o in enumerate(out):
        assert o["wav"].shape == (max(T[j] - 1, 1) * HOP,)
        np.testing.assert_allclose(o["wav"], want[j, :len(o["wav"])].numpy(), atol=F32_TOL)
    again = s.synthesize(TEXTS, emb)
    for a, b in zip(out, again):
        np.testing.assert_array_equal(a["wav"], b["wav"])
    pcm = s.synthesize(TEXTS, emb, pcm16=True)
    for a, b in zip(out, pcm):
        np.testing.assert_array_equal(inference.pcm16(torch.from_numpy(a["wav"])).numpy(), b["wav"])


def test_fused_vocode_reads_the_whole_decode_bucket(synth):
    s, emb = synth
    out = s.synthesize(TEXTS[:1], emb, split_vocode=False, return_device=True)
    assert out["wav"].shape == (1, out["mel_post"].shape[1] * HOP)
    want = ref.generate(_weights(3), out["mel_post"], SMALL)
    assert float((out["wav"] - want).abs().max()) <= F32_TOL


def test_stream_refuses_the_generator(synth):
    s, emb = synth
    with pytest.raises(NotImplementedError, match="HiFi-GAN"):
        next(s.stream(TEXTS[:1], emb))


def test_weights_are_required_and_refused_where_unused(ckpt):
    params, batch_stats, meta = ckpt
    with pytest.raises(ValueError, match="vocoder_params"):
        Synthesizer(_synth_hp(meta), params, batch_stats, device="cpu")
    with pytest.raises(ValueError, match="Griffin_Lim"):
        Synthesizer(Recursive_Parse(meta["hp"]), params, batch_stats, device="cpu",
                    vocoder_params=_numpy(_weights()))
    with pytest.raises(ValueError, match="Weights"):
        read_weights(_synth_hp(meta))
    assert read_weights(Recursive_Parse(meta["hp"])) is None and read_weights(None) is None


def test_server_serves_from_an_npz(ckpt, tmp_path):
    params, batch_stats, meta = ckpt
    path = tmp_path / "hifigan_v1.npz"
    np.savez(path, **_numpy(_weights(4)))
    hp = _synth_hp(meta, Weights=str(path))
    s = Synthesizer(hp, params, batch_stats, device="cpu", vocoder_params=read_weights(hp))
    srv = TTSServer(s, host="127.0.0.1", port=0, max_batch=4, max_wait_ms=5.0)
    srv.registry.register("spk0", s.enroll([WAV]))
    srv.start_background()
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.port}/synthesize",
            data=json.dumps({"text": "hello world", "speaker": "spk0"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, body = resp.status, json.loads(resp.read())
    finally:
        srv.shutdown()
    assert status == 200
    wav, sr = wav_io.load_wav(io.BytesIO(base64.b64decode(body["wav_b64"])))
    assert sr == s.dsp_cfg.sample_rate and len(wav) == max(body["mel_length"] - 1, 1) * HOP


def test_inference_cli_reads_the_weights_named_by_the_hp(ckpt, tmp_path):
    _, _, meta = ckpt
    path = tmp_path / "hifigan_v1.npz"
    np.savez(path, **_numpy(_weights(5)))
    hp_file = tmp_path / "hp.json"
    hp_file.write_text(json.dumps(_synth_hp(meta, Weights=str(path)).to_dict()))
    inference.main(["-checkpoint", str(CKPT), "-hp", str(hp_file), "-text", "hello world.",
                    "-ref", WAV, "-out", str(tmp_path / "out"), "-device", "cpu"])
    wav, _ = wav_io.load_wav(tmp_path / "out" / "utt_0.wav")
    assert len(wav) > 0 and float(np.abs(wav).max()) > 0.0


def test_griffin_lim_stays_the_default_route(ckpt, monkeypatch):
    """Without a Vocoder section the synthesizer builds no generator and
    vocodes with Griffin-Lim."""
    params, batch_stats, meta = ckpt
    hp = Recursive_Parse(meta["hp"]).replace(Sound={"Griffin_Lim_Iter": 2})
    s = Synthesizer(hp, params, batch_stats, device="cpu")
    assert s.vocoder is None
    called = []
    monkeypatch.setattr(hifigan.HiFiGAN, "forward", lambda *a: called.append(a))
    s.synthesize(TEXTS[:1], s.enroll([WAV]))
    assert not called
