"""The plain reference against the port's plain path on the CPU, in float32:
if they agree here, the reference computes what the program is meant to."""

import numpy as np
import pytest
import torch

from benchmark.harness import ge2e
from benchmark.harness.cell import ROOT
from benchmark.reference import compact
from benchmark.reference import dsp as rdsp
from benchmark.reference import models as R
from benchmark.reference import text as rtext

torch.set_num_threads(1)
SND = {"Sample_Rate": 22050, "Frame_Length": 1024, "Frame_Shift": 256, "Mel_Dim": 80,
       "Mel_F_Min": 0, "Mel_F_Max": None, "Preemphasis": 0.97, "Min_Level_DB": -100.0,
       "Ref_Level_DB": 20.0}


@pytest.fixture(scope="module")
def ckpt():
    return compact.load_compact(ROOT / "demo/serving_ckpt_full.msgpack")


def port_hp(meta_hp, **over):
    from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse

    return Recursive_Parse(meta_hp).replace(**over)


def test_ge2e_forward_and_windows():
    from multi_speaker_tts_tpu_torch.models.ge2e import GE2E

    d = {"mel": 80, "H": 48, "layers": 3, "E": 16}
    tree = ge2e.weights(5, d, "cpu")
    model = GE2E(80, 48, 3, 16, torch.float32)
    ge2e.load(model, tree, d)
    x = torch.rand(6, 24, 80, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        np.testing.assert_allclose(R.ge2e_embed(tree, x), model(x), atol=2e-5)
        mel = torch.rand(2, 70, 80, generator=torch.Generator().manual_seed(2))
        true = torch.tensor([70, 30])
        np.testing.assert_allclose(R.utterance_embedding(tree, mel, true, 24, 12),
                                   model.embed_utterance(mel, 24, 12, true), atol=2e-5)


def test_ge2e_loss():
    from multi_speaker_tts_tpu_torch.models.ge2e import ge2e_loss

    e = torch.nn.functional.normalize(torch.randn(4, 3, 8, generator=torch.Generator().manual_seed(3)), dim=-1)
    w, b = torch.tensor(10.0), torch.tensor(-5.0)
    assert float(R.ge2e_loss(e, w, b)) == pytest.approx(float(ge2e_loss(e, w, b)), rel=1e-6)


def test_mel():
    from multi_speaker_tts_tpu_torch.audio import dsp
    from multi_speaker_tts_tpu_torch.hparams import default_hparams

    cfg = dsp.DSPConfig.from_hp(default_hparams())
    wav = 0.3 * torch.sin(torch.arange(8192) * 0.05)[None] + 0.01 * torch.randn(
        1, 8192, generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(rdsp.melspectrogram(wav, SND), dsp.melspectrogram(wav, cfg),
                               atol=1e-4)


def test_text():
    from multi_speaker_tts_tpu_torch import text

    t = "the quick brown fox. a stitch in"
    assert rtext.encode(t) == list(text.text_to_sequence(t, ["english_cleaners"]))


def test_tacotron_teacher_forced(ckpt):
    """The checkpoint's synthesizer, teacher-forced under given prenet masks,
    in f32: the port's ``Tacotron.forward`` against the reference's pieces."""
    from multi_speaker_tts_tpu_torch.models.tacotron import Tacotron
    from multi_speaker_tts_tpu_torch.weights import load_into, params_from_jax

    tree, stats, meta = ckpt
    hp = port_hp(meta["hp"], Train={"Use_Mixed_Precision": False})
    taco = Tacotron(hp, torch.float32)
    load_into(taco, params_from_jax(tree, stats, hp), "tacotron.")
    g = torch.Generator().manual_seed(6)
    B, S, T = 2, 16, 12
    tokens = torch.randint(2, 38, (B, S), generator=g)
    lengths = torch.tensor([16, 11])
    tokens[1, 11:] = rtext.PAD_ID
    mels = torch.rand(B, T, 80, generator=g)
    spk = torch.nn.functional.normalize(torch.randn(B, 256, generator=g), dim=-1)
    keep = [torch.rand(B, T // 2, 256, generator=g) < 0.5 for _ in range(2)]
    with torch.no_grad():
        out = taco(tokens, lengths, mels, spk, prenet_masks=keep)
        P, St = R.to_device(tree["tacotron"], "cpu"), R.to_device(stats["tacotron"], "cpu")
        mem, mask = R.memory(P, St, tokens, lengths, spk)
        inputs = torch.cat([mels.new_zeros(B, 1, 80), mels[:, 1::2][:, :-1]], dim=1)
        frames, stops, aligns = R.decode_teacher_forced(P, mem, mask, inputs, keep, 0.5)
        pre = frames.reshape(B, T, 80)
        post = pre + R.postnet(P, St, pre)
        lin = R.cbhg_linear(P, St, post)
    for ours, theirs in ((pre, out["mel_pre"]), (stops, out["stop_logits"]),
                         (aligns, out["alignments"]), (post, out["mel_post"]),
                         (lin, out["linear"])):
        peak = float(theirs.abs().max())
        assert float((ours - theirs).abs().max()) <= 1e-4 * max(peak, 1.0)


def test_attention_forced_on_its_own_weights(ckpt):
    """Forced on the attention weights it computes itself, the reference's
    decoder computes what it computes free."""
    tree, stats, _ = ckpt
    P, St = R.to_device(tree["tacotron"], "cpu"), R.to_device(stats["tacotron"], "cpu")
    g = torch.Generator().manual_seed(7)
    B, S, n = 2, 16, 6
    tokens = torch.randint(2, 38, (B, S), generator=g)
    lengths = torch.tensor([16, 9])
    tokens[1, 9:] = rtext.PAD_ID
    spk = torch.nn.functional.normalize(torch.randn(B, 256, generator=g), dim=-1)
    inputs = torch.rand(B, n, 80, generator=g)
    keep = [torch.rand(B, n, 256, generator=g) < 0.5 for _ in range(2)]
    with torch.no_grad():
        mem, mask = R.memory(P, St, tokens, lengths, spk)
        free = R.decode_teacher_forced(P, mem, mask, inputs, keep, 0.5)
        forced = R.decode_teacher_forced(P, mem, mask, inputs, keep, 0.5, attention=free[2])
    for a, b in zip(free, forced):
        np.testing.assert_allclose(a, b, atol=1e-6)
