"""The port's spans and counts of work (``multi_speaker_tts_tpu_torch.telemetry``)
on the CPU: without a profiler a span is the shared no-op and a count records
nothing; under a ``torch.profiler`` session one small ``synthesize`` call on
the committed small checkpoint and one tiny ``GE2ETrainer.train_step`` give
their spans, the decode and the vocoder count the padded batch's work, and a
count's stamp lies inside the host interval of the span it was counted in
(the profiler and the counts share the Unix-epoch clock). The HiFi-GAN
generator's route records its four stages inside ``synth.vocode`` and the
same count; Griffin-Lim's records no stage of it."""

import pathlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from multi_speaker_tts_tpu_torch import telemetry
from multi_speaker_tts_tpu_torch.checkpoints import load_compact
from multi_speaker_tts_tpu_torch.hparams import Recursive_Parse, tiny_test_hparams
from multi_speaker_tts_tpu_torch.inference import Synthesizer, _decode_bucket
from multi_speaker_tts_tpu_torch.models.hifigan import V1
from multi_speaker_tts_tpu_torch.ops.decoder_scan import chunk_size
from multi_speaker_tts_tpu_torch.train.ge2e_trainer import GE2ETrainer

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
CKPT = ROOT / "demo" / "serving_ckpt.msgpack"
WAVS = [str(ROOT / "demo" / "enroll_spk0_utt0.wav")]
TEXTS = ["hello world.", "a short one.", "and a third text here."]  # 3 rows, padded to 4
SLACK_NS = 50_000  # a stamp may lie this far outside its span's host interval
SYNTH_SPANS = ("synth.call", "synth.prepare", "synth.encoder", "synth.decode",
               "synth.postnet", "synth.linear", "synth.vocode", "synth.return")
REMOVED = {"enroll": ("enroll.mel", "enroll.ge2e"),
           "stream": ("stream.decode", "stream.emit", "stream.vocode")}


def _host_spans(prof) -> dict:
    """{name: [(start_ns, end_ns)]} of the trace's host events."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _counts(name: str) -> list:
    return telemetry.events(name, 0, 1 << 63)


@pytest.fixture(scope="module")
def synth():
    params, batch_stats, meta = load_compact(CKPT)
    hp = Recursive_Parse(meta["hp"]).replace(Sound={"Griffin_Lim_Iter": 2})
    synth = Synthesizer(hp, params, batch_stats, device="cpu")
    return synth, synth.enroll(WAVS)


@pytest.fixture(scope="module")
def traced(synth):
    """One profiled ``synthesize`` call: (host spans, outputs, the counts
    recorded during it, the synthesizer)."""
    synth, emb = synth
    before = {k: len(_counts(k)) for k in ("decode.row_steps", "vocode.row_frames")}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = synth.synthesize(TEXTS, emb)
    counts = {k: _counts(k)[n:] for k, n in before.items()}
    return _host_spans(prof), out, counts, synth


def test_no_profiler_no_span_no_count():
    assert not torch._C._autograd._profiler_enabled()
    assert telemetry.span("a") is telemetry.span("b")
    with telemetry.span("a"):
        pass
    before = list(telemetry._store.log)
    telemetry.count("decode.row_steps", 7)
    assert list(telemetry._store.log) == before


@pytest.mark.parametrize("name", SYNTH_SPANS)
def test_synthesize_spans(traced, name):
    spans, *_ = traced
    assert len(spans.get(name, [])) >= 1


def test_spans_nest_in_the_call(traced):
    spans, *_ = traced
    (lo, hi), = spans["synth.call"]
    for name in SYNTH_SPANS[1:]:
        assert all(lo <= a and b <= hi for a, b in spans[name]), name


def test_decode_counts_every_row_of_each_chunk(traced):
    _, out, counts, synth = traced
    r = int(synth.hp.Decoder.N_Frames_Per_Step)
    K = chunk_size(synth.last_decode_bucket // r, synth.tacotron.decoder.early_exit_chunk)
    longest = max(o["mel_length"] for o in out) // r
    events = counts["decode.row_steps"]
    assert len(events) == -(-longest // K)  # chunks until the last row stopped
    # Each chunk launches the rows still decoding: a row runs to the end of
    # the chunk it stopped in, a PAD row never.
    assert sum(n for _, n in events) == K * sum(-(-(o["mel_length"] // r) // K) for o in out)


def test_vocoder_counts_every_row_at_the_bucket(traced):
    _, out, counts, synth = traced
    Tb = _decode_bucket(max(o["mel_length"] for o in out), synth.last_decode_bucket)
    assert [n for _, n in counts["vocode.row_frames"]] == [4 * Tb]


@pytest.mark.parametrize("name, span", [("decode.row_steps", "synth.decode"),
                                        ("vocode.row_frames", "synth.vocode")])
def test_count_stamps_share_the_trace_clock(traced, name, span):
    spans, _, counts, _ = traced
    for stamp, _ in counts[name]:
        assert any(a - SLACK_NS <= stamp <= b + SLACK_NS for a, b in spans[span]), stamp


@pytest.mark.parametrize("call", sorted(REMOVED))
def test_removed_spans_are_gone(synth, call):
    synth, emb = synth
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if call == "enroll":
            synth.enroll(WAVS)
        else:
            list(synth.stream(TEXTS[:1], emb, segment_steps=16))
    assert not set(REMOVED[call]) & set(_host_spans(prof))


HIFIGAN_SPANS = ("synth.vocode", "vocode.up0", "vocode.up1", "vocode.up2", "vocode.up3")
HIFIGAN = dict(V1, Upsample_Initial_Channel=32)  # the published rates and kernels


@pytest.fixture(scope="module")
def traced_hifigan():
    """One profiled ``synthesize`` call vocoded by the HiFi-GAN generator
    (mel-only, seeded weights at 32 channels): (host spans, outputs, its
    ``vocode.row_frames`` counts, the synthesizer)."""
    from reference_hifigan import seeded_weights

    params, batch_stats, meta = load_compact(CKPT)
    hp = Recursive_Parse(meta["hp"]).replace(Linear_Head={"Use": False},
                                             Vocoder={"Type": "HiFiGAN", "HiFiGAN": HIFIGAN})
    weights = {k: v.numpy() for k, v in seeded_weights(HIFIGAN, hp.Sound.Mel_Dim, 0).items()}
    synth = Synthesizer(hp, params, batch_stats, device="cpu", vocoder_params=weights)
    emb = synth.enroll(WAVS)
    n = len(_counts("vocode.row_frames"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = synth.synthesize(TEXTS, emb)
    return _host_spans(prof), out, _counts("vocode.row_frames")[n:], synth


@pytest.mark.parametrize("name", HIFIGAN_SPANS)
def test_the_generator_runs_its_stages_inside_the_vocode_span(traced_hifigan, name):
    spans, *_ = traced_hifigan
    (lo, hi), = spans["synth.vocode"]
    assert len(spans.get(name, [])) == 1
    assert all(lo <= a and b <= hi for a, b in spans[name])


def test_the_generator_counts_every_row_at_the_bucket(traced_hifigan):
    spans, out, counts, synth = traced_hifigan
    Tb = _decode_bucket(max(o["mel_length"] for o in out), synth.last_decode_bucket)
    assert [n for _, n in counts] == [4 * Tb]  # 3 rows padded to 4, once a call
    (lo, hi), = spans["synth.vocode"]
    assert all(lo - SLACK_NS <= stamp <= hi + SLACK_NS for stamp, _ in counts)


def test_griffin_lim_runs_no_generator_stage(traced):
    spans, *_ = traced
    assert not set(HIFIGAN_SPANS[1:]) & set(spans)


def test_events_refuse_a_range_with_dropped_events():
    store = telemetry._Store(4)
    for t in range(6):
        store.add(t, "x", 1)
    assert store.between("x", 0, 10) is None  # events 0 and 1 were dropped
    assert store.between("x", 3, 10) == [(3, 1), (4, 1), (5, 1)]


@pytest.fixture(scope="module")
def train_spans(tmp_path_factory):
    """The host spans of one profiled tiny ``GE2ETrainer.train_step``."""
    hp = tiny_test_hparams().replace(
        GE2E_Train={"Batch_Speakers": 2, "Batch_Utterances": 2, "Frame_Length": 12})
    logs = tmp_path_factory.mktemp("ge2e")
    trainer = GE2ETrainer(hp, checkpoint_dir=str(logs / "ckpt"), log_dir=str(logs / "log"),
                          device="cpu")
    mels = np.random.default_rng(0).normal(size=(4, 12, hp.Sound.Mel_Dim)).astype(np.float32)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train_step(mels)
    return _host_spans(prof)


@pytest.mark.parametrize("name", ["train.forward", "train.backward", "train.update"])
def test_train_step_spans(train_spans, name):
    assert len(train_spans.get(name, [])) == 1
