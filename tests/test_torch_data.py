"""The port's data pipeline against the JAX package's, on the CPU.

One synthetic corpus a voice recipe, written once by each package (tiny
hparams): the same wavs, tokens equal and features within 1e-5; each
package reads the other's patterns. On one pattern directory: the
``BucketBatcher`` plans and batches, the ``GE2EBatchSampler`` draws and the
torch loader's batches (with and without a row shard) equal the JAX
package's for the same seeds. The LJ and VCTK walkers list what
``wav_io`` can read.
"""

import pickle

import numpy as np
import pytest
import torch

from multi_speaker_tts_tpu.data import datasets as jdata
from multi_speaker_tts_tpu.data import grain_loader as jgrain
from multi_speaker_tts_tpu.data import pattern_generator as jpg
from multi_speaker_tts_tpu.hparams import tiny_test_hparams as jax_tiny
from multi_speaker_tts_tpu_torch.data import datasets, loader
from multi_speaker_tts_tpu_torch.data import pattern_generator as pg
from multi_speaker_tts_tpu_torch.hparams import tiny_test_hparams

# One intra-op thread: the suite runs in several worker processes at once,
# and torch would otherwise start a thread per core in each of them.
torch.set_num_threads(1)

FEATURE_TOL = 1e-5


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """{voice: (port's pattern dir, JAX's pattern dir)}: 3 speakers x 3
    utterances each."""
    out = {}
    for voice in ("legacy", "rich"):
        root = tmp_path_factory.mktemp(voice)
        pg.generate_synthetic_dataset(tiny_test_hparams(), root / "port", n_speakers=3,
                                      n_utterances=3, voice=voice)
        jpg.generate_synthetic_dataset(jax_tiny(), root / "jax", n_speakers=3, n_utterances=3,
                                       voice=voice)
        out[voice] = (root / "port" / "patterns", root / "jax" / "patterns")
    return out


@pytest.mark.parametrize("voice", ["legacy", "rich"])
def test_synthetic_corpus_matches_jax(corpora, voice):
    port_dir, jax_dir = corpora[voice]
    meta_p = pickle.loads((port_dir / "METADATA.PICKLE").read_bytes())
    meta_j = pickle.loads((jax_dir / "METADATA.PICKLE").read_bytes())
    assert meta_p["Files"] == meta_j["Files"] and len(meta_p["Files"]) == 9
    for key in ("Mel_Lengths", "Token_Lengths"):
        assert np.array_equal(meta_p[key], meta_j[key])
    assert meta_p["Speakers"] == meta_j["Speakers"]
    for name in meta_p["Files"]:
        a = pickle.loads((port_dir / name).read_bytes())
        b = pickle.loads((jax_dir / name).read_bytes())
        assert set(a) == set(b)
        assert np.array_equal(a["Tokens"], b["Tokens"]) and a["Text"] == b["Text"]
        for key in ("Mel", "Spect"):
            assert a[key].shape == b[key].shape and a[key].dtype == b[key].dtype
            assert np.abs(a[key] - b[key]).max() <= FEATURE_TOL


def test_each_package_reads_the_others_patterns(corpora):
    port_dir, jax_dir = corpora["legacy"]
    for path in (port_dir, jax_dir):
        a, b = datasets.PatternDataset(path), jdata.PatternDataset(path)
        assert a.speaker_ids == b.speaker_ids and len(a) == len(b)
        for i in range(len(a)):
            x, y = a[i], b[i]
            assert x["Speaker_ID"] == y["Speaker_ID"]
            assert np.array_equal(x["Mel"], y["Mel"]) and np.array_equal(x["Tokens"], y["Tokens"])


def _batchers(path, **kw):
    hp = tiny_test_hparams()
    args = dict(batch_size=4, token_buckets=[30, 50], mel_buckets=[160, 320],
                mel_dim=hp.Sound.Mel_Dim, n_frames_per_step=2, ref_window=24, seed=3,
                spect_dim=hp.Sound.Spectrogram_Dim, **kw)
    return (datasets.BucketBatcher(datasets.PatternDataset(path), **args),
            jdata.BucketBatcher(jdata.PatternDataset(path), **args))


def _equal_batches(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k


@pytest.mark.parametrize("shuffle", [True, False])
def test_bucket_batcher_plans_and_batches_match_jax(corpora, shuffle):
    port, jax_ = _batchers(corpora["rich"][0], shuffle=shuffle)
    assert port.assignment == jax_.assignment and port.n_dropped == jax_.n_dropped
    for _ in range(2):  # two epochs: the generator carries over
        got, want = list(port), list(jax_)
        assert [s for s, _ in got] == [s for s, _ in want] and len(got) >= 2
        for (_, a), (_, b) in zip(got, want):
            _equal_batches(a, b)


def test_ge2e_sampler_matches_jax(corpora):
    path = corpora["rich"][0]
    port = datasets.GE2EBatchSampler(datasets.PatternDataset(path), 2, 4, 40, seed=5)
    jax_ = jdata.GE2EBatchSampler(jdata.PatternDataset(path), 2, 4, 40, seed=5)
    for _ in range(3):
        _equal_batches(port.sample(), jax_.sample())
    with pytest.raises(ValueError, match="speakers"):
        datasets.GE2EBatchSampler(datasets.PatternDataset(path), 4, 2, 40)


@pytest.mark.parametrize("shard", [(0, 1), (1, 2)], ids=["whole", "shard_1_of_2"])
def test_loader_matches_the_grain_loader(corpora, shard):
    port, jax_ = _batchers(corpora["legacy"][0])
    index, count = shard
    got = list(loader.make_loader(port, num_workers=0, seed=2, shard_index=index,
                                  shard_count=count, num_epochs=2))
    want = list(jgrain.make_grain_loader(jax_, worker_count=0, seed=2, shard_index=index,
                                         shard_count=count, num_epochs=2))
    assert len(got) == len(want) == 2 * loader.BatchPlanDataset(port).epoch_len
    for a, b in zip(got, want):
        assert a["tokens"].shape[0] == 4 // count
        _equal_batches(a, dict(b))


def test_loader_worker_processes_give_the_same_batches(corpora):
    port, _ = _batchers(corpora["legacy"][0])
    inline = list(loader.make_loader(port, num_workers=0, num_epochs=1))
    workers = list(loader.make_loader(port, num_workers=2, num_epochs=1))
    assert len(inline) == len(workers)
    for a, b in zip(inline, workers):
        _equal_batches(a, b)


def test_walkers_list_what_wav_io_reads(tmp_path):
    from multi_speaker_tts_tpu_torch.audio import wav_io

    lj = tmp_path / "lj"
    (lj / "wavs").mkdir(parents=True)
    wav_io.save_wav(lj / "wavs" / "a1.wav", np.zeros(400, np.float32), 16000)
    (lj / "metadata.csv").write_text("a1|raw|Hello one.\na2|raw|missing wav\nbad line\n")
    assert pg.lj_info_load(lj) == [(str(lj / "wavs" / "a1.wav"), "Hello one.", "LJ")]
    vctk = tmp_path / "vctk"
    for spk in ("p225", "p226"):
        (vctk / "wav48" / spk).mkdir(parents=True)
        (vctk / "txt" / spk).mkdir(parents=True)
        (vctk / "txt" / spk / f"{spk}_001.txt").write_text("Please call Stella.\n")
    wav_io.save_wav(vctk / "wav48" / "p225" / "p225_001.wav", np.zeros(400, np.float32), 16000)
    (vctk / "wav48" / "p226" / "p226_001_mic1.flac").write_bytes(b"fLaC")
    assert pg.vctk_info_load(vctk) == [
        (str(vctk / "wav48" / "p225" / "p225_001.wav"), "Please call Stella.", "p225")]
    (vctk / "wav48" / "p225" / "p225_001.wav").unlink()
    with pytest.raises(ValueError, match="flac"):
        pg.vctk_info_load(vctk)
