"""Bucketed, statically shaped training batches (port of
``multi_speaker_tts_tpu.data.datasets``), in numpy.

:class:`PatternDataset` reads the pattern pickles of
:mod:`.pattern_generator` (either package's); :class:`BucketBatcher` pads
every batch to one of ``Train.Batch_Bucketing``'s (token, mel) shapes, so
the train step sees a small set of shapes; :class:`GE2EBatchSampler` draws
N speakers x M utterances of fixed-length mel crops. The same numpy seeds
give the same batch plans and crops as the JAX package.
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np

from multi_speaker_tts_tpu_torch.data.collate import collate_tts

METADATA_FILE = "METADATA.PICKLE"


class PatternDataset:
    """The pattern pickles of one directory and their metadata index."""

    def __init__(self, pattern_dir: str | pathlib.Path, metadata_file: str = METADATA_FILE):
        self.pattern_dir = pathlib.Path(pattern_dir)
        with open(self.pattern_dir / metadata_file, "rb") as f:
            self.metadata = pickle.load(f)
        self.files = self.metadata["Files"]
        self.mel_lengths = np.asarray(self.metadata["Mel_Lengths"])
        self.token_lengths = np.asarray(self.metadata["Token_Lengths"])
        self.speakers = list(self.metadata["Speakers"])
        self.speaker_ids = {s: i for i, s in enumerate(sorted(set(self.speakers)))}
        self.indices_by_speaker: dict[str, list[int]] = {}
        for i, s in enumerate(self.speakers):
            self.indices_by_speaker.setdefault(s, []).append(i)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict:
        with open(self.pattern_dir / self.files[idx], "rb") as f:
            pattern = pickle.load(f)
        pattern["Speaker_ID"] = self.speaker_ids[self.speakers[idx]]
        return pattern


def _bucket_of(value: int, buckets: list[int]) -> int | None:
    """Smallest bucket >= value, or None if value exceeds all buckets."""
    for b in buckets:
        if value <= b:
            return b
    return None


class BucketBatcher:
    """Groups utterances into static (token_bucket, mel_bucket) shapes and
    yields full batches (a short last chunk is padded by repeating its
    items); utterances longer than the largest buckets are dropped."""

    def __init__(self, dataset: PatternDataset, batch_size: int, token_buckets: list[int],
                 mel_buckets: list[int], mel_dim: int, n_frames_per_step: int = 1,
                 ref_window: int | None = None, shuffle: bool = True, seed: int = 0,
                 drop_last: bool = False, spect_dim: int | None = None):
        self.ds = dataset
        self.batch_size = batch_size
        self.token_buckets = sorted(token_buckets)
        self.mel_buckets = sorted((b // n_frames_per_step) * n_frames_per_step
                                  for b in mel_buckets)
        self.mel_dim = mel_dim
        self.r = n_frames_per_step
        self.ref_window = ref_window
        self.spect_dim = spect_dim
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)
        self.assignment: dict[tuple[int, int], list[int]] = {}
        self.n_dropped = 0
        for i in range(len(dataset)):
            tb = _bucket_of(int(dataset.token_lengths[i]), self.token_buckets)
            mb = _bucket_of(int(dataset.mel_lengths[i]), self.mel_buckets)
            if tb is None or mb is None:
                self.n_dropped += 1
                continue
            self.assignment.setdefault((tb, mb), []).append(i)

    @property
    def bucket_shapes(self) -> list[tuple[int, int]]:
        return sorted(self.assignment.keys())

    def plan(self) -> list[tuple[tuple[int, int], list[int]]]:
        """One epoch's batches as (bucket shape, item indices), drawn from
        the batcher's generator."""
        plan = []
        for shape, idxs in self.assignment.items():
            idxs = list(idxs)
            if self.shuffle:
                self.rng.shuffle(idxs)
            for k in range(0, len(idxs), self.batch_size):
                chunk = idxs[k:k + self.batch_size]
                if len(chunk) < self.batch_size:
                    if self.drop_last:
                        continue
                    chunk = (chunk * self.batch_size)[:self.batch_size]
                plan.append((shape, chunk))
        if self.shuffle:
            self.rng.shuffle(plan)
        return plan

    def __iter__(self):
        """One epoch of (bucket shape, batch dict)."""
        for (tb, mb), chunk in self.plan():
            yield (tb, mb), collate_tts([self.ds[i] for i in chunk], tb, mb, self.mel_dim,
                                        self.r, self.ref_window, self.rng, self.spect_dim)


class GE2EBatchSampler:
    """N speakers x M utterances batches of fixed-length mel crops; a
    speaker needs at least two distinct utterances (a leave-one-out centroid
    of one utterance is degenerate)."""

    def __init__(self, dataset: PatternDataset, n_speakers: int, m_utterances: int,
                 frame_length: int, seed: int = 0):
        self.ds = dataset
        self.N = n_speakers
        self.M = m_utterances
        self.L = frame_length
        self.rng = np.random.default_rng(seed)
        self.eligible = [s for s, idxs in dataset.indices_by_speaker.items() if len(idxs) >= 2]
        if len(self.eligible) < n_speakers:
            raise ValueError(f"need >= {n_speakers} speakers with >= 2 utterances each, "
                             f"dataset has {len(self.eligible)}")

    def sample(self) -> dict[str, np.ndarray]:
        """mels (N M, L, mel_dim) grouped by speaker, and the N speaker ids."""
        speakers = self.rng.choice(self.eligible, size=self.N, replace=False)
        mel_dim = self.ds.metadata["Mel_Dim"]
        mels = np.zeros((self.N, self.M, self.L, mel_dim), np.float32)
        ids = np.zeros((self.N,), np.int32)
        for j, s in enumerate(speakers):
            idxs = self.ds.indices_by_speaker[s]
            chosen = self.rng.choice(idxs, size=self.M, replace=len(idxs) < self.M)
            for m, idx in enumerate(chosen):
                mel = self.ds[int(idx)]["Mel"]
                if mel.shape[0] >= self.L:
                    start = int(self.rng.integers(0, mel.shape[0] - self.L + 1))
                    mels[j, m] = mel[start:start + self.L]
                else:
                    mels[j, m, :mel.shape[0]] = mel
            ids[j] = self.ds.speaker_ids[s]
        return {"mels": mels.reshape(self.N * self.M, self.L, mel_dim), "speaker_ids": ids}
