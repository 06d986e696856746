"""Batches off the training thread (port of
``multi_speaker_tts_tpu.data.grain_loader``, with ``torch.utils.data`` in
place of Grain).

:class:`BatchPlanDataset` is the JAX ``_BatchPlanSource``: a random-access
dataset whose item i is one fully collated batch. Its index space is
``epoch_len x virtual_epochs``; item i belongs to epoch ``i // epoch_len``,
whose plan (bucket membership, batch order) comes from
``default_rng([seed, epoch])`` and each row's reference crop from
``default_rng([seed, epoch, pos, row])``, so the batches are those of the
JAX loader (as tensors). Row sharding (``shard_index / shard_count``) collates only this
shard's contiguous slice of every batch. :func:`make_loader` serves it
through ``DataLoader(batch_size=None, num_workers=n)``.
"""

from __future__ import annotations

import numpy as np
import torch.utils.data

from multi_speaker_tts_tpu_torch.data.collate import collate_tts
from multi_speaker_tts_tpu_torch.data.datasets import BucketBatcher

# Distinct epoch plans before the cycle repeats.
VIRTUAL_EPOCHS = 2 ** 16


class BatchPlanDataset(torch.utils.data.Dataset):
    """Item i: the collated batch at position i of the epoch-keyed plans
    (this shard's rows), with its bucket shape under ``bucket``."""

    def __init__(self, batcher: BucketBatcher, seed: int = 0,
                 virtual_epochs: int = VIRTUAL_EPOCHS, shard_index: int = 0,
                 shard_count: int = 1):
        if batcher.batch_size % shard_count:
            raise ValueError(f"batch_size ({batcher.batch_size}) must be divisible by "
                             f"shard_count ({shard_count})")
        self.batcher = batcher
        self.seed = seed
        self.virtual_epochs = virtual_epochs
        self.shard_index = shard_index
        self.shard_count = shard_count
        bs = batcher.batch_size
        self.epoch_len = sum(-(-len(idxs) // bs) for idxs in batcher.assignment.values())
        self._plans: dict[int, list] = {}

    def _plan(self, epoch: int) -> list:
        plan = self._plans.get(epoch)
        if plan is not None:
            return plan
        rng = np.random.default_rng([self.seed, epoch])
        bs = self.batcher.batch_size
        plan = []
        for shape in sorted(self.batcher.assignment):
            idxs = list(self.batcher.assignment[shape])
            rng.shuffle(idxs)
            for k in range(0, len(idxs), bs):
                chunk = idxs[k:k + bs]
                if len(chunk) < bs:
                    chunk = (chunk * bs)[:bs]
                plan.append((shape, chunk))
        rng.shuffle(plan)
        # Workers walk epochs in order; prefetch straddles one boundary at most.
        self._plans = {e: p for e, p in self._plans.items() if e >= epoch - 1}
        self._plans[epoch] = plan
        return plan

    def __len__(self) -> int:
        return self.epoch_len * self.virtual_epochs

    def __getitem__(self, i: int) -> dict:
        epoch, pos = divmod(int(i), self.epoch_len)
        (tb, mb), chunk = self._plan(epoch)[pos]
        b = self.batcher
        local_bs = b.batch_size // self.shard_count
        rows = range(self.shard_index * local_bs, (self.shard_index + 1) * local_bs)
        batch = collate_tts([b.ds[chunk[r]] for r in rows], tb, mb, b.mel_dim, b.r,
                            b.ref_window, [np.random.default_rng([self.seed, epoch, pos, r])
                                           for r in rows], b.spect_dim)
        batch["bucket"] = np.asarray([tb, mb], np.int32)
        return batch


def make_loader(batcher: BucketBatcher, num_workers: int = 4, seed: int = 0,
                shard_index: int = 0, shard_count: int = 1,
                num_epochs: int | None = None) -> torch.utils.data.DataLoader:
    """A ``DataLoader`` of collated batches (dicts of CPU tensors) in plan
    order (no sampler shuffle: the plan already shuffled), ``num_workers``
    processes collating ahead; ``num_epochs`` passes over the dataset, None
    for as many as the trainer takes. Workers are spawned, not forked: the
    trainer's process holds a CUDA context and library threads."""
    source = BatchPlanDataset(batcher, seed, num_epochs or VIRTUAL_EPOCHS, shard_index,
                              shard_count)
    return torch.utils.data.DataLoader(
        source, batch_size=None, shuffle=False, num_workers=num_workers,
        prefetch_factor=2 if num_workers else None,
        persistent_workers=num_workers > 0,
        multiprocessing_context="spawn" if num_workers else None)
