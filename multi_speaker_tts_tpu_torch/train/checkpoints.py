"""Training checkpoints (port of ``multi_speaker_tts_tpu.train.checkpoints``).

:class:`CheckpointManager` saves a training state every N steps as one
torch state file a step, ``<directory>/<step>/state.pt`` (``torch.save`` of
a dict of the params, batch statistics, optimizer state and step), keeps the
newest ``max_to_keep`` and restores the latest, in place of Orbax's step
directories. :func:`export_compact` writes the inference weights as one
msgpack file of f16 floats in the layout of the JAX package's
``export_compact`` (the port's own writer, :func:`..checkpoints.packb`):
each package's ``load_compact`` reads the other's.
"""

from __future__ import annotations

import os
import pathlib
import shutil

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.checkpoints import packb

STATE_FILE = "state.pt"


class CheckpointManager:
    """Step-indexed save and restore of a training state dict."""

    def __init__(self, directory: str | pathlib.Path, max_to_keep: int = 5):
        self.directory = pathlib.Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list[int]:
        return sorted(int(d.name) for d in self.directory.iterdir()
                      if d.name.isdigit() and (d / STATE_FILE).exists())

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` (tensors, numpy arrays, numbers and nested dicts /
        lists of them) as step ``step``; a partial write never shows as a
        step (written to a temporary name, then renamed)."""
        target = self.directory / str(step)
        tmp = self.directory / f".{step}.tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(state, tmp / STATE_FILE)
        shutil.rmtree(target, ignore_errors=True)
        os.replace(tmp, target)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self.directory / str(old))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, template=None, step: int | None = None):
        """-> (state, step), or (None, None) when there is no checkpoint.
        ``template``: a state dict whose keys the restored one must have
        (None: no check)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return None, None
        state = torch.load(self.directory / str(step) / STATE_FILE, map_location="cpu",
                           weights_only=False)
        if template is not None and set(template) != set(state):
            raise ValueError(f"checkpoint step {step} holds {sorted(state)}, "
                             f"expected {sorted(template)}")
        return state, step

    def close(self) -> None:
        pass


def _compact(tree):
    if isinstance(tree, dict):
        return {k: _compact(v) for k, v in tree.items()}
    x = np.asarray(tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree)
    return x.astype(np.float16) if x.dtype == np.float32 else x


def export_compact(path: str | pathlib.Path, params: dict, batch_stats: dict,
                   meta: dict | None = None) -> None:
    """Write inference weights as one msgpack file: ``{"params",
    "batch_stats", "meta"}``, the JAX trees (e.g. from
    :func:`..weights.params_to_jax`) with f32 leaves stored as f16, and a
    small JSON-able ``meta`` (``{"hp": hp.to_dict()}`` for ``from_compact``)."""
    payload = {"params": _compact(params), "batch_stats": _compact(batch_stats),
               "meta": meta or {}}
    pathlib.Path(path).write_bytes(packb(payload))
