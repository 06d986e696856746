"""The devices one process drives in sharded synthesis (port of
``multi_speaker_tts_tpu.parallel.mesh``).

The JAX mesh is a 1-D ``data`` axis over devices, batches sharded over it
and parameters replicated. The port's mesh is the ordered list of
``torch.device``s: :func:`shard_rows` gives device i its contiguous slice
of a batch (as ``P("data")`` does) and :func:`replicate` one copy of a
module's weights a device. Training does not use it: the port trains
data-parallel with one process a device (:mod:`.multihost`).
"""

from __future__ import annotations

import copy

import torch
from torch import nn


def create_mesh(n_devices: int | None = None, devices=None) -> list[torch.device]:
    """The first ``n_devices`` of ``devices`` (default: every local CUDA
    card). A device may repeat (``["cuda:0", "cuda:0"]``: two shards on one
    card)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=[...] (e.g. CPU devices)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [_indexed(torch.device(d)) for d in devices]
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(f"{n_devices} devices asked, {len(devices)} given")
        devices = devices[:n_devices]
    if not devices:
        raise ValueError("an empty mesh")
    return devices


def _indexed(d: torch.device) -> torch.device:
    """``cuda`` -> ``cuda:<current card>``, so equal devices compare equal."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def shard_rows(x: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Rows ``[i B/n, (i+1) B/n)`` of ``x`` (B divisible by ``n``)."""
    B = x.shape[0]
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} devices")
    return x[i * (B // n):(i + 1) * (B // n)]


def replicate(module: nn.Module, devices) -> dict[torch.device, nn.Module]:
    """One copy of ``module`` on each distinct device (``module`` itself
    where it already lives)."""
    home = next(module.parameters()).device
    out = {}
    for d in devices:
        d = _indexed(torch.device(d))
        if d not in out:
            out[d] = module if d == home else copy.deepcopy(module).to(d)
    return out
