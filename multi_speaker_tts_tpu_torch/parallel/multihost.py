"""The process group of a data-parallel run (port of
``multi_speaker_tts_tpu.parallel.multihost``).

The port trains data-parallel the PyTorch way: one process a device, on
one host or across hosts, joined by ``torch.distributed`` (NCCL between
cards, gloo on the CPU or, named explicitly, between processes that share a
card). Across hosts each process takes its card from its rank on its host
(the launcher's ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, or the training
CLI's ``-local_rank`` / ``-local_processes``), as the JAX package's TPU
pods take a coordinator and a process id. Each
process holds a full replica and its contiguous share of every global
batch's rows. The JAX package gets global-batch semantics from GSPMD; here
they are made by hand, so that one step of W processes equals the
single-process step on the global batch:

- every process's objective is its share (local numerators over global
  denominators), so the shares summed over processes are the global
  objective;
- the collectives inside the forward (:func:`all_reduce_autograd`: the
  BatchNorm statistics; :func:`all_gather_rows`: GE2E's embeddings) are
  autograd functions whose backward sums the processes' cotangents;
- the parameter gradients are then summed by :func:`all_reduce_sum`, so
  every process sees the same gradient, norm and update.

Without a process group (or with one of a single process) every function
here is the identity, so the single-device code path is the W = 1 case.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# This process's rank on its host and the processes on its host, once the
# group is joined: (0, 1) alone.
_LOCAL = (0, 1)


def local_placement(process_id: int, num_processes: int, local_rank: int | None = None,
                    local_processes: int | None = None) -> tuple[int, int]:
    """(rank on this host, processes on this host) of process ``process_id``
    of ``num_processes``: the arguments where given, else the launcher's
    ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE`` (``torchrun`` sets both); without
    a local rank the run is taken to be on one host, as before multi-host
    runs (rank ``process_id`` of ``num_processes``). A local rank without a
    host's process count counts local_rank + 1 processes here."""
    if local_rank is None and "LOCAL_RANK" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
    if local_processes is None and "LOCAL_WORLD_SIZE" in os.environ:
        local_processes = int(os.environ["LOCAL_WORLD_SIZE"])
    if local_rank is None:
        return process_id, num_processes
    if local_processes is None:
        local_processes = local_rank + 1
    if not 0 <= local_rank < local_processes <= num_processes:
        raise ValueError(f"local rank {local_rank} of {local_processes} process(es) on this "
                         f"host does not fit a world of {num_processes}")
    return local_rank, local_processes


def local_card(process_id: int, num_processes: int, backend: str,
               local_rank: int | None = None, local_processes: int | None = None) -> int:
    """The card of this process on its host: its local rank
    (:func:`local_placement`). The processes on this host are checked
    against this host's card count: NCCL takes one card a process, so more
    processes than cards raise unless ``backend="gloo"`` is named, which
    shares the cards round-robin (gloo takes CUDA tensors)."""
    rank, here = local_placement(process_id, num_processes, local_rank, local_processes)
    cards = torch.cuda.device_count()
    if here > cards and backend != "gloo":
        raise ValueError(f"{here} processes on this host over {cards} CUDA card(s): {backend} "
                         f"takes one card a process (name backend='gloo' to share cards)")
    return rank % cards


def local_rank() -> tuple[int, int]:
    """(rank on this host, processes on this host) of the joined group;
    (0, 1) without one."""
    return _LOCAL if process_count() > 1 else (0, 1)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, backend: str | None = None,
                           device="cuda", local_rank: int | None = None,
                           local_processes: int | None = None) -> torch.device:
    """Join the process group; returns this process's device.

    A no-op returning ``device`` when ``num_processes`` is None or at most
    1, as in the JAX package. Otherwise ``coordinator_address`` is the
    rendezvous: ``host:port`` (TCP, the address of process 0, reachable
    from every host) or a full ``file://`` / ``tcp://`` URL, and
    ``process_id`` the global rank. ``device`` ``"cuda"`` gives the process
    the card of its local rank (:func:`local_card`: ``local_rank`` /
    ``local_processes``, else ``LOCAL_RANK`` / ``LOCAL_WORLD_SIZE``, else
    one host: card ``process_id``) and the NCCL backend; ``"cpu"`` gives
    gloo. There is no quiet fall-back to the CPU."""
    global _LOCAL
    device = torch.device(device)
    if num_processes is None or num_processes <= 1:
        return device
    if coordinator_address is None or process_id is None:
        raise ValueError("a multi-process run needs the coordinator address and the "
                         "process id of every process")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, {num_processes})")
    placement = local_placement(process_id, num_processes, local_rank, local_processes)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        backend = backend or "nccl"
        device = torch.device("cuda", local_card(process_id, num_processes, backend, *placement))
        torch.cuda.set_device(device)
    else:
        backend = backend or "gloo"
    init = (coordinator_address if "://" in coordinator_address
            else f"tcp://{coordinator_address}")
    dist.init_process_group(backend, init_method=init, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(minutes=10))
    _LOCAL = placement
    return device


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    """Processes in the group (1 without one)."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (0 without a group)."""
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def checked_process_count(n_devices: int | None, rows: int, what: str) -> int:
    """The process count W of this run, after checking a trainer's
    ``n_devices`` (None or W: the port trains with one process a device)
    and that its batch's ``rows`` split over the processes."""
    W = process_count()
    if n_devices is not None and n_devices != W:
        raise ValueError(
            f"n_devices={n_devices} but this run has {W} process(es): the port trains "
            f"data-parallel with one process a device; start one process per card "
            f"(the training CLI's -distributed) and leave n_devices unset")
    if rows % W:
        raise ValueError(f"{what} ({rows}) must be divisible by the process count ({W})")
    return W


def host_shard_info() -> tuple[int, int]:
    """(shard_index, shard_count) for data loading in this process."""
    return process_index(), process_count()


def barrier(name: str = "barrier") -> None:
    """Block until every process reaches this point (no-op alone). Every
    process passes one before its first collective, so that set-up skew
    (loader workers, checkpoint reads) cannot run into a collective's
    timeout."""
    del name  # the processes meet in call order; the name documents the call site
    if process_count() > 1:
        dist.barrier()


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a collective on ``t`` runs: NCCL needs this process's card;
    gloo takes CPU and CUDA tensors where they are."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _flat_collective(tensors: list[torch.Tensor], op) -> list[torch.Tensor]:
    """``op`` (an in-place collective) on one flat buffer a (dtype, device)
    group of ``tensors``, the tensors concatenated in list order; returns
    the buffers' pieces shaped as the tensors."""
    groups: dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    out: list = [None] * len(tensors)
    for idx in groups.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        home = flat.device
        flat = flat.to(_comm_device(flat))
        op(flat)
        flat = flat.to(home)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


@torch.no_grad()
def all_reduce_sum(tensors: list[torch.Tensor]) -> list[torch.Tensor]:
    """The element-wise sum of ``tensors`` over the processes, as new
    tensors. Tensors of one dtype and device go flattened in list order
    into one buffer and one all-reduce, so every process gets the same
    bits."""
    if process_count() <= 1:
        return list(tensors)
    return _flat_collective(tensors, dist.all_reduce)


@torch.no_grad()
def broadcast_state(tensors: list[torch.Tensor], src: int = 0) -> None:
    """Overwrite ``tensors`` in place with process ``src``'s values (one
    broadcast per dtype and device)."""
    if process_count() <= 1:
        return
    for t, v in zip(tensors, _flat_collective(tensors, lambda flat: dist.broadcast(flat, src))):
        t.copy_(v)


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the processes; the backward sums the
    processes' cotangents of y."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum([x.contiguous()])[0].clone()

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum([g.contiguous()])[0].clone()


def all_reduce_autograd(x: torch.Tensor) -> torch.Tensor:
    """The sum of ``x`` over the processes, differentiable (identity alone)."""
    if process_count() <= 1:
        return x
    return _AllReduceSum.apply(x)


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every process's rows of ``x`` (equal leading sizes) stacked in rank
    order, differentiable: each process's rows are placed in a zero buffer
    of the global size and the buffers summed, so the rows are exact and
    the backward hands each process the sum of the processes' cotangents of
    its own rows."""
    W = process_count()
    if W <= 1:
        return x
    n, r = x.shape[0], process_index()
    pad = lambda k: x.new_zeros((k * n, *x.shape[1:]))  # noqa: E731
    return all_reduce_autograd(torch.cat([pad(r), x, pad(W - 1 - r)]))


def local_rows(n_global: int) -> slice:
    """This process's contiguous share of ``n_global`` rows."""
    W, r = process_count(), process_index()
    if n_global % W:
        raise ValueError(f"{n_global} rows do not split over {W} processes")
    n = n_global // W
    return slice(r * n, (r + 1) * n)


def global_rand(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """``torch.rand(shape)`` for this process's rows of a global batch: the
    draw is made at the global batch's shape (leading size x processes) from
    ``generator``, which every process holds in the same state, and this
    process's rows are kept. So the values equal the single-process draw's
    rows, and every process's generator advances alike."""
    W = process_count()
    if W <= 1:
        return torch.rand(shape, generator=generator, device=device)
    full = torch.rand((shape[0] * W, *shape[1:]), generator=generator, device=device)
    return full[local_rows(shape[0] * W)]
