"""Build and bind the hand-written Hopper kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds). Libraries land in ``_kernels_build/`` beside the
package, named by a hash of the source, the shared header and the flags,
so an edited source rebuilds and an unchanged one is reused.

Every exported entry point returns a ``cudaError_t`` (0 = success) that
it read with ``cudaGetLastError`` right after its launches; :meth:`Kernel.call`
raises on anything else. Nothing here runs at import time: the CPU tests
import every module of the port on a machine without ``nvcc``. Builds and
first loads hold one lock, so threads that first use a kernel together
(a server's worker and its HTTP threads) build it once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch
from torch.utils.weak import WeakIdKeyDictionary

from multi_speaker_tts_tpu_torch.audio.dsp import log_dispatch

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent.parent / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_HEADERS = ("common.cuh", "lstm_persistent.cuh", "lstm_bwd.cuh", "bigru_step.cuh")
_BUILD_LOCK = threading.RLock()

P = ctypes.c_void_p  # every pointer and the stream
I = ctypes.c_int
F = ctypes.c_float


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = pathlib.Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(source: str) -> pathlib.Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for name in (source, *_HEADERS):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{pathlib.Path(source).stem}-{h.hexdigest()[:12]}.so"


def build(sources) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns ``{source: ptxas report}`` for what was compiled."""
    with _BUILD_LOCK:
        return _build(sources)


def _build(sources) -> dict[str, str]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[src] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    reports = {}
    for src, (out, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
        reports[src] = log
    return reports


class Kernel:
    """One ``csrc`` source: its lazily built library and a launch count.

    ``launches`` counts calls of the kernel's entry points that reached
    the card; the plain versions never touch it. An entry point launches
    its kernel once: a batch past one launch's rows is one call a row
    group (:meth:`call_groups`).
    """

    def __init__(self, name: str, source: str, functions: dict):
        self.name = name
        self.source = source
        self.functions = functions  # entry point -> ctypes argtypes
        self.launches = 0
        self._lib = None

    def lib(self):
        if self._lib is None:
            with _BUILD_LOCK:
                return self._load()
        return self._lib

    def _load(self):
        if self._lib is None:
            build([self.source])
            lib = ctypes.CDLL(str(_target(self.source)))
            for fn, argtypes in self.functions.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            lib.mstts_error_string.argtypes = [ctypes.c_int]
            lib.mstts_error_string.restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def call(self, fn: str, *args) -> None:
        lib = self.lib()
        err = getattr(lib, fn)(*args)
        if err != 0:
            msg = lib.mstts_error_string(err).decode()
            raise RuntimeError(f"{self.name}: {fn} failed: {msg} ({err})")
        self.launches += 1

    def call_groups(self, fn: str, args, groups, dims, stream: int, device) -> None:
        """Run a persistent recurrence's entry point once a row group: its
        arguments are ``args``, a grid-barrier counter, the ``dims`` (T, B[,
        D], H), the group's first row and its rows, then the stream. Each
        launch gets a zeroed counter of its own and counts once."""
        bar = torch.zeros(len(groups), dtype=torch.int32, device=device)
        for i, g in enumerate(groups):
            self.call(fn, *args, bar.data_ptr() + 4 * i, *dims, g.start, g.stop - g.start,
                      stream)


_PACKED = WeakIdKeyDictionary()


def packed(make, *weights):
    """``make(*weights)``, built once and reused: a kernel's constant operand
    layout (transposed, concatenated, cast) is rebuilt only when one of the
    weight tensors gets new storage or is changed in place (an optimizer's
    in-place update bumps ``_version``). ``make`` sees the weights detached:
    a layout is an operand of a kernel, never part of an autograd graph."""
    stamp = tuple((w.data_ptr(), w.device, w._version) for w in weights)
    per_make = _PACKED.setdefault(weights[0], {})
    hit = per_make.get(make)
    if hit is None or hit[0] != stamp:
        hit = per_make[make] = (stamp, make(*(w.detach() for w in weights)))
    return hit[1]


def supported(compute_dtype) -> bool:
    """The dtype half of the JAX package's capability checks
    (``lstm_pallas.supported``, ``birnn_pallas.supported``): the recurrence
    kernels compute in bf16 only."""
    return compute_dtype == torch.bfloat16


def plain_route(op: str, x, compute_dtype, refusal, reference_launches: bool) -> bool:
    """Whether a recurrence dispatcher (``lstm_stack_seq``, ``bilstm``,
    ``bigru``) takes the reference's plain route, the port's counterpart of
    the XLA scans the reference runs where its gate refuses its kernel:
    - a compute dtype the kernels do not take (:func:`supported`; an f32
      checkpoint), on any device;
    - on the card, a shape the port's kernels refuse (``refusal()``: why,
      or None; asked only here) that the reference's gate refuses too
      (``reference_launches`` False).
    Either prints one ``[dispatch]`` line a process on the card. Where the
    reference launches its kernel and the port's refuses, the kernel
    wrapper raises, as it does on an f32 tensor."""
    if not supported(compute_dtype):
        if x.is_cuda:
            log_dispatch(op, "plain", f"compute dtype {compute_dtype}: the kernels compute in "
                                      "bf16 only")
        return True
    if reference_launches or not x.is_cuda:
        return False
    why = refusal()
    if why is None:
        return False
    log_dispatch(op, "plain", f"{why}; the reference's gate refuses it too")
    return True


# The JAX package's lane: its recurrence and decode kernels take widths in
# multiples of it (``lstm_pallas.supported``, ``birnn_pallas.supported``,
# ``decode_pallas.supported``).
REFERENCE_LANE = 128


def reference_widths_ok(*widths: int) -> bool:
    """The width half of the JAX package's recurrence gates: every hidden
    size a multiple of :data:`REFERENCE_LANE`."""
    return all(w % REFERENCE_LANE == 0 for w in widths)


# An H100's SMs and opt-in shared memory a block (bytes): the card the
# wrappers' launch plans take on a CPU tensor, so that the CPU plans as the
# card does.
H100 = (132, 232448)


def card_limits(device) -> tuple[int, int]:
    """(SMs, opt-in shared memory a block in bytes) of a CUDA device, the
    H100's (:data:`H100`) for any other device."""
    device = torch.device(device)
    if device.type != "cuda":
        return H100
    return _cuda_limits(device.index if device.index is not None
                        else torch.cuda.current_device())


@functools.lru_cache(maxsize=None)
def _cuda_limits(index: int) -> tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def recurrence_grid(ndir: int, H: int, n_sm: int) -> tuple[int, int]:
    """``mstts_recurrence_grid`` (csrc/common.cuh): (U units a block, blocks
    a direction) of the persistent recurrences, one block an SM."""
    U = -(-ndir * H // n_sm)
    return U, -(-H // U)


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def k32_stride(k: int) -> int:
    """``mstts_k32_stride`` (csrc/common.cuh): the row stride of a bf16 tile
    read 16 bytes a lane in 32-wide k chunks."""
    s = round_up(k, 32)
    return s + 32 if (2 * s) % 128 == 0 else s


def stream_ptr(tensor) -> int:
    return torch.cuda.current_stream(tensor.device).cuda_stream


def require_cuda(tensor, dtype, name: str) -> None:
    """Wrapper-side checks before a pointer goes to a kernel."""
    if not tensor.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if tensor.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
