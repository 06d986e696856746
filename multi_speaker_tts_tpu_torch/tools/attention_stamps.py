"""Where the fused attention step's time goes, phase by phase (on the card).

Writes a copy of ``csrc/attention_step.cu`` with a stamp (``%globaltimer``
and ``clock64``, thread 0 of every block, after a block barrier) at the
start of each phase of the kernel (:data:`ANCHORS`), builds it with the
package's ``nvcc`` flags into ``_kernels_build/stamps/``, swaps it into the
wrapper's kernel, and runs one step at each shape queued behind a spin of
the card (20 steps; the last one's stamps are read). Prints, per shape, the
kernel's own card time a step (unstamped), the launch plan, each phase's
median and largest time over the blocks, and the SM clock over the kernel. The stamps' own block
barriers add a little to each phase.

Run on the card from the root of a checkout::

    python -m multi_speaker_tts_tpu_torch.tools.attention_stamps [--shape B S A D H ...]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch
import torch.nn.functional as F

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops import attention_step_kernel as ask
from multi_speaker_tts_tpu_torch.tools import attention_probe as probe

# (line of csrc/attention_step.cu, the phase that starts there). A stamp
# goes just before each line; the last stamp after the kernel's final
# cluster barrier.
ANCHORS = (
    ("  // q, this block's columns", "q loads and FMAs"),
    ("    // The copies, in the order the step needs them", "q reduction"),
    ("  cluster_arrive();  // 1", "cluster arrive 1, location conv"),
    ("  cluster_wait();  // 1", "cluster wait 1, q gather"),
    ("  mstts_mbar_wait(bars, 0);  // wloc", "keys wait"),
    ("  // Energies: warp w", "energies"),
    ("  // The additive mask", "mask, softmax statistics"),
    ("  // Context partials over", "context partials"),
    ("  cluster.sync();  // 2", "cluster barrier 2"),
    ("  // The weights of this block's positions", "weights, context sums"),
    ("  cluster.sync();  // 3", "cluster barrier 3"),
)
_FIRST = "  const int nchunks = rows * nblk;\n"
_LAST = "  cluster.sync();  // 3: no block leaves while another reads its shared memory\n"
_HEADER = """
__device__ unsigned long long mstts_st[4096][16];
__device__ long long mstts_ck[4096][16];
#define MSTTS_STAMP(i) do { __syncthreads(); if (threadIdx.x == 0) { unsigned long long t_; \\
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_)); mstts_st[blockIdx.x][i] = t_; \\
  mstts_ck[blockIdx.x][i] = clock64(); } } while (0)
"""
_READ = """
MSTTS_EXPORT int mstts_read_stamps(void* times, void* clocks) {
  cudaError_t e = cudaMemcpyFromSymbol(times, mstts_st, sizeof(mstts_st));
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(clocks, mstts_ck, sizeof(mstts_ck));
  return (int)e;
}
"""


def stamped_source(text: str) -> str:
    """``text`` (the kernel's source) with a stamp before every anchor, one
    at the start and one at the end; raises if an anchor is not found once."""
    text = text.replace('#include "common.cuh"', f'#include "{_build.CSRC / "common.cuh"}"')
    head_end = text.index("\n", text.index("common.cuh")) + 1
    text = text[:head_end] + _HEADER + text[head_end:]
    for line in (_FIRST, _LAST, *(a for a, _ in ANCHORS)):
        if text.count(line) != 1:
            raise ValueError(f"anchor not found once in attention_step.cu: {line!r}")
    text = text.replace(_FIRST, _FIRST + "  MSTTS_STAMP(0);\n")
    for i, (line, _) in enumerate(ANCHORS, start=1):
        text = text.replace(line, f"  MSTTS_STAMP({i});\n" + line)
    return text.replace(_LAST, _LAST + f"  MSTTS_STAMP({len(ANCHORS) + 1});\n") + _READ


def _load_stamped():
    out = _build.BUILD_DIR / "stamps"
    out.mkdir(parents=True, exist_ok=True)
    src, lib_path = out / "attention_step_stamped.cu", out / "attention_step_stamped.so"
    src.write_text(stamped_source((_build.CSRC / "attention_step.cu").read_text()))
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on the stamped source:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    for fn, argtypes in ask.KERNEL.functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.mstts_error_string.argtypes = [ctypes.c_int]
    lib.mstts_error_string.restype = ctypes.c_char_p
    lib.mstts_read_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


def phases(B: int, S: int, A: int, D: int, H: int, lib) -> dict:
    """One step at the probe's inputs of this shape through the stamped
    kernel: card time, plan, and per phase the median and largest us."""
    args = probe.parser().parse_args(["-B", str(B), "-S", str(S), "-A", str(A), "-D", str(D),
                                      "-H", str(H)])
    ap, keys, memory, mask, h0, w0, cum0 = probe.probe_inputs(args, 0, "cuda")
    K = ap.conv_kernel.shape[0]
    borders = ((K - 1) // 2, K - 1 - (K - 1) // 2)
    step = (h0, F.pad(w0, borders), F.pad(cum0, borders), keys, memory, ask.maskadd_of(mask), ap)
    us = probe.step_card_us(lambda: ask.attention_step_kernel(*step))  # the kernel itself
    saved, ask.KERNEL._lib = ask.KERNEL.lib(), lib
    try:
        ask.attention_step_kernel(*step)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        for _ in range(20):
            ask.attention_step_kernel(*step)
        torch.cuda.synchronize()
    finally:
        ask.KERNEL._lib = saved
    times = np.zeros((4096, 16), np.uint64)
    clocks = np.zeros((4096, 16), np.int64)
    err = lib.mstts_read_stamps(times.ctypes.data, clocks.ctypes.data)
    if err != 0:
        raise RuntimeError(f"reading the stamps failed ({err})")
    plan = ask.kernel_plan(B, S, A, D, K, ap.conv_kernel.shape[2], ask.max_clusters("cuda"))
    n = len(ANCHORS) + 2
    t = times[:plan["blocks"], :n].astype(np.int64)
    d = np.diff(t, axis=1) / 1e3
    names = ["prologue", *(name for _, name in ANCHORS)]
    mhz = (clocks[:plan["blocks"], n - 1] - clocks[:plan["blocks"], 0]) / (t[:, -1] - t[:, 0]) * 1e3
    return {"card_us": us, "plan": plan, "sm_mhz": float(np.median(mhz)),
            "first_to_last_us": float((t[:, -1].max() - t[:, 0].min()) / 1e3),
            "phases_us": {name: (float(np.median(d[:, i])), float(d[:, i].max()))
                          for i, name in enumerate(names)}}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--shape", type=int, nargs=5, action="append", metavar=("B", "S", "A", "D", "H"),
                   help="default: the probe's (96 100 128 512 1024) and the train phase's "
                        "(32 64 128 768 1024)")
    args = p.parse_args(argv)
    shapes = args.shape or [[96, 100, 128, 512, 1024], [32, 64, 128, 768, 1024]]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip()
    print(f"card: {smi or torch.cuda.get_device_name(0)}")
    lib = _load_stamped()
    for shape in shapes:
        r = phases(*shape, lib)
        print(f"B S A D H {shape}: {r['card_us']:.2f} us a step (card time, the unstamped "
              f"kernel); plan {r['plan']}; stamped step {r['first_to_last_us']:.2f} us from the "
              f"first block's start to the last's end; SM clock {r['sm_mhz']:.0f} MHz")
        for name, (med, top) in r["phases_us"].items():
            print(f"  {name:>34}: median {med:6.2f} us, largest {top:6.2f} us")


if __name__ == "__main__":
    main()
