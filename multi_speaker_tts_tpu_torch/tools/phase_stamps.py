"""Where a persistent kernel's time goes, phase by phase between its grid barriers.

The port's cooperative kernels (``csrc/decode.cu``, ``csrc/griffin_lim_dense.cu``)
split their work into phases separated by the grid barrier of ``common.cuh``.
This tool writes a copy of a kernel source with a ``clock64`` stamp at the
start and end of its ``__global__`` function and on both sides of every grid
barrier in it (thread 0 of the first and of the last block; a block barrier
before each arrival, so that a stamp marks the whole block's work), builds the
copy with the package's ``nvcc`` flags into ``_kernels_build/stamps/``, swaps
it into the wrapper's kernel for one run at the serving shapes, and prints the
cycles of every phase (from one barrier's wait to the next barrier's arrival)
and every barrier round, folded by the rounds of a step.

Run on the card from the root of a checkout::

    python multi_speaker_tts_tpu_torch/tools/phase_stamps.py decode --mode int8 --rounds 5
    python multi_speaker_tts_tpu_torch/tools/phase_stamps.py dense --rounds 2

``--repo DIR`` measures another checkout's package and sources (for example
the parent commit's, unpacked with ``git archive``) through the same wrapper
calls; run the file by its path then, so that the package is imported from
``DIR``. The stamps' own block barriers add a little to each phase. Cycles are
the SM's clock (``clock64``); nothing here runs on the CPU.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import pathlib
import re
import subprocess
import sys

import numpy as np

_HEADER = """
__device__ long long mstts_stamps[2][8192];
__device__ __forceinline__ void mstts_stamp(int n) {
  const int slot = blockIdx.x == 0 ? 0 : (blockIdx.x == gridDim.x - 1 ? 1 : -1);
  if (slot >= 0 && threadIdx.x == 0 && n < 8192) mstts_stamps[slot][n] = clock64();
}
"""
_READ = """
MSTTS_EXPORT int mstts_read_stamps(void* host) {
  return (int)cudaMemcpyFromSymbol(host, mstts_stamps, sizeof(mstts_stamps));
}
"""


def stamped_source(text: str, kernel: str, csrc: pathlib.Path) -> str:
    """``text`` with stamps in the body of every ``__global__`` function named
    ``kernel``: at its start and end, before each grid-barrier arrival
    (after a block barrier) and after each grid-barrier wait."""
    text = re.sub(r'#include "([^"]+)"', lambda m: f'#include "{csrc / m.group(1)}"', text)
    first_include_end = text.index("\n", text.index('common.cuh"')) + 1
    text = text[:first_include_end] + _HEADER + text[first_include_end:]
    out, pos = [], 0
    for m in re.finditer(r"__global__[^{;]*\b" + kernel + r"\s*\(", text):
        open_at = text.index("{", m.end())
        depth, i = 0, open_at
        while True:
            depth += {"{": 1, "}": -1}.get(text[i], 0)
            if depth == 0:
                break
            i += 1
        body = text[open_at + 1:i]
        lines = []
        for line in body.split("\n"):
            if "mstts_grid_barrier(" in line or "mstts_grid_arrive(" in line:
                lines.append("  __syncthreads(); mstts_stamp(mstts_stamp_n++);")
            lines.append(line)
            if "mstts_grid_barrier(" in line or "mstts_grid_wait(" in line:
                lines.append("  mstts_stamp(mstts_stamp_n++);")
        out.append(text[pos:open_at + 1])
        out.append("\n  int mstts_stamp_n = 0;\n  mstts_stamp(mstts_stamp_n++);"
                   + "\n".join(lines) + "\n  __syncthreads(); mstts_stamp(mstts_stamp_n++);\n")
        pos = i
    if not out:
        raise ValueError(f"no __global__ function {kernel} in the source")
    return "".join(out) + text[pos:] + _READ


def build(pkg_root: pathlib.Path, source: str, kernel: str):
    """Compile the stamped copy of ``csrc/<source>``; returns the library."""
    _build = importlib.import_module("multi_speaker_tts_tpu_torch.ops._build")
    csrc = pkg_root / "csrc"
    out_dir = pkg_root / "_kernels_build" / "stamps"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"stamped_{source}"
    cu.write_text(stamped_source((csrc / source).read_text(), kernel, csrc))
    so = cu.with_suffix(".so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the stamped {source}:\n{proc.stdout}{proc.stderr}")
    return ctypes.CDLL(str(so))


def swap(kernel_obj, lib) -> None:
    """Point a ``_build.Kernel`` at the stamped library."""
    for fn, argtypes in kernel_obj.functions.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.mstts_error_string.argtypes = [ctypes.c_int]
    lib.mstts_error_string.restype = ctypes.c_char_p
    lib.mstts_read_stamps.argtypes = [ctypes.c_void_p]
    kernel_obj._lib = lib


def fold(stamps: np.ndarray, rounds: int) -> dict:
    """Per-round phase and barrier cycles of one launch's stamps (start,
    before / after each barrier, end), folded by ``rounds`` a step after
    the first round (the launch's set-up)."""
    s = stamps[stamps > 0].astype(np.int64)
    n_bar = (len(s) - 2) // 2
    before, after = s[1:1 + 2 * n_bar:2], s[2:2 + 2 * n_bar:2]
    phase = np.concatenate([[before[0] - s[0]], before[1:] - after[:-1], [s[-1] - after[-1]]])
    wait = after - before
    steps = (n_bar - 1) // rounds
    body_p = phase[1:1 + steps * rounds].reshape(steps, rounds)
    body_w = wait[1:1 + steps * rounds].reshape(steps, rounds)
    total = float(body_p.sum() + body_w.sum()) / max(steps, 1)
    return {
        "set_up_cycles": int(phase[0] + wait[0]), "steps": steps, "cycles_a_step": round(total),
        "phase_cycles": [round(float(x)) for x in body_p.mean(axis=0)],
        "barrier_cycles": [round(float(x)) for x in body_w.mean(axis=0)],
        "phase_shares": [round(float(x) / total, 4) for x in body_p.mean(axis=0)],
        "barrier_shares": [round(float(x) / total, 4) for x in body_w.mean(axis=0)],
    }


def run_decode(mode: str, K: int, B: int = 4):
    import torch

    dk = importlib.import_module("multi_speaker_tts_tpu_torch.ops.decode_kernel")
    dscan = importlib.import_module("multi_speaker_tts_tpu_torch.ops.decoder_scan")
    LSTMParams = importlib.import_module("multi_speaker_tts_tpu_torch.ops.lstm").LSTMParams
    S, A, D, H, P, mel, r = 48, 128, 768, 1024, 256, 80, 2  # the serving shapes
    rng = np.random.default_rng(5)
    dev = torch.device("cuda")

    def w(*shape, s=0.02):
        return torch.from_numpy((rng.standard_normal(shape) * s).astype(np.float32)).to(dev)

    p = dscan.DecoderParams(
        lstm=(LSTMParams(w(P + D, 4 * H), w(H, 4 * H), w(4 * H)),
              LSTMParams(w(H + D, 4 * H), w(H, 4 * H), w(4 * H))),
        attention=dscan.AttentionParams(w(H, A), w(31, 2, 32, s=0.3), w(32, A, s=0.3),
                                        w(A, 1, s=0.3)),
        frame_proj=(w(H + D, mel * r), w(mel * r)), stop_proj=(w(H + D, 1), w(1)))
    prenet = [(w(mel, P, s=0.2), w(P)), (w(P, P, s=0.2), w(P))]
    bundle = dk.prepare_bundle(p, prenet, quantize=mode == "int8")
    keys, memory = w(B, S, A, s=0.3), w(B, S, D, s=0.3)
    mask = torch.ones(B, S, device=dev)
    keep = [torch.from_numpy(rng.random((K, B, P)) < 0.5).to(dev).float() / 0.5 for _ in range(2)]
    carry = dscan.initial_carry(B, memory, 2, H)
    prev = torch.zeros(B, mel, device=dev)
    return dk.KERNELS[mode], lambda: dk.decode_segment_kernel(
        bundle, keys, memory, mask, carry, prev, *keep, K, mel, r)


def run_dense(n_iter: int):
    import torch

    gk = importlib.import_module("multi_speaker_tts_tpu_torch.ops.griffin_lim_kernel")
    rng = np.random.default_rng(1)
    mag = torch.from_numpy(rng.random((4, 128, 513)).astype(np.float32) ** 2).cuda()
    mp, mny = gk.split_magnitude(mag, 1024)
    return gk.KERNEL, lambda: gk.griffin_lim_dense_kernel(mp, mny, 1024, 256, n_iter)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("kernel", choices=("decode", "dense"))
    ap.add_argument("--mode", choices=("int8", "bf16"), default="int8")
    ap.add_argument("--rounds", type=int, required=True, help="grid-barrier rounds a step")
    ap.add_argument("--steps", type=int, default=10, help="decode steps, or dense iterations")
    ap.add_argument("--repo", default=None, help="the checkout to measure (default: this one)")
    ap.add_argument("--batch", type=int, default=4,
                    help="decode batch rows, 1-16 (one launch; the serving batch is 4)")
    args = ap.parse_args(argv)
    if not 1 <= args.batch <= 16:
        ap.error("--batch takes 1-16 rows: the stamps are those of one launch")
    root = pathlib.Path(args.repo or pathlib.Path(__file__).resolve().parents[2]).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("phase_stamps needs a CUDA card")
    pkg = root / "multi_speaker_tts_tpu_torch"
    if args.kernel == "decode":
        kernel_obj, call = run_decode(args.mode, args.steps, args.batch)
        lib = build(pkg, "decode.cu", "decode_kernel")
    else:
        kernel_obj, call = run_dense(args.steps)
        lib = build(pkg, "griffin_lim_dense.cu", "gl_dense_kernel")
    swap(kernel_obj, lib)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    stamps = np.zeros((2, 8192), np.int64)
    lib.mstts_read_stamps(stamps.ctypes.data)
    name = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    for slot, block in ((0, "first block"), (1, "last block")):
        print(json.dumps({"checkout": str(root), "kernel": args.kernel, "mode": args.mode,
                          "batch": args.batch, "block": block, "card": name,
                          **fold(stamps[slot], args.rounds)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
