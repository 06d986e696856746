"""Dense Griffin-Lim on a Hopper kernel, for any n_fft the route sends.

Replaces ``multi_speaker_tts_tpu/ops/griffin_lim_kernel.py::griffin_lim_pallas``
(kernel body ``_gl_kernel``): the vocoder for n_fft != 1024, or for any
size under ``GL_DENSE_KERNEL``. Same fixed-point map as that kernel (not as
:func:`..stft_matmul.griffin_lim_matmul`, whose re-framing reflect-pads the
cropped signal):

- the analysis window folded into the forward DFT matrices, the synthesis
  window and 1/N into the inverse ones, bins 0 .. n_fft/2 - 1 only; the
  Nyquist bin is real and rides outside the products as a rank-1 f32 term
  (:func:`_gl_operands`); the matrices in the compute dtype;
- zero-phase start re = mag, im = 0, Nyquist = its magnitude;
- overlap-add over the uncropped signal rows, round_up(T + k - 1, 8) of
  them, times the inverse window-square sum (:func:`_wsum_rows`);
- frame t re-framed from rows t .. t + k - 1 (the TPU kernel's circular
  rolls never wrap a nonzero row, so they are plain shifts here);
- projection ``mag / max(sqrt(|X|^2 + 1e-12), 1e-11)``; ``momentum`` > 0
  extrapolates X - beta P against the previous unprojected spectrum P
  (beta = m / (1 + m)) before it, with three f32 carries;
- n_iter + 1 inverses, then a centred crop of k/2 rows.

The TPU kernel keeps the spectra and the matrices in VMEM for all
iterations; ``csrc/griffin_lim_dense.cu`` runs the whole call as one
cooperative launch of two phases an iteration: an inverse phase whose units
own a column slice of [Vr; Vi] (resident in shared memory where it fits)
and overlap-add their frames into signal rows, and a forward phase whose
units read a slab of those rows in place against 32 bins of [Wr | Wi] (see
the source). Past n_fft 2048 the same launch takes more column slices
than SMs (a block takes several in turn), frame offsets in groups of 64
past k = 64, and each frame's hop columns in pieces where a slab of them no
longer fits; the matrices, 4 n_fft^2 bytes, stream from device memory.
:func:`pack_inverse` / :func:`pack_forward` lay the matrices out for it,
:func:`dense_plan` mirrors its tiling.
:func:`griffin_lim_dense_plain` is the same iteration in plain torch.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from multi_speaker_tts_tpu_torch.ops import _build
from multi_speaker_tts_tpu_torch.ops.numerics import rounded
from multi_speaker_tts_tpu_torch.ops.stft_matmul import _dft_matrices, _hann, _idft_matrices

LANE = 128
KERNEL = _build.Kernel("griffin_lim_dense", "griffin_lim_dense.cu", {
    "mstts_gl_dense": [_build.P] * 10 + [_build.I] * 6 + [_build.F, _build.P],
    "mstts_gl_dense_plan": [_build.I] * 5 + [_build.P],
    "mstts_gl_dense_launch_count": [_build.P],
})
# csrc/griffin_lim_dense.cu's tile constants.
TILE_N = 64  # columns of a block tile (both phases)
TILE_K = 128  # k-slice of a ring stage
RING_STAGES = 3  # forward ring
RING_STAGES_INV = 4  # inverse ring
MAX_M = 128  # rows of an inverse tile
MAX_F = 64  # frames of a forward tile
BINS = TILE_N // 2  # bins of a forward unit
MAX_BOX = 256  # rows of a tensor copy's box
H100_SMS = 132
H100_SMEM = 232448  # bytes a block can opt in to
PLAN_KEYS = ("k", "cs", "n_cs", "n_bs", "nr", "resident", "blocks", "rt", "m_out", "ft", "mf",
             "smem", "scratch", "qg", "ng", "pw", "wide")


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _gl_operands(n_fft: int, hop: int):
    """f32 copy of the JAX module's ``_gl_operands(n_fft, hop, "float32")``:
    windowed DFT / IDFT matrices for bins 0 .. n_fft/2 - 1, lane-padded to
    Fp, and the Nyquist bin's analysis / synthesis vectors in (rows8, hop)
    layout: (Wr, Wi, Vr, Vi, wny, vny, Fp). The compute-dtype rounding
    happens on the torch side (numpy has no bf16)."""
    F = n_fft // 2 + 1
    Fm = F - 1
    Fp = _round_up(Fm, LANE)
    win = _hann(n_fft).astype(np.float64)
    Wr, Wi = _dft_matrices(n_fft)
    Vr, Vi = _idft_matrices(n_fft)
    Wr_p = np.zeros((n_fft, Fp), np.float64)
    Wi_p = np.zeros((n_fft, Fp), np.float64)
    Wr_p[:, :Fm] = win[:, None] * Wr[:, :Fm]
    Wi_p[:, :Fm] = win[:, None] * Wi[:, :Fm]
    Vr_p = np.zeros((Fp, n_fft), np.float64)
    Vi_p = np.zeros((Fp, n_fft), np.float64)
    Vr_p[:Fm] = Vr[:Fm] * win[None, :]
    Vi_p[:Fm] = Vi[:Fm] * win[None, :]
    k = n_fft // hop
    sign = (-1.0) ** np.arange(n_fft)  # cos(pi n), exact
    rows8 = _round_up(k, 8)
    wny = np.zeros((rows8, hop), np.float64)
    vny = np.zeros((rows8, hop), np.float64)
    wny[:k] = (win * sign).reshape(k, hop)
    vny[:k] = (sign * win / n_fft).reshape(k, hop)
    return (*(m.astype(np.float32) for m in (Wr_p, Wi_p, Vr_p, Vi_p, wny, vny)), Fp)


def _wsum_rows(n_fft: int, hop: int, T: int, rows_pad: int) -> np.ndarray:
    """Inverse window-square OLA normalizer in (rows_pad, hop) layout."""
    k = n_fft // hop
    wsq = (_hann(n_fft).astype(np.float64) ** 2).reshape(k, hop)
    acc = np.zeros((rows_pad, hop), np.float64)
    for i in range(k):
        acc[i:i + T] += wsq[i]
    return (1.0 / np.maximum(acc, 1e-11)).astype(np.float32)


# From this n_fft on, a card's operands are computed on the card: the host's
# float64 copies of the four matrices would take tens of GB at 32768.
DEVICE_OPERANDS_N_FFT = 8192


def _gl_matrices_on(device: torch.device, n_fft: int):
    """:func:`_gl_operands`' four matrices computed on ``device``, step for
    step in float64 as numpy does there (the angles, the f32 DFT values,
    the windowed products), then f32."""
    f64 = torch.float64
    F = n_fft // 2 + 1
    Fm = F - 1
    Fp = _round_up(Fm, LANE)
    win = torch.from_numpy(_hann(n_fft)).to(device, f64)
    n = torch.arange(n_fft, device=device, dtype=f64)
    b = torch.arange(Fm, device=device, dtype=f64)
    w = torch.full((Fm, 1), 2.0, device=device, dtype=f64)
    w[0] = 1.0
    W = [torch.zeros((n_fft, Fp), device=device) for _ in range(2)]
    V = [torch.zeros((Fp, n_fft), device=device) for _ in range(2)]
    step = 2048  # rows of float64 temporaries at a time
    for i in range(0, n_fft, step):
        nn, ww = n[i:i + step], win[i:i + step]
        ang = -2.0 * torch.pi * nn[:, None] * b[None, :] / n_fft
        for out, fn in zip(W, (torch.cos, torch.sin)):
            out[i:i + step, :Fm] = (ww[:, None] * fn(ang).float().to(f64)).float()
    for i in range(0, Fm, step):
        bb, wi = b[i:i + step], w[i:i + step]
        ang = 2.0 * torch.pi * bb[:, None] * n[None, :] / n_fft
        for out, fn, sign in zip(V, (torch.cos, torch.sin), (1.0, -1.0)):
            out[i:i + step] = ((sign * wi * fn(ang) / n_fft).float().to(f64) * win[None, :]).float()
    return (*W, *V)


@functools.lru_cache(maxsize=8)
def _operands(n_fft: int, hop: int, device: torch.device, compute_dtype: torch.dtype):
    """Device tensors: the matrices rounded to the compute dtype (held f32,
    for the plain version), the Nyquist vectors (k, hop) f32, and the
    kernel's bf16 [Wr | Wi] (n_fft, 2 Fp) and [Vr; Vi] (2 Fp, n_fft). On a
    card from n_fft :data:`DEVICE_OPERANDS_N_FFT` on, the matrices are
    computed there (:func:`_gl_matrices_on`)."""
    k = n_fft // hop
    if device.type == "cuda" and n_fft >= DEVICE_OPERANDS_N_FFT:
        Fp = _round_up(n_fft // 2, LANE)
        win = _hann(n_fft).astype(np.float64)
        sign = (-1.0) ** np.arange(n_fft)
        wny = (win * sign).reshape(k, hop).astype(np.float32)
        vny = (sign * win / n_fft).reshape(k, hop).astype(np.float32)
        t = {name: rounded(m, compute_dtype)
             for name, m in zip(("Wr", "Wi", "Vr", "Vi"), _gl_matrices_on(device, n_fft))}
    else:
        Wr, Wi, Vr, Vi, wny, vny, Fp = _gl_operands(n_fft, hop)
        t = {name: rounded(torch.from_numpy(a).to(device), compute_dtype)
             for name, a in (("Wr", Wr), ("Wi", Wi), ("Vr", Vr), ("Vi", Vi))}
    t["wny"] = torch.from_numpy(np.ascontiguousarray(wny[:k])).to(device)
    t["vny"] = torch.from_numpy(np.ascontiguousarray(vny[:k])).to(device)
    t["wcat"] = torch.cat([t["Wr"], t["Wi"]], dim=1).to(torch.bfloat16).contiguous()
    t["vcat"] = torch.cat([t["Vr"], t["Vi"]], dim=0).to(torch.bfloat16).contiguous()
    return t, Fp


@functools.lru_cache(maxsize=16)
def _wsum_tensor(n_fft: int, hop: int, T: int, device: torch.device) -> torch.Tensor:
    rows_pad = _round_up(T + n_fft // hop - 1, 8)
    return torch.from_numpy(_wsum_rows(n_fft, hop, T, rows_pad)).to(device)


def slice_widths(n_fft: int, hop: int) -> tuple[int, int, int]:
    """(cs, qg, ng): the hop-columns of an inverse column slice, the frame
    offsets a group of it, and its groups. cs is the largest power of two
    up to 32 with k cs <= 64 (1 past k = 64), qg = min(k, 64 / cs)."""
    k = n_fft // hop
    cs = 32
    while cs > 1 and k * cs > TILE_N:
        cs //= 2
    qg = min(k, TILE_N // cs)
    return cs, qg, _ceil_div(k, qg)


def inverse_columns(n_fft: int, hop: int) -> np.ndarray:
    """The kernel's inverse column slices: (n_cs ng, 64) indices into the
    n_fft synthesis columns of [Vr; Vi], -1 for a zero pad column. Slice s
    takes hop-columns s cs .. s cs + cs - 1 at every frame offset q, in ng
    groups of qg offsets (:func:`slice_widths`): local column q cs + c of
    group g (row s ng + g) is synthesis column (g qg + q) hop + s cs + c,
    all that the overlap-add of a signal row needs."""
    k = n_fft // hop
    cs, qg, ng = slice_widths(n_fft, hop)
    cols = np.full((hop // cs * ng, TILE_N), -1, np.int64)
    for s in range(hop // cs):
        for q in range(k):
            g, qq = divmod(q, qg)
            cols[s * ng + g, qq * cs:(qq + 1) * cs] = q * hop + s * cs + np.arange(cs)
    return cols


def forward_columns(n_fft: int) -> np.ndarray:
    """The kernel's forward column groups: (n_fft/2 / 32, 64) indices into
    the 2 Fp columns of [Wr | Wi]. Group g, pair p: local columns 16 p ..
    16 p + 7 are Wr of bins 32 g + 8 p .. + 7, the next eight Wi of the same
    bins, so each warp's accumulators hold re and im of one bin."""
    Fp = n_fft // 2
    j = np.arange(TILE_N)
    p, w = j // 16, j % 16
    bins = np.arange(Fp // BINS)[:, None] * BINS + 8 * p[None] + w[None] % 8
    return np.where(w[None] < 8, bins, Fp + bins)


def core_matrices(cols: torch.Tensor) -> torch.Tensor:
    """(..., 64, K) columns with their k values -> (..., 8, K / 8, 8, 8): core
    matrices of 8 columns x 8 k (128 bytes in bf16), the 8 k of a column
    contiguous, the layout the kernel's wgmma reads without swizzle."""
    *lead, n, k = cols.shape
    return cols.reshape(*lead, n // 8, 8, k // 8, 8).transpose(-3, -2).contiguous()


def pack_inverse(vcat: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """[Vr; Vi] (2 Fp, n_fft) -> (n_cs ng, 8, 2 Fp / 8, 8, 8): each slice's 64
    columns (:func:`inverse_columns`, pad columns zero) as core matrices."""
    cols = torch.from_numpy(inverse_columns(n_fft, hop)).to(vcat.device)
    packed = vcat.t()[cols.clamp(min=0)]
    return core_matrices(torch.where((cols >= 0)[..., None], packed, torch.zeros_like(packed)))


def pack_forward(wcat: torch.Tensor, n_fft: int) -> torch.Tensor:
    """[Wr | Wi] (n_fft, 2 Fp) -> (Fp / 32, 8, n_fft / 8, 8, 8): each bin
    group's 64 columns (:func:`forward_columns`) as core matrices."""
    cols = torch.from_numpy(forward_columns(n_fft)).to(wcat.device)
    return core_matrices(wcat.t()[cols])


@functools.lru_cache(maxsize=8)
def _packed(n_fft: int, hop: int, device: torch.device):
    ops, _ = _operands(n_fft, hop, device, torch.bfloat16)
    return (pack_inverse(ops["vcat"], n_fft, hop), pack_forward(ops["wcat"], n_fft),
            ops["wny"].reshape(-1).contiguous(), ops["vny"].reshape(-1).contiguous())


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _align256(x: int) -> int:
    return _round_up(x, 256)


def dense_scratch_bytes(B: int, T: int, n_fft: int, hop: int, momentum: bool) -> int:
    """Device scratch of one kernel call: spectra (B, T, n_fft) bf16, signal
    rows (B, T + k - 1, hop) f32 and bf16, Nyquist values (B, T) f32, and
    under momentum two (B, T, n_fft/2) and one (B, T) f32 carries; each
    piece 256-byte aligned."""
    bt, rows = B * T, B * (T + n_fft // hop - 1) * hop
    s = _align256(2 * bt * n_fft) + _align256(4 * rows) + _align256(2 * rows) + _align256(4 * bt)
    if momentum:
        s += 2 * _align256(4 * bt * (n_fft // 2)) + _align256(4 * bt)
    return s


def slab_rows(mf: int, k: int) -> int:
    """``slab_rows`` in csrc/griffin_lim_dense.cu: a forward tile's rows of
    the signal, a multiple of 8, and past MAX_BOX of as many equal boxes."""
    r = _round_up(mf + k - 1, 8)
    return _round_up(r, 8 * _ceil_div(r, MAX_BOX))


def dense_plan(B: int, T: int, n_fft: int, hop: int, momentum: bool = False,
               n_sm: int = H100_SMS, max_smem: int = H100_SMEM) -> dict:
    """The kernel's tiling (``make_plan`` in ``csrc/griffin_lim_dense.cu``,
    step for step): the column slices, whether the inverse slice stays in
    shared memory, the block count, the inverse row tiles and the forward
    frame tiles, the shared memory and the scratch a call takes; the
    offsets a group of a slice and its groups (``qg``, ``ng``), the
    columns of a forward piece (``pw``), and whether the launch takes the
    kernel's wide instantiation (``wide``: more slices than SMs, groups,
    pieces, fewer than 4 hop-columns a slice or a slab in several boxes;
    every shape up to n_fft 2048 takes the other)."""
    k = n_fft // hop
    cs, qg, ng = slice_widths(n_fft, hop)
    p = {"k": k, "cs": cs, "n_cs": hop // cs, "n_bs": n_fft // 2 // BINS, "nr": T + k - 1,
         "qg": qg, "ng": ng}
    small = 4 * (MAX_M + TILE_N) + 8 * 8  # + the rings' eight mbarriers

    stage_b = 2 * TILE_N * TILE_K  # a ring stage of a matrix slice, core matrices

    def inverse_bytes(rows, resident):
        ring = 2 * RING_STAGES_INV * rows * TILE_K + (0 if resident else RING_STAGES_INV * stage_b)
        return max(ring, 4 * rows * (TILE_N + 4)) + 4 * rows * cs

    def forward_bytes(mf, pw):
        return RING_STAGES * stage_b + 2 * slab_rows(mf, k) * pw

    one_slice = p["n_cs"] <= n_sm and ng == 1

    def tiles():
        """(resident, pw, m_cap, mf_cap) in the kernel's order of preference."""
        for d in range(1, hop // TILE_K + 1):
            if hop % d or (hop // d) % TILE_K:
                continue
            for resident in ((1, 0) if one_slice and d == 1 else (0,)):
                avail = max_smem - (2 * TILE_N * n_fft if resident else 0) - small
                yield (resident, hop // d,
                       next((m for m in range(MAX_M, 15, -16)
                             if inverse_bytes(m, resident) <= avail), 0),
                       next((m for m in range(MAX_F, 15, -16)
                             if forward_bytes(m, hop // d) <= avail), 0))

    fit = next((t for t in tiles() if t[2] >= qg + 1 and t[3]), None)
    if fit is None:
        raise ValueError(f"no tiling of the dense kernel fits n_fft={n_fft}, hop={hop}")
    p["resident"], p["pw"], m_cap, mf_cap = fit
    base = 2 * TILE_N * n_fft if p["resident"] else 0
    blocks = n_sm // p["n_cs"] * p["n_cs"] if p["n_cs"] <= n_sm else n_sm
    best = None
    for rt in range(_ceil_div(p["nr"], m_cap - qg + 1), p["nr"] + 1):
        m_out = _ceil_div(p["nr"], rt)
        if _ceil_div(p["nr"], m_out) != rt:
            continue
        cost = _ceil_div(B * rt * p["n_cs"], blocks) * _ceil_div(m_out + qg - 1, 16) * ng
        if best is None or cost < best:
            best, p["rt"], p["m_out"] = cost, rt, m_out
    best = None
    for ft in range(_ceil_div(T, mf_cap), T + 1):
        mf = _ceil_div(T, ft)
        if _ceil_div(T, mf) != ft or _round_up(mf, 16) > mf_cap:
            continue
        cost = (_ceil_div(B * ft * p["n_bs"], blocks)
                * (TILE_N * n_fft * 2 + (mf + k - 1) * hop * 2))
        if best is None or cost < best:
            best, p["ft"], p["mf"] = cost, ft, mf
    p["wide"] = int(p["n_cs"] > n_sm or ng > 1 or p["pw"] != hop or cs < 4
                    or slab_rows(p["mf"], k) > MAX_BOX)
    units = max(B * p["rt"] * p["n_cs"], B * p["ft"] * p["n_bs"])
    p["blocks"] = min(blocks, _round_up(units, p["n_cs"]))
    p["smem"] = base + max(inverse_bytes(_round_up(p["m_out"] + qg - 1, 16), p["resident"]),
                           forward_bytes(_round_up(p["mf"], 16), p["pw"])) + small
    p["scratch"] = dense_scratch_bytes(B, T, n_fft, hop, momentum)
    return {key: p[key] for key in PLAN_KEYS}


def kernel_plan(B: int, T: int, n_fft: int, hop: int, momentum: bool = False) -> dict:
    """The plan the kernel computes for this card (``mstts_gl_dense_plan``)."""
    out = (ctypes.c_longlong * len(PLAN_KEYS))()
    lib = KERNEL.lib()
    err = lib.mstts_gl_dense_plan(B, T, n_fft, hop, int(momentum), ctypes.addressof(out))
    if err:
        raise RuntimeError(f"mstts_gl_dense_plan failed: {lib.mstts_error_string(err).decode()}")
    return dict(zip(PLAN_KEYS, out))


def kernel_launch_count() -> int:
    """The kernel launches ``csrc/griffin_lim_dense.cu`` has made since its
    library was loaded, counted in the library after each launch call (one a
    ``griffin_lim_dense_kernel`` call)."""
    out = ctypes.c_longlong()
    KERNEL.lib().mstts_gl_dense_launch_count(ctypes.addressof(out))
    return out.value


def split_magnitude(magnitude: torch.Tensor, n_fft: int):
    """(B, T, n_fft/2 + 1) -> bins 0 .. n_fft/2 - 1 zero-padded to Fp
    (B, T, Fp) and the Nyquist bin (B, T, 1), f32."""
    mag = magnitude.float()
    F = n_fft // 2 + 1
    Fp = _round_up(F - 1, LANE)
    mag_p = torch.nn.functional.pad(mag[..., :F - 1], (0, Fp - (F - 1))).contiguous()
    return mag_p, mag[..., F - 1:].contiguous()


def griffin_lim_dense_plain(mag_p: torch.Tensor, mag_ny: torch.Tensor, n_fft: int,
                            hop: int, n_iter: int, compute_dtype=torch.bfloat16,
                            momentum: float = 0.0) -> torch.Tensor:
    """``_gl_kernel``'s iteration: (B, T, Fp) + (B, T, 1) -> (B, hop (T - 1))."""
    B, T, _ = mag_p.shape
    k = n_fft // hop
    rows_pad = _round_up(T + k - 1, 8)
    ops, _ = _operands(n_fft, hop, mag_p.device, compute_dtype)
    wsum = _wsum_tensor(n_fft, hop, T, mag_p.device)
    vny, wny = ops["vny"].reshape(-1), ops["wny"].reshape(-1)

    def istft_rows(re, im, rny):
        frames = (rounded(re, compute_dtype) @ ops["Vr"] + rounded(im, compute_dtype) @ ops["Vi"]
                  + rny * vny)
        rows = frames.new_zeros((B, rows_pad, hop))
        for i in range(k):
            rows[:, i:i + T] += frames[..., i * hop:(i + 1) * hop]
        return rows * wsum

    def stft_of(rows):
        x = torch.cat([rows[:, i:i + T] for i in range(k)], dim=-1)  # (B, T, n_fft)
        xc = rounded(x, compute_dtype)
        return xc @ ops["Wr"], xc @ ops["Wi"], (x * wny).sum(dim=-1, keepdim=True)

    def project(x, m):
        return x * (m / torch.clamp(torch.sqrt(x * x + 1e-12), min=1e-11))

    mag_p, mag_ny = mag_p.float(), mag_ny.float()
    re, im, rny = mag_p, torch.zeros_like(mag_p), mag_ny
    beta = momentum / (1.0 + momentum)
    pre, pim, prny = torch.zeros_like(mag_p), torch.zeros_like(mag_p), torch.zeros_like(mag_ny)
    for _ in range(n_iter):
        re2, im2, rny2 = stft_of(istft_rows(re, im, rny))
        if momentum > 0.0:
            (re2, im2, rny2), (pre, pim, prny) = (
                (re2 - beta * pre, im2 - beta * pim, rny2 - beta * prny), (re2, im2, rny2))
        scale = mag_p / torch.clamp(torch.sqrt(re2 * re2 + im2 * im2 + 1e-12), min=1e-11)
        re, im, rny = re2 * scale, im2 * scale, project(rny2, mag_ny)
    rows = istft_rows(re, im, rny)
    return rows[:, k // 2:k // 2 + T - 1].reshape(B, (T - 1) * hop)


def griffin_lim_dense_kernel(mag_p: torch.Tensor, mag_ny: torch.Tensor, n_fft: int,
                             hop: int, n_iter: int, momentum: float = 0.0) -> torch.Tensor:
    """Launch ``csrc/griffin_lim_dense.cu`` on CUDA f32 magnitudes (bf16
    products): one cooperative launch a call."""
    _build.require_cuda(mag_p, torch.float32, "mag_p")
    _build.require_cuda(mag_ny, torch.float32, "mag_ny")
    B, T, Fp = mag_p.shape
    if (hop % 128 or n_fft % 256 or Fp != n_fft // 2 or T < 2
            or mag_ny.numel() != B * T):
        raise ValueError(f"the dense Griffin-Lim kernel takes a 128-multiple hop, n_fft in "
                         f"multiples of 256 and T >= 2 (got n_fft={n_fft}, hop={hop}, T={T})")
    dev = mag_p.device
    vpack, wpack, wny, vny = _packed(n_fft, hop, dev)
    wsum = _wsum_tensor(n_fft, hop, T, dev)
    scratch = torch.empty(dense_scratch_bytes(B, T, n_fft, hop, momentum > 0.0),
                          dtype=torch.uint8, device=dev)
    bar = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((B, (T - 1) * hop), dtype=torch.float32, device=dev)
    KERNEL.call(
        "mstts_gl_dense", mag_p.data_ptr(), mag_ny.data_ptr(), vpack.data_ptr(),
        wpack.data_ptr(), wny.data_ptr(), vny.data_ptr(), wsum.data_ptr(), scratch.data_ptr(),
        bar.data_ptr(), out.data_ptr(), B, T, n_fft, hop, n_iter, int(momentum > 0.0),
        momentum / (1.0 + momentum), _build.stream_ptr(mag_p),
    )
    return out


def griffin_lim_dense(magnitude: torch.Tensor, n_fft: int, hop: int, n_iter: int,
                      compute_dtype=torch.bfloat16, momentum: float = 0.0) -> torch.Tensor:
    """Batched dense Griffin-Lim: (B, T, n_fft/2 + 1) -> (B, hop (T - 1)).
    The kernel for a CUDA tensor (bf16 products; it raises for a hop that
    is not a 128-multiple), the plain version for a CPU tensor."""
    if n_fft % hop or (n_fft // hop) % 2:
        raise ValueError(f"the centred crop needs an even n_fft/hop ratio "
                         f"(got n_fft={n_fft}, hop={hop})")
    if magnitude.shape[-1] != n_fft // 2 + 1:
        raise ValueError(f"magnitude has {magnitude.shape[-1]} bins, n_fft={n_fft} "
                         f"needs {n_fft // 2 + 1}")
    mag_p, mag_ny = split_magnitude(magnitude, n_fft)
    if mag_p.is_cuda:
        if compute_dtype != torch.bfloat16:
            raise NotImplementedError("the dense Griffin-Lim kernel computes in bf16 only")
        return griffin_lim_dense_kernel(mag_p, mag_ny, n_fft, hop, n_iter, momentum)
    return griffin_lim_dense_plain(mag_p, mag_ny, n_fft, hop, n_iter, compute_dtype, momentum)
