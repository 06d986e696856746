// Dense Griffin-Lim for any n_fft with a 128-multiple hop and an even
// n_fft / hop: one persistent launch a call.
//
// Replaces multi_speaker_tts_tpu/ops/griffin_lim_kernel.py::griffin_lim_pallas
// (kernel body _gl_kernel). Same fixed-point map: zero-phase start (re = mag,
// im = 0), the windowed inverse DFT of bins 0 .. n_fft/2 - 1 as one product
// against the stacked [Vr; Vi] (synthesis window and 1/N folded in), the
// Nyquist bin as a rank-1 f32 term, overlap-add over the uncropped signal
// rows normalised by the inverse window-square sum, re-framing frame t from
// rows t .. t + k - 1, the windowed forward DFT as one product against
// [Wr | Wi], the Nyquist analysis as an f32 dot product, the projection
// mag / max(sqrt(|X|^2 + 1e-12), 1e-11), n_iter + 1 inverses, and the
// centred crop of k/2 rows. The DFT matrices and the product operands are
// bf16 with f32 accumulation; magnitudes, spectra sums, signal rows and the
// Nyquist terms are f32. The momentum mode keeps three f32 carries, the
// previous unprojected re, im and Nyquist value, and extrapolates X - beta P
// before each projection, as the TPU kernel's body_m.
//
// What bounds it on an H100: by bytes and operations, the tensor-core
// operations (4.2 MFLOP a frame and iteration at n_fft 1024: B = 4, T = 128,
// 60 iterations is 130 GFLOP, 0.13 ms at 989 TFLOP/s). The iteration is a
// chain of dependent all-to-all steps over an utterance, so the floor of
// this design is its grid barriers: 2 n_iter + 1 rounds on its grid.
//
// Design: one cooperative launch, at most one block an SM, two phases an
// iteration, each ended by the grid barrier of common.cuh. A block tile is
// up to 128 frames x 64 columns; k advances in slices of 128 through a ring
// of shared-memory stages (4 in the inverse, 3 in the forward) that the TMA
// unit fills: one thread issues a stage's tensor copies on the stage's
// mbarrier, every thread waits on its phase, and no thread stalls issuing
// 16-byte copies (with cp.async the issuing warps stalled for most of the
// copies' time and the products waited behind them). The products run on
// wgmma m64n64k16, one 64-row tile a warpgroup: A fragments in registers
// (ldmatrix from 128-byte swizzled panels, the TMA unit's layout), the
// matrix slice read through a descriptor as core matrices of 8 columns x 8
// k (the host packs it so; no swizzle). Every warpgroup issues the same
// products in straight-line code: a warpgroup past the tile's rows
// multiplies rows it does not store, and the copies are predicated inside
// their asm, not branched around, since a branch between products makes
// the compiler wait after every wgmma. The ring keeps one slice's
// products in flight while the next slice is awaited and loaded (two
// fragment buffers).
//
//   inverse (unit: utterance, a tile of m_out signal rows, a column slice):
//     a column slice is cs hop-columns c taken at all k frame offsets q, the
//     64 synthesis columns q hop + c (k cs <= 64, zero-padded to 64): all a
//     signal row needs from each frame under it. The unit multiplies the
//     spectra of the m_out + k - 1 frames under its rows (bf16 [re | im],
//     written by the forward phase; frames outside the utterance arrive as
//     zeros, the box leaving the tensor) by the slice of [Vr; Vi], adds the
//     Nyquist term, overlap-adds the k frames of each row in the plain
//     version's order, normalises, and writes the rows once, f32 and bf16.
//     The k - 1 halo frames at the tile's head are recomputed by every
//     owner: no exchange of partial rows, and the sums stay in a fixed order.
//   forward (unit: utterance, a tile of up to 64 frames, 32 bins): frame t's
//     operand is rows t .. t + k - 1 of the bf16 signal, so the tile's
//     operand is the contiguous slab of rows, loaded once and read in place
//     (hop / 64 panels; the k-slice at q hop + c0 is row t + q), not mf
//     frames of n_fft. The two warpgroups each take 4 of a slice's 8
//     k-steps, hand each other their share of the other's half of the rows
//     through shared memory, and each projects its half. Its 64 columns of
//     [Wr | Wi] hold re and im of each bin in neighbouring n-tiles, so the
//     momentum and the projection run on the accumulators in registers; the
//     projected spectra leave as bf16, the product operand of the next
//     inverse. Each unit also computes the f32 Nyquist analysis of every
//     n_bs-th frame of its tile from the f32 rows, one warp a frame.
//
// Where the slices are no more than the SMs a block keeps one column slice
// for the whole launch. Where it fits (n_fft <= 1024; 128 KB at 1024) that
// slice of [Vr; Vi] stays in shared memory, loaded once; otherwise it
// streams through the ring with the spectra.
// L2 bytes a block moves a phase (B 4, T 128, n_fft 1024, hop 256, 128
// blocks: 16 slices x 8 blocks; inverse units of 66 rows, boxes of 72
// frames; forward units of 64 frames):
//   inverse: 72 frames x 2 KB of spectra = 144 KB (the matrix slice is
//     resident); out: 66 rows x 16 columns, f32 + bf16, 6 KB;
//   forward: the slab 72 x 512 B = 36 KB, 64 columns x 1024 of [Wr | Wi] =
//     128 KB, four frames of f32 rows for the Nyquist term = 16 KB; out: 64
//     frames x 32 bins x 2 bf16 = 8 KB.
// make_plan picks the tiles (ops/griffin_lim_kernel.py::dense_plan mirrors
// it and the tests hold the two equal).
//
// Past n_fft 2048 (what the reference's gate admits up to n_fft 65536, T
// 20): the n_fft / 64 column slices outnumber the SMs from 8704, so a block
// takes units of slices j, j + blocks, ... in turn within the one launch
// (every inverse unit names its slice). Past k = 64 frame offsets (hop 128
// past n_fft 8192) a slice is one hop-column whose k offsets come in groups
// of 64: a unit multiplies the frames under its rows for each group in turn
// (a box of rows + 63 frames; a group none of whose frames lie in the
// utterance adds nothing and is skipped) and sums the groups' overlap-adds
// in a register, offsets in the plain version's order. With fewer than 4
// hop-columns a slice (k >= 32) the epilogue runs a thread a (row,
// column). Where a forward tile's slab of rows (mf + k - 1 rows of hop
// bf16) no longer fits beside the ring (hop 4096, or 2048 at k 32), each frame's
// hop columns are taken in pieces of pw (a divisor of hop, a multiple of
// 128): the slab holds one piece's panels, the ring runs over that piece's
// k-slices, and the accumulators carry over the pieces, the same products
// summed in another order. Slabs past 256 rows (k > 241) arrive in several
// tensor boxes. The matrices (4 n_fft^2 bytes: 1 GiB at 16384) stream from
// device memory every iteration; that and the grid barriers bound it. These
// shapes run a second instantiation (kWide, Plan::wide). A shape with one
// slice a block, one group, whole frames and four hop-columns a slice or
// more (every one up to n_fft 2048, and 4096 / 512) keeps the first, which
// does not carry the second's code (with it the production build spilled
// and ran 9% slower on an H100).
#include <cuda.h>

#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // two warpgroups
constexpr int kWarps = kThreads / 32;
constexpr int kN = 64;         // columns of a block tile, both phases
constexpr int kK = 128;        // k-slice of a ring stage
constexpr int kPanel = 64;     // columns of a swizzled operand panel: 128-byte rows
constexpr int kStages = 3;     // forward ring depth: two slices in flight
constexpr int kStagesI = 4;    // inverse ring depth: three slices in flight
constexpr int kMaxM = 128;     // rows of an inverse tile: two 64-row tiles
constexpr int kMaxF = 64;      // frames of a forward tile: one 64-row tile
constexpr int kLdF = kN + 4;   // f32 frame tile row of the inverse epilogue
constexpr int kBins = kN / 2;  // bins of a forward unit
constexpr int kMaxBox = 256;   // rows of a tensor copy's box
// The rings' barriers: the inverse stages, the forward stages, the slab.
constexpr int kBarF = kStagesI, kBarSlab = kStagesI + kStages, kBars = kBarSlab + 1;
// The Nyquist values of a tile's frames, the block's slice of the Nyquist
// synthesis vector, and the barriers.
constexpr size_t kSmall = sizeof(float) * (kMaxM + kN) + 8 * kBars;

// The launch's tiling; make_plan fills it.
struct Plan {
  int k, cs, n_cs, n_bs, nr;  // frame offsets, hop-columns a slice, slices, bin groups, rows
  int qg, ng;                 // frame offsets a group of a slice, groups (k > 64: 64, k / 64)
  int pw;                     // forward: columns of a frame's piece (hop, or a divisor of it)
  int wide;                   // any of the above past one slice a block, one group, whole
                              // frames, cs >= 4 or one slab box: the kWide instantiation
  int resident;               // the inverse slice stays in shared memory
  int blocks;                 // a multiple of n_cs where n_cs <= SMs: block j serves slice j % n_cs
  int rt, m_out;              // inverse: row tiles an utterance, rows a tile
  int ft, mf;                 // forward: frame tiles an utterance, frames a tile
  int smem;
  long long scratch;          // bytes of the scratch the wrapper allocates
};

__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }

size_t align256(size_t x) { return (x + 255) / 256 * 256; }

// A matrix slice is held as core matrices (8 columns x 8 k, 128 bytes):
// [8 column blocks][k / 8][8][8], the layout wgmma reads (no swizzle).
__host__ __device__ size_t resident_bytes(int n_fft) { return sizeof(bf16) * (size_t)kN * n_fft; }

constexpr size_t kStageB = sizeof(bf16) * kN * kK;  // a ring stage of a matrix slice

// Inverse: the ring of spectra slices for tiles of up to `rows` frames
// (and, streamed, of matrix slices), or the f32 frame tile over it; then
// the tile's normaliser columns (rows x cs f32).
__host__ __device__ size_t inverse_ring_bytes(int rows, bool resident) {
  const size_t ring = sizeof(bf16) * kStagesI * (size_t)rows * kK + (resident ? 0 : kStagesI * kStageB);
  const size_t tile = sizeof(float) * (size_t)rows * kLdF;
  return ring > tile ? ring : tile;
}

__host__ __device__ size_t inverse_bytes(int rows, bool resident, int cs) {
  return inverse_ring_bytes(rows, resident) + sizeof(float) * (size_t)rows * cs;
}

// Forward: the ring of matrix slices, then the slab of a tile's rows (its
// row count rounded up to 8: a panel stays 1024-byte aligned).
__host__ __device__ size_t ring_f_bytes() { return kStages * kStageB; }

// Past kMaxBox rows the slab arrives in boxes of equal rows (multiples of 8).
__host__ __device__ int slab_boxes(int rows) { return ceil_div(rows, kMaxBox); }

__host__ __device__ int slab_rows(int mf, int k) {
  const int r = mstts_round_up(mf + k - 1, 8);
  return mstts_round_up(r, 8 * slab_boxes(r));
}

// pw: the columns of a frame's piece the slab holds.
size_t forward_bytes(int mf, int k, int pw) {
  return ring_f_bytes() + sizeof(bf16) * (size_t)slab_rows(mf, k) * pw;
}

// Scratch: spectra y (B, T, n_fft) bf16, signal rows (B, nr, hop) f32 and
// bf16, the Nyquist values (B, T) f32, and in momentum mode the carries
// (B, T, n_fft / 2) x 2 and (B, T) f32; each piece 256-byte aligned.
long long scratch_bytes(int B, int T, int n_fft, int hop, int nr, bool momentum) {
  const size_t bt = (size_t)B * T, rows = (size_t)B * nr * hop;
  size_t s = align256(2 * bt * n_fft) + align256(4 * rows) + align256(2 * rows) + align256(4 * bt);
  if (momentum) s += 2 * align256(4 * bt * (n_fft / 2)) + align256(4 * bt);
  return (long long)s;
}

bool make_plan(int B, int T, int n_fft, int hop, bool momentum, int nsm, int max_smem,
               Plan* p) {
  p->k = n_fft / hop;
  int cs = 32;
  while (cs > 1 && p->k * cs > kN) cs /= 2;
  p->cs = cs;
  p->qg = std::min(p->k, kN / cs);
  p->ng = ceil_div(p->k, p->qg);
  p->n_cs = hop / cs;
  p->n_bs = n_fft / 2 / kBins;
  p->nr = T + p->k - 1;
  // The largest inverse and forward tiles that fit beside the resident
  // slice (preferred, where a block keeps one slice) or beside the
  // streaming ring, a frame's hop columns whole; else in the widest
  // pieces with which they fit beside the ring.
  int m_cap = 0, mf_cap = 0;
  size_t base = 0;
  const bool one_slice = p->n_cs <= nsm && p->ng == 1;
  bool found = false;
  for (int d = 1; d <= hop / kK && !found; ++d) {
    if (hop % d || (hop / d) % kK) continue;
    p->pw = hop / d;
    for (int resident = one_slice && d == 1 ? 1 : 0; resident >= 0 && !found; --resident) {
      base = resident ? resident_bytes(n_fft) : 0;
      const long long avail = (long long)max_smem - (long long)(base + kSmall);
      m_cap = mf_cap = 0;
      for (int m = kMaxM; m >= 16 && m_cap == 0; m -= 16)
        if ((long long)inverse_bytes(m, resident, cs) <= avail) m_cap = m;
      for (int mf = kMaxF; mf >= 16 && mf_cap == 0; mf -= 16)
        if ((long long)forward_bytes(mf, p->k, p->pw) <= avail) mf_cap = mf;
      p->resident = resident;
      found = m_cap >= p->qg + 1 && mf_cap > 0;
    }
  }
  if (!found) return false;
  p->blocks = p->n_cs <= nsm ? nsm / p->n_cs * p->n_cs : nsm;
  // Inverse: the fewest block rounds x m-tiles a unit, then the fewest tiles.
  long long best = LLONG_MAX;
  for (int rt = ceil_div(p->nr, m_cap - p->qg + 1); rt <= p->nr; ++rt) {
    const int m_out = ceil_div(p->nr, rt);
    if (ceil_div(p->nr, m_out) != rt) continue;  // the same tiles as a smaller rt
    const long long cost = (long long)ceil_div(B * rt * p->n_cs, p->blocks) *
                           ceil_div(m_out + p->qg - 1, 16) * p->ng;
    if (cost < best) {
      best = cost;
      p->rt = rt;
      p->m_out = m_out;
    }
  }
  // Forward: the fewest block rounds x L2 bytes a unit.
  best = LLONG_MAX;
  for (int ft = ceil_div(T, mf_cap); ft <= T; ++ft) {
    const int mf = ceil_div(T, ft);
    if (ceil_div(T, mf) != ft || mstts_round_up(mf, 16) > mf_cap) continue;
    const long long unit = (long long)kN * n_fft * 2 + (long long)(mf + p->k - 1) * hop * 2;
    const long long cost = (long long)ceil_div(B * ft * p->n_bs, p->blocks) * unit;
    if (cost < best) {
      best = cost;
      p->ft = ft;
      p->mf = mf;
    }
  }
  // No more blocks than units: idle blocks only slow the barrier.
  p->wide = p->n_cs > nsm || p->ng > 1 || p->pw != hop || p->cs < 4 ||
            slab_boxes(slab_rows(p->mf, p->k)) > 1;
  const int units = std::max(B * p->rt * p->n_cs, B * p->ft * p->n_bs);
  p->blocks = std::min(p->blocks, mstts_round_up(units, p->n_cs));
  p->smem = (int)(base + std::max(inverse_bytes(mstts_round_up(p->m_out + p->qg - 1, 16),
                                                p->resident, cs),
                                  forward_bytes(mstts_round_up(p->mf, 16), p->k, p->pw)) +
                  kSmall);
  p->scratch = scratch_bytes(B, T, n_fft, hop, p->nr, momentum);
  return true;
}

struct GlArgs {
  // Tensor maps of the copies: the spectra y (n_fft, T, B) and the bf16
  // rows (hop, nr, B) in boxes of 64 columns, 128-byte swizzled; the packed
  // matrices (64, n_fft / 8, 8 x groups) a k-slice of 8 column blocks at a
  // time, as they lie.
  CUtensorMap tm_y, tm_r16, tm_w, tm_v;
  const float* mag;     // (B, T, Fp) target magnitudes, bins 0 .. Fp - 1
  const float* mag_ny;  // (B, T) Nyquist magnitudes
  const bf16* vpack;    // (n_cs ng, 64, n_fft): slice s, group g, column q cs + c =
                        //   [Vr; Vi][:, (g qg + q) hop + s cs + c]
  const bf16* wpack;    // (n_bs, 64, n_fft): group g, pair p: [Wr | Wi] columns of bins 32 g + 8 p + j
  const float* wny;     // (n_fft) Nyquist analysis
  const float* vny;     // (n_fft) Nyquist synthesis
  const float* wsum;    // (>= nr, hop) inverse window-square OLA sum
  bf16* y;              // (B, T, n_fft) projected spectra [re | im]
  float* r32;           // (B, nr, hop) signal rows
  bf16* r16;
  float* rny;           // (B, T) projected Nyquist values
  float* pre;           // momentum carries (B, T, Fp) x 2, (B, T), or null
  float* pim;
  float* prny;
  float* out;           // (B, (T - 1) hop)
  unsigned int* bar;    // grid barrier counter, zeroed by the wrapper
  int B, T, n_fft, hop, n_iter;
  float beta;
  Plan p;
};

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The rings are filled by the TMA unit: one thread issues a stage's copies
// (cp.async.bulk.tensor, a box each) on the stage's mbarrier, and every
// thread waits on the barrier's phase. Shared memory that plain loads and
// stores used is handed to the copies through fence.proxy.async, and so is
// global memory that other blocks wrote before a grid barrier (the
// mbarrier and fence helpers are common.cuh's).

// The issuing thread's instructions are predicated inside the asm (`on`):
// every thread runs them, no branch (a branch between products would make
// the compiler serialize the wgmma pipeline).
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes, bool on) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %2, 0;\n"
      "@q mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n}\n" ::"r"(mstts_smem_addr(bar)),
      "r"(bytes), "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map, int c0, int c1, int c2,
                                       uint64_t* bar, bool on) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %6, 0;\n"
      "@q cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n}\n" ::"r"(mstts_smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(mstts_smem_addr(bar)),
      "r"((int)on)
      : "memory");
}

__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
}

// A 16-byte chunk of a swizzled panel (rows of 64 bf16, 1024-byte aligned):
// the TMA unit's 128-byte swizzle stores chunk c of row r at c ^ (r % 8).
__device__ __forceinline__ const bf16* panel_at(const bf16* panel, int row, int chunk) {
  return panel + row * kPanel + ((chunk ^ (row & 7)) << 3);
}

// wgmma: fence before a slice's products (the A fragments were written by
// other instructions), m64n64k16 with A in registers and B through a
// shared-memory descriptor, committed as a group and awaited later. The
// empty asm statements keep the accumulators' uses on the right side of the
// fence and of the last wait.
__device__ __forceinline__ void acc_fence(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A fragments of an issued product stay in their registers until the
// product is awaited: an empty asm statement that uses them there.
__device__ __forceinline__ void frag_fence(uint32_t (&af)[8][4]) {
#pragma unroll
  for (int s = 0; s < 8; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(af[s][i])::"memory");
}

__device__ __forceinline__ void wgmma_fence(float (&d)[32]) {
  acc_fence(d);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Descriptor of a K-major operand in core matrices: start address, leading
// byte offset 128 (the next 8 k), stride byte offset sbo (the next 8
// columns), no swizzle.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t sbo) {
  const uint64_t addr = mstts_smem_addr(p);
  return ((addr & 0x3FFFFull) >> 4) | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

// The launch's dynamic shared memory; every region is addressed from this
// array, so that the compiler uses shared-memory loads and stores.
extern __shared__ __align__(128) unsigned char smem[];

template <bool kMom, bool kWide>
struct Dense {
  const GlArgs& a;  // the launch's __grid_constant__ arguments (the tensor maps live there)
  int tid, lane, warp, g8, tq;
  int Fp, slice, a_rows, s_rows;
  bool issuer;  // thread 0: the one that issues the copies
  mutable uint32_t phases = 0;  // bit i: the parity of barrier i's next phase

  __device__ explicit Dense(const GlArgs& args) : a(args) {
    tid = threadIdx.x;
    lane = tid % 32;
    warp = __shfl_sync(0xffffffffu, tid / 32, 0);  // warp-uniform to the compiler: wgmma unserialized
    g8 = lane >> 2;
    tq = lane & 3;
    Fp = a.n_fft / 2;
    slice = blockIdx.x % a.p.n_cs;
    a_rows = mstts_round_up(a.p.m_out + a.p.qg - 1, 16);
    s_rows = slab_rows(a.p.mf, a.p.k);
    issuer = tid == 0;
  }

  __device__ bf16* resident() const { return reinterpret_cast<bf16*>(smem); }
  __device__ unsigned char* dyn() const {
    return smem + (a.p.resident ? resident_bytes(a.n_fft) : 0);
  }
  // Inverse: the A ring (a stage is two panels of a_rows rows), then
  // (streamed slice) the B ring; the f32 frame tile of the epilogue over
  // them. Forward: the B ring, then the slab (hop / 64 panels of s_rows).
  __device__ bf16* ring_a(int st) const {
    return reinterpret_cast<bf16*>(dyn()) + (size_t)st * a_rows * kK;
  }
  __device__ bf16* ring_b_inv(int st) const {
    return reinterpret_cast<bf16*>(dyn()) + (size_t)kStagesI * a_rows * kK + (size_t)st * kN * kK;
  }
  __device__ bf16* ring_b_fwd(int st) const {
    return reinterpret_cast<bf16*>(dyn()) + (size_t)st * kN * kK;
  }
  __device__ bf16* slab() const { return reinterpret_cast<bf16*>(dyn() + ring_f_bytes()); }
  __device__ float* frame_tile() const { return reinterpret_cast<float*>(dyn()); }
  __device__ float* wsum_tile() const {
    return reinterpret_cast<float*>(dyn() + inverse_ring_bytes(a_rows, a.p.resident));
  }
  __device__ float* rn_s() const { return reinterpret_cast<float*>(smem + a.p.smem - kSmall); }
  __device__ float* vny_s() const { return rn_s() + kMaxM; }
  __device__ uint64_t* bars() const { return reinterpret_cast<uint64_t*>(vny_s() + kN); }

  // Every thread waits for every fill of a barrier, so that all keep its
  // phase.
  __device__ void wait_bar(int i) const {
    mstts_mbar_wait(bars() + i, (phases >> i) & 1u);
    phases ^= 1u << i;
  }

  // The rows of an inverse tile this warp takes: warpgroup wg the 64-row
  // tile wg, warp wr of it rows 16 wr ..; a warp past the tile's rows (all
  // of the second warpgroup's with up to 4 m-tiles) multiplies rows 0 .. 15
  // again, unused (every warpgroup runs the same products).
  struct Part {
    bool live;
    int r0;
  };
  __device__ Part part(int mt) const {
    Part q;
    q.r0 = 64 * (warp >> 2) + 16 * (warp & 3);
    q.live = q.r0 < 16 * mt;
    return q;
  }

  // A k-slice of 128 on wgmma m64n64k16, issued as one group: the warp's 16
  // rows as A fragments (ldmatrix, the mma.sync layout; at(row, step, half)
  // is the 16 bytes of k-step `step` a lane reads), the matrix slice read
  // through a descriptor (core matrices, no swizzle: 128 bytes between the
  // two k-halves of a step, sbo between 8-column blocks).
  template <class At>
  __device__ void mma_slice(float (&acc)[32], uint32_t (&af)[8][4], At at, const bf16* Bst,
                            uint32_t sbo, const Part& q) const {
    const int row = (q.live ? q.r0 : 0) + (lane & 15);
#pragma unroll
    for (int s = 0; s < 8; ++s) mstts_ldmatrix_x4(af[s], at(row, s, lane >> 4));
    wgmma_fence(acc);
#pragma unroll
    for (int s = 0; s < 8; ++s) wgmma_bf16(acc, af[s], smem_desc(Bst + 2 * s * 64, sbo));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // Forward: both warpgroups on the one tile of up to 64 frames, each 4 of
  // a slice's 8 k-steps.
  template <class At>
  __device__ void mma_half(float (&acc)[32], uint32_t (&af)[8][4], At at, const bf16* Bst,
                           uint32_t sbo, int mt) const {
    const int wr = warp & 3, k0 = 4 * (warp >> 2);
    const int row = (16 * wr < 16 * mt ? 16 * wr : 0) + (lane & 15);
#pragma unroll
    for (int s = 0; s < 4; ++s) mstts_ldmatrix_x4(af[s], at(row, k0 + s, lane >> 4));
    wgmma_fence(acc);
#pragma unroll
    for (int s = 0; s < 4; ++s) wgmma_bf16(acc, af[s], smem_desc(Bst + 2 * (k0 + s) * 64, sbo));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  }

  // The accumulators into the f32 tile T (row stride kLdF), each warp its
  // live rows. Ends with a block barrier.
  __device__ void store_tile(float (&acc)[32], float* T, const Part& q, int mt) const {
    if (q.live) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int row = q.r0 + g8 + 8 * hf;
          if (row < 16 * mt)
            *reinterpret_cast<float2*>(T + row * kLdF + 8 * j + 2 * tq) =
                make_float2(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
        }
    }
    __syncthreads();
  }

  // The ring's loop: slice ks waits for its stage's barrier (slice 0 with
  // `slab` also for the slab's), mma(ks, af) loads its A fragments into af
  // and issues its products as one group, the group of slice ks - 1 is
  // awaited, every warp is past it, and the issuing thread sends the slice
  // S - 1 ahead into the stage slice ks - 1 freed: slice ks multiplies
  // while slice ks + 1 is awaited and loaded (two fragment buffers; nks is
  // even). The caller has issued slices 0 .. S - 2 (ring_prologue);
  // issue(stage, slice) runs on every thread, its copies on one. Ends with
  // every product done; the caller fences the accumulators.
  template <int S, class Issue, class Mma>
  __device__ void ring(int nks, int bar0, bool slab, Issue issue, Mma mma) const {
    uint32_t af[2][8][4];
    for (int kp = 0; kp < nks; kp += 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ks = kp + h;
        if (ks == 0 && slab) wait_bar(kBarSlab);
        wait_bar(bar0 + ks % S);
        mma(ks, af[h]);
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        frag_fence(af[h ^ 1]);  // slice ks - 1's fragments were in use until here
        mstts_fence_proxy_async();    // and its stage was read
        __syncthreads();
        const int nx = ks + S - 1;
        if (nx < nks) issue(nx % S, nx);
      }
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }

  template <int S, class Issue>
  __device__ void ring_prologue(int nks, Issue issue) const {
    for (int st = 0; st < S - 1 && st < nks; ++st) issue(st, st);
  }

  // -- prologue: the resident slice, the zero-phase start, the carries ------
  __device__ void prologue() {
    if (a.p.resident)
      for (int i = tid; i < kN * a.n_fft / 8; i += kThreads)
        mstts_cp_async16(resident() + 8 * i, a.vpack + (size_t)slice * kN * a.n_fft + 8 * i);
    const size_t gid = (size_t)blockIdx.x * kThreads + tid, gstride = (size_t)gridDim.x * kThreads;
    const size_t nbt = (size_t)a.B * a.T;
    for (size_t i = gid; i < nbt * Fp; i += gstride) {
      const size_t bt = i / Fp, m = i - bt * Fp;
      a.y[bt * a.n_fft + m] = __float2bfloat16(a.mag[i]);
      a.y[bt * a.n_fft + Fp + m] = __float2bfloat16(0.0f);
      if constexpr (kMom) {
        a.pre[i] = 0.0f;
        a.pim[i] = 0.0f;
      }
    }
    for (size_t i = gid; i < nbt; i += gstride) {
      a.rny[i] = a.mag_ny[i];
      if constexpr (kMom) a.prny[i] = 0.0f;
    }
    if constexpr (!kWide)  // the block's one slice (the wide build loads them a unit)
      for (int i = tid; i < a.p.k * a.p.cs; i += kThreads) {
        const int q = i / a.p.cs, c = i - q * a.p.cs;
        vny_s()[i] = a.vny[q * a.hop + slice * a.p.cs + c];
      }
    if (tid < kBars) mstts_mbar_init(bars() + tid);
    if (tid == 0) {
      if (mstts_smem_addr(smem) & 1023u) __trap();  // the swizzled panels need 1024-byte alignment
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    cp_async_commit();
    cp_async_wait<0>();
    mstts_fence_proxy_async();  // the resident slice, read by wgmma
  }

  // -- inverse phase: spectra -> frames -> overlap-add -> signal rows -------
  // The block's units: its slice's (utterance, row tile) pairs; in the wide
  // build unit u is slice u % n_cs, pair u / n_cs, a block taking units
  // blockIdx.x, + gridDim.x, ..., and a unit runs its slice's ng groups of
  // frame offsets in turn.
  __device__ void inverse(bool last) const {
    const Plan& p = a.p;
    const int k = p.k, cs = p.cs, qg = kWide ? p.qg : p.k, hop = a.hop, n_fft = a.n_fft;
    const int nks = n_fft / kK, ng = kWide ? p.ng : 1;
    // Fewer than 4 hop-columns a slice, or groups: a thread a (row, column).
    const bool scalar = kWide && (cs < 4 || p.ng > 1);
    fence_proxy_async_global();  // y, written by every block's forward phase
    float* rn = rn_s();
    float* ws = wsum_tile();
    float* vn = vny_s();
    const int n_units = kWide ? p.n_cs * a.B * p.rt : a.B * p.rt;
    const int first = kWide ? (int)blockIdx.x : (int)blockIdx.x / p.n_cs;
    const int step = kWide ? (int)gridDim.x : (int)gridDim.x / p.n_cs;
    for (int u = first; u < n_units; u += step) {
      const int sl = kWide ? u % p.n_cs : slice, v = kWide ? u / p.n_cs : u;
      const int b = v / p.rt, r0 = (v % p.rt) * p.m_out;
      const int rows = min(p.m_out, p.nr - r0);
      float accv = 0.0f;  // scalar: this thread's (row, column), over the groups
      for (int g = 0; g < ng; ++g) {
        const int q0 = g * qg, nq = min(qg, k - q0);
        const int f0 = r0 - q0 - (qg - 1), M = rows + qg - 1, mt = ceil_div(M, 16);
        if (kWide && (f0 + M <= 0 || f0 >= a.T)) continue;  // no frame of the utterance
        // A stage: frames f0 .. of utterance b in a box of m_out + qg - 1
        // rows rounded up to 8 (rows up to a_rows are multiplied, unused),
        // columns 128 ks .. + 127, as two panels; frames outside the
        // utterance arrive as zeros (the box leaves the tensor).
        const uint32_t bytes = (uint32_t)(mstts_round_up(p.m_out + qg - 1, 8) * kK * 2) +
                               (p.resident ? 0u : (uint32_t)kStageB);
        const int vslice = kWide ? sl * p.ng + g : sl;
        auto issue = [&](int st, int ks) {
          mbar_expect(bars() + st, bytes, issuer);
          for (int h = 0; h < kK / kPanel; ++h)
            tma_3d(ring_a(st) + h * a_rows * kPanel, &a.tm_y, ks * kK + h * kPanel, f0, b,
                   bars() + st, issuer);
          if (!p.resident)
            tma_3d(ring_b_inv(st), &a.tm_v, 0, 16 * ks, 8 * vslice, bars() + st, issuer);
        };
        float acc[32] = {};
        const Part part_i = part(mt);
        auto mma = [&](int ks, uint32_t (&af)[8][4]) {
          const bf16* As = ring_a(ks % kStagesI);
          const int pe = a_rows * kPanel;
          auto at = [&](int row, int step, int half) {
            return panel_at(As + (step >> 2) * pe, row, 2 * (step & 3) + half);
          };
          if (p.resident)  // core column 16 ks of every block
            mma_slice(acc, af, at, resident() + ks * kK * 8, 16u * n_fft, part_i);
          else
            mma_slice(acc, af, at, ring_b_inv(ks % kStagesI), 16u * kK, part_i);
        };
        // The normaliser of the tile's rows at the slice's columns.
        if (!scalar)
          for (int i = tid; i < rows * (cs / 4); i += kThreads) {
            const int j = i / (cs / 4), c = i - j * (cs / 4);
            mstts_cp_async16(ws + j * cs + 4 * c, a.wsum + (size_t)(r0 + j) * hop + sl * cs + 4 * c);
          }
        cp_async_commit();
        ring_prologue<kStagesI>(nks, issue);
        for (int i = tid; i < M; i += kThreads) {
          const int f = f0 + i;
          rn[i] = f >= 0 && f < a.T ? __ldcg(a.rny + (size_t)b * a.T + f) : 0.0f;
        }
        // The group's Nyquist synthesis values at the slice's columns.
        if constexpr (kWide)
          for (int i = tid; i < nq * cs; i += kThreads) {
            const int q = i / cs, c = i - q * cs;
            vn[i] = a.vny[(size_t)(q0 + q) * hop + sl * cs + c];
          }
        ring<kStagesI>(nks, 0, false, issue, mma);
        acc_fence(acc);
        cp_async_wait<0>();
        __syncthreads();  // every warp is done with the ring
        float* S = frame_tile();
        store_tile(acc, S, part_i, mt);
        if (scalar) {
          // Row r0 + j, column sl cs + c: the group's frames under it, offset
          // q0 first, each with its Nyquist term.
          if (tid < rows * cs) {
            const int j = tid / cs, c = tid - j * cs;
            for (int q = 0; q < nq; ++q) {
              const int fi = j + qg - 1 - q;
              accv += S[fi * kLdF + q * cs + c] + rn[fi] * vn[q * cs + c];
            }
          }
          mstts_fence_proxy_async();
          __syncthreads();  // the frame tile, rn and vn are free for the next group
          continue;
        }
        // Row r0 + j, columns sl cs + c, c + 1: the k frames under it in the
        // plain version's order (offset q = 0 first), each with its Nyquist
        // term, times the normaliser.
        const int half = cs / 2;
        for (int i = tid; i < rows * half; i += kThreads) {
          const int j = i / half, c = 2 * (i - j * half), r = r0 + j, col = sl * cs + c;
          float v0 = 0.0f, v1 = 0.0f;
          for (int q = 0; q < k; ++q) {
            const int fi = j + k - 1 - q;
            const float2 sv = *reinterpret_cast<const float2*>(S + fi * kLdF + q * cs + c);
            const float2 vv = *reinterpret_cast<const float2*>(vn + q * cs + c);
            v0 += sv.x + rn[fi] * vv.x;
            v1 += sv.y + rn[fi] * vv.y;
          }
          const float2 w = *reinterpret_cast<const float2*>(ws + j * cs + c);
          v0 *= w.x;
          v1 *= w.y;
          if (last) {
            const int ro = r - k / 2;
            if (ro >= 0 && ro < a.T - 1)
              *reinterpret_cast<float2*>(a.out + ((size_t)b * (a.T - 1) + ro) * hop + col) =
                  make_float2(v0, v1);
          } else {
            const size_t o = ((size_t)b * p.nr + r) * hop + col;
            *reinterpret_cast<float2*>(a.r32 + o) = make_float2(v0, v1);
            *reinterpret_cast<__nv_bfloat162*>(a.r16 + o) = __floats2bfloat162_rn(v0, v1);
          }
        }
      }
      if (scalar && tid < rows * cs) {
        const int j = tid / cs, c = tid - j * cs, r = r0 + j, col = sl * cs + c;
        const float v0 = accv * __ldg(a.wsum + (size_t)r * hop + col);
        if (last) {
          const int ro = r - k / 2;
          if (ro >= 0 && ro < a.T - 1) a.out[((size_t)b * (a.T - 1) + ro) * hop + col] = v0;
        } else {
          const size_t o = ((size_t)b * p.nr + r) * hop + col;
          a.r32[o] = v0;
          a.r16[o] = __float2bfloat16(v0);
        }
      }
      mstts_fence_proxy_async();
      __syncthreads();  // the frame tile, rn, vn and ws are free for the next unit
    }
  }

  // -- forward phase: signal rows -> spectra -> momentum -> projection ------
  // Slice ks (core columns 16 ks .. 16 ks + 15 of each of the 8 column
  // blocks) of bin group bs's matrix slice into a ring stage [8][16][64].
  __device__ void forward_issue(int st, int ks, int bs) const {
    mbar_expect(bars() + kBarF + st, (uint32_t)kStageB, issuer);
    tma_3d(ring_b_fwd(st), &a.tm_w, 0, 16 * ks, 8 * bs, bars() + kBarF + st, issuer);
  }

  // The k-slice of ring step i of piece pc: frame row q = i / spr of the
  // piece's spr slices a row (every slice in order with one piece).
  __device__ int piece_ks(int i, int pc) const {
    if constexpr (!kWide) return i;
    const int spr = a.p.pw / kK;
    return (i / spr) * (a.hop / kK) + pc * spr + i % spr;
  }

  // The block's first forward unit's matrix slices depend on no other
  // block: they are issued between the barrier's arrival and its wait.
  __device__ void forward_prefetch() const {
    if ((int)blockIdx.x < a.B * a.p.ft * a.p.n_bs)
      ring_prologue<kStages>((kWide ? a.p.k * a.p.pw : a.n_fft) / kK, [&](int st, int i) {
        forward_issue(st, piece_ks(i, 0), blockIdx.x % a.p.n_bs);
      });
  }

  __device__ void forward() const {
    const Plan& p = a.p;
    const int hop = a.hop, n_fft = a.n_fft, pw = kWide ? p.pw : hop;
    const int npiece = kWide ? hop / pw : 1, nks = kWide ? p.k * pw / kK : n_fft / kK;
    const int nbox = kWide ? slab_boxes(s_rows) : 1, sbox = s_rows / nbox;
    const int n_units = a.B * p.ft * p.n_bs;
    fence_proxy_async_global();  // the rows, written by every block's inverse phase
    for (int u = blockIdx.x; u < n_units; u += gridDim.x) {
      const int bs = u % p.n_bs, rest = u / p.n_bs, tt = rest % p.ft, b = rest / p.ft;
      const int t0 = tt * p.mf, nf = min(p.mf, a.T - t0), mt = ceil_div(nf, 16);
      // The slab of piece pc: rows t0 .. t0 + s_rows - 1 (rows t0 .. t0 + nf
      // + k - 2 are used), columns pc pw .. + pw - 1 as pw / 64 panels.
      auto slab_issue = [&](int pc) {
        mbar_expect(bars() + kBarSlab, (uint32_t)(s_rows * pw * 2), issuer);
        for (int g = 0; g < pw / kPanel; ++g)
          for (int x = 0; x < nbox; ++x)
            tma_3d(slab() + (g * s_rows + x * sbox) * kPanel, &a.tm_r16, pc * pw + g * kPanel,
                   t0 + x * sbox, b, bars() + kBarSlab, issuer);
      };
      if (u != (int)blockIdx.x)
        ring_prologue<kStages>(nks, [&](int st, int i) { forward_issue(st, piece_ks(i, 0), bs); });
      slab_issue(0);
      // This thread's projections, from its accumulators: both warpgroups
      // hold rows 16 wr + g8 and + 8 of the tile (each its k-share); warp
      // group wg projects row 16 wr + g8 + 8 wg, n-tiles 2p (re) and 2p + 1
      // (im) of bins 32 bs + 8 p + 2 tq (+ 1). Its targets are requested
      // ahead of the products.
      const int wg = warp >> 2, r0 = 16 * (warp & 3), row = r0 + g8 + 8 * wg;
      float2 mg[4], pr[4], pq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t o = ((size_t)b * a.T + t0 + row) * Fp + bs * kBins + 8 * q + 2 * tq;
        mg[q] = pr[q] = pq[q] = make_float2(0.0f, 0.0f);
        if (row >= nf) continue;
        mg[q] = __ldg(reinterpret_cast<const float2*>(a.mag + o));
        if constexpr (kMom) {
          pr[q] = *reinterpret_cast<const float2*>(a.pre + o);
          pq[q] = *reinterpret_cast<const float2*>(a.pim + o);
        }
      }
      // While they are in flight: the Nyquist analysis of frames bs, bs +
      // n_bs, ... of the tile from the f32 rows (one warp a frame, eight
      // 16-byte loads a lane in flight, the second warpgroup first), its
      // momentum and projection.
      for (int i = (warp + 4) % kWarps; bs + i * p.n_bs < nf; i += kWarps) {
        const int t = t0 + bs + i * p.n_bs;
        const float* x = a.r32 + ((size_t)b * p.nr + t) * hop;
        float dot = 0.0f;
        for (int n0 = 0; n0 < n_fft; n0 += 8 * 128) {
          float4 xv[8], wv[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int n = n0 + 128 * e + 4 * lane;
            xv[e] = n < n_fft ? __ldcg(reinterpret_cast<const float4*>(x + n))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            wv[e] = n < n_fft ? __ldg(reinterpret_cast<const float4*>(a.wny + n))
                              : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            dot = fmaf(xv[e].x, wv[e].x, dot);
            dot = fmaf(xv[e].y, wv[e].y, dot);
            dot = fmaf(xv[e].z, wv[e].z, dot);
            dot = fmaf(xv[e].w, wv[e].w, dot);
          }
        }
        dot = warp_sum(dot);
        if (lane == 0) {
          const size_t o = (size_t)b * a.T + t;
          float rn = dot;
          if constexpr (kMom) {
            const float pv = a.prny[o];
            a.prny[o] = rn;
            rn -= a.beta * pv;
          }
          a.rny[o] = rn * (a.mag_ny[o] / fmaxf(sqrtf(rn * rn + 1e-12f), 1e-11f));
        }
      }
      float acc[32] = {};
      // Frame t's operand at k = kg is row t + kg / hop, column kg % hop; a
      // slice of 128 lies in one row (hop % 128 == 0), in two panels of the
      // piece holding it.
      const bf16* sl = slab();
      for (int pc = 0; pc < npiece; ++pc) {
        auto issue = [&](int st, int i) { forward_issue(st, piece_ks(i, pc), bs); };
        if (pc > 0) {
          // Every warp is past the last piece's products: its stages and
          // slab are free.
          mstts_fence_proxy_async();
          __syncthreads();
          ring_prologue<kStages>(nks, issue);
          slab_issue(pc);
        }
        ring<kStages>(nks, kBarF, true, issue, [&](int i, uint32_t (&af)[8][4]) {
          const int ks = piece_ks(i, pc), q = ks * kK / hop;
          const int col = ks * kK - q * hop - (kWide ? pc * pw : 0);  // within the piece
          const bf16* P = sl + col / kPanel * s_rows * kPanel;
          const int pe = s_rows * kPanel;
          auto at = [&](int row, int step, int half) {
            return panel_at(P + (step >> 2) * pe, row + q, 2 * (step & 3) + half);
          };
          mma_half(acc, af, at, ring_b_fwd(i % kStages), 16u * kK, mt);
        });
      }
      acc_fence(acc);
      {
        // Each warpgroup hands the other its k-share of the other's row
        // through an f32 tile over the ring and adds the other's share of
        // its own (a + b: the same sum whichever holds it).
        float* P = frame_tile();
        __syncthreads();  // all warps past the ring
        const int give = r0 + g8 + 8 * (1 - wg);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(P + give * kLdF + 8 * j + 2 * tq) =
              wg ? make_float2(acc[4 * j], acc[4 * j + 1]) : make_float2(acc[4 * j + 2], acc[4 * j + 3]);
        __syncthreads();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 o = *reinterpret_cast<const float2*>(P + row * kLdF + 8 * j + 2 * tq);
          const float x = (wg ? acc[4 * j + 2] : acc[4 * j]) + o.x;
          const float y = (wg ? acc[4 * j + 3] : acc[4 * j + 1]) + o.y;
          acc[4 * j] = acc[4 * j + 2] = x;
          acc[4 * j + 1] = acc[4 * j + 3] = y;
        }
      }
      // Momentum and projection on the accumulators (this row's sums sit in
      // both halves of acc now).
      if (row < nf) {
        const size_t bt = (size_t)b * a.T + t0 + row;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int bin = bs * kBins + 8 * q + 2 * tq;
          const size_t o = bt * Fp + bin;
          float re[2] = {acc[8 * q], acc[8 * q + 1]};
          float im[2] = {acc[8 * q + 4], acc[8 * q + 5]};
          if constexpr (kMom) {
            *reinterpret_cast<float2*>(a.pre + o) = make_float2(re[0], re[1]);
            *reinterpret_cast<float2*>(a.pim + o) = make_float2(im[0], im[1]);
            re[0] -= a.beta * pr[q].x;
            re[1] -= a.beta * pr[q].y;
            im[0] -= a.beta * pq[q].x;
            im[1] -= a.beta * pq[q].y;
          }
          const float2 m2 = mg[q];
          const float s0 = m2.x / fmaxf(sqrtf(re[0] * re[0] + im[0] * im[0] + 1e-12f), 1e-11f);
          const float s1 = m2.y / fmaxf(sqrtf(re[1] * re[1] + im[1] * im[1] + 1e-12f), 1e-11f);
          *reinterpret_cast<__nv_bfloat162*>(a.y + bt * n_fft + bin) =
              __floats2bfloat162_rn(re[0] * s0, re[1] * s1);
          *reinterpret_cast<__nv_bfloat162*>(a.y + bt * n_fft + Fp + bin) =
              __floats2bfloat162_rn(im[0] * s0, im[1] * s1);
        }
      }
      mstts_fence_proxy_async();
      __syncthreads();  // the slab and the ring are free for the next unit
    }
  }
};

template <bool kMom, bool kWide>
__global__ void __launch_bounds__(kThreads, 1) gl_dense_kernel(const __grid_constant__ GlArgs a) {
  Dense<kMom, kWide> d(a);
  d.prologue();
  fence_proxy_async_global();  // y, written by the prologue
  unsigned int epoch = 0;
  mstts_grid_barrier(a.bar, epoch);
  for (int it = 0;; ++it) {
    d.inverse(it == a.n_iter);
    if (it == a.n_iter) break;
    fence_proxy_async_global();
    mstts_grid_arrive(a.bar, epoch);
    d.forward_prefetch();
    mstts_grid_wait(a.bar, epoch);
    d.forward();
    fence_proxy_async_global();
    mstts_grid_barrier(a.bar, epoch);
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda by the CUDA runtime (the
// library is not linked against it).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (!cached) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess) return err;
    if (q != cudaDriverEntryPointSuccess || f == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(f);
  }
  *fn = cached;
  return cudaSuccess;
}

// A bf16 tensor (d0, d1, d2), d0 innermost, rows of p1 elements and planes
// of p2, read in boxes (b0, b1, b2); swizzled 128-byte rows or as it lies.
cudaError_t map_3d(EncodeTiled enc, CUtensorMap* m, const void* base, uint64_t d0, uint64_t d1,
                   uint64_t d2, uint64_t p1, uint64_t p2, uint32_t b0, uint32_t b1, uint32_t b2,
                   bool swizzle) {
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {p1 * sizeof(bf16), p2 * sizeof(bf16)};
  const cuuint32_t box[3] = {b0, b1, b2};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims,
                         strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

bool valid(int B, int T, int n_fft, int hop, int n_iter) {
  return hop > 0 && hop % 128 == 0 && n_fft % hop == 0 && (n_fft / hop) % 2 == 0 &&
         n_fft % 256 == 0 && T >= 2 && n_iter >= 0 && B >= 1;
}

cudaError_t plan_for(int B, int T, int n_fft, int hop, bool momentum, Plan* p) {
  int dev = 0, nsm = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  return make_plan(B, T, n_fft, hop, momentum, nsm, max_smem, p) ? cudaSuccess
                                                                  : cudaErrorInvalidConfiguration;
}

}  // namespace

// The launch's plan for these shapes, as 17 int64: k, cs, n_cs, n_bs, nr,
// resident, blocks, rt, m_out, ft, mf, smem, scratch bytes, qg, ng, pw, wide.
MSTTS_EXPORT int mstts_gl_dense_plan(int B, int T, int n_fft, int hop, int momentum,
                                     void* plan_out) {
  if (!valid(B, T, n_fft, hop, 0)) return (int)cudaErrorInvalidValue;
  Plan p;
  MSTTS_CHECK(plan_for(B, T, n_fft, hop, momentum != 0, &p));
  long long* o = static_cast<long long*>(plan_out);
  const int v[12] = {p.k, p.cs, p.n_cs, p.n_bs, p.nr, p.resident, p.blocks,
                     p.rt, p.m_out, p.ft, p.mf, p.smem};
  for (int i = 0; i < 12; ++i) o[i] = v[i];
  o[12] = p.scratch;
  o[13] = p.qg;
  o[14] = p.ng;
  o[15] = p.pw;
  o[16] = p.wide;
  return 0;
}

// Kernel launches made by mstts_gl_dense (read by mstts_gl_dense_launch_count).
static long long g_launches = 0;

// mag (B, T, Fp) and mag_ny (B, T) f32 targets; vpack / wpack the packed
// bf16 matrices; wny / vny (n_fft) f32; wsum (>= T + k - 1, hop) f32;
// scratch: scratch_bytes of device memory; bar: a zeroed counter; out
// (B, (T - 1) hop) f32.
MSTTS_EXPORT int mstts_gl_dense(const void* mag, const void* mag_ny, const void* vpack,
                                const void* wpack, const void* wny, const void* vny,
                                const void* wsum, void* scratch, void* bar, void* out, int B,
                                int T, int n_fft, int hop, int n_iter, int momentum, float beta,
                                void* stream) {
  if (!valid(B, T, n_fft, hop, n_iter)) return (int)cudaErrorInvalidValue;
  GlArgs a;
  MSTTS_CHECK(plan_for(B, T, n_fft, hop, momentum != 0, &a.p));
  a.mag = static_cast<const float*>(mag);
  a.mag_ny = static_cast<const float*>(mag_ny);
  a.vpack = static_cast<const bf16*>(vpack);
  a.wpack = static_cast<const bf16*>(wpack);
  a.wny = static_cast<const float*>(wny);
  a.vny = static_cast<const float*>(vny);
  a.wsum = static_cast<const float*>(wsum);
  const size_t bt = (size_t)B * T, rows = (size_t)B * a.p.nr * hop;
  unsigned char* s = static_cast<unsigned char*>(scratch);
  a.y = reinterpret_cast<bf16*>(s);
  s += align256(2 * bt * n_fft);
  a.r32 = reinterpret_cast<float*>(s);
  s += align256(4 * rows);
  a.r16 = reinterpret_cast<bf16*>(s);
  s += align256(2 * rows);
  a.rny = reinterpret_cast<float*>(s);
  s += align256(4 * bt);
  a.pre = a.pim = a.prny = nullptr;
  if (momentum) {
    a.pre = reinterpret_cast<float*>(s);
    s += align256(4 * bt * (n_fft / 2));
    a.pim = reinterpret_cast<float*>(s);
    s += align256(4 * bt * (n_fft / 2));
    a.prny = reinterpret_cast<float*>(s);
  }
  a.out = static_cast<float*>(out);
  a.bar = static_cast<unsigned int*>(bar);
  a.B = B;
  a.T = T;
  a.n_fft = n_fft;
  a.hop = hop;
  a.n_iter = n_iter;
  a.beta = beta;
  EncodeTiled enc;
  MSTTS_CHECK(encode_tiled(&enc));
  const int y_rows = mstts_round_up(a.p.m_out + a.p.qg - 1, 8), cols = n_fft / 8;
  const int s_rows = slab_rows(a.p.mf, a.p.k);
  MSTTS_CHECK(map_3d(enc, &a.tm_y, a.y, n_fft, T, B, n_fft, (uint64_t)T * n_fft, kPanel, y_rows, 1,
                     true));
  MSTTS_CHECK(map_3d(enc, &a.tm_r16, a.r16, hop, a.p.nr, B, hop, (uint64_t)a.p.nr * hop, kPanel,
                     s_rows / slab_boxes(s_rows), 1, true));
  MSTTS_CHECK(map_3d(enc, &a.tm_w, wpack, 64, cols, 8 * a.p.n_bs, 64, (uint64_t)cols * 64, 64,
                     kK / 8, 8, false));
  MSTTS_CHECK(map_3d(enc, &a.tm_v, vpack, 64, cols, 8 * a.p.n_cs * a.p.ng, 64,
                     (uint64_t)cols * 64, 64, kK / 8, 8, false));
  const void* kernel =
      momentum ? (a.p.wide ? (const void*)gl_dense_kernel<true, true>
                           : (const void*)gl_dense_kernel<true, false>)
               : (a.p.wide ? (const void*)gl_dense_kernel<false, true>
                           : (const void*)gl_dense_kernel<false, false>);
  MSTTS_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   a.p.smem));
  void* params[] = {&a};
  MSTTS_CHECK(cudaLaunchCooperativeKernel(kernel, dim3(a.p.blocks), dim3(kThreads), params,
                                          (size_t)a.p.smem, static_cast<cudaStream_t>(stream)));
  ++g_launches;
  MSTTS_RETURN_LAUNCH_ERROR();
}

// The number of kernel launches this library has made since it was loaded,
// into *count_out (long long): one a successful mstts_gl_dense call.
MSTTS_EXPORT int mstts_gl_dense_launch_count(void* count_out) {
  *static_cast<long long*>(count_out) = g_launches;
  return 0;
}
