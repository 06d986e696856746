// K autoregressive Tacotron decode steps in one persistent launch.
//
// Replaces multi_speaker_tts_tpu/ops/decode_pallas.py::decode_segment_pallas
// (kernel body _kernel, called through decoder_ar_segment_pallas). Per step, as there:
// prenet on the fed-back frame with the caller's dropout scale masks (f32),
// layer-0 LSTM gates from [prenet, context, h0], cell 0, location-sensitive
// attention (SAME conv over [w_prev, cum], f32 energies, -1e9 mask, softmax),
// context, layer-1 gates from [h0, context, h1], cell 1, fused frame + stop
// projection (f32), last frame of the group fed back. Two modes for the two
// gate products: int8 (per-row activation scale max|x|/127, round half to
// even, per-column weight scale, exact s32 sums) and bf16 (operands rounded
// to bf16, f32 sums). Everything else is f32.
//
// What bounds it on an H100: with a batch of 4 a step is a chain of small
// dependent phases, each one exchange of a few KB across the grid, so it is
// bound by latency: the grid barrier between phases (about 1.5 us a round
// on this grid) and, inside a phase, its L2 round trips and block barriers;
// then by the weight bytes a step touches (19.9 MB int8, 39.8 MB bf16 at
// production width), never by operations.
//
// Design: one cooperative launch of one 512-thread block an SM runs all K
// steps, five phases a step, each ended by the grid barrier of common.cuh:
//   prenet (kPre prenet blocks, their weights transposed in shared memory):
//     every prenet block computes all of layer 1 and a quarter of layer 2,
//     so the two layers take one round. A thread takes two outputs of up to
//     four batch rows over a share of the inputs (eight FMAs for two
//     shared-memory loads), the shares are added in order; the fed-back
//     frame, the biases and the keep masks are requested together, one L2
//     round trip;
//   gates 0 (gate blocks): block j owns U hidden units of both layers and
//     their 4U gate columns, so the cell update is local and c0 / c1 stay
//     in its shared memory. The block stages the activation row [x, ctx, h]
//     of each batch row once (quantized per row, or rounded to bf16) and
//     runs the product on tensor cores: its weight rows are the A operand
//     (m16n8k32 s8 x s8 -> s32, exactly the integer sums of the plain
//     version; or m16n8k16 bf16 -> f32), the batch rows the N of one n-tile
//     of 8 (B = 4 padded), K split over the 16 warps in 64-wide (int8) or
//     32-wide (bf16) windows; a lane loads its 16 contiguous bytes of two
//     weight rows and one activation row for a window (the permuted-k pair
//     of common.cuh), the warps' partial sums are added in a fixed order.
//     The block also adds its units' share of the attention query, h0 . wq,
//     into a per-row sum held as 64-bit fixed point (2^-32): integer
//     atomics are exact, so the query is the same whatever order the blocks
//     arrive in;
//   attention (a group of up to 8 gate blocks per batch row): every block of
//     the group computes the row's energies and softmax itself (the same
//     arithmetic, so the same values) and a 1/8 slice of the context; the
//     slice's memory values, the first keys and the query are requested at
//     the phase's start, so the phase waits on one L2 round trip;
//   gates 1: as gates 0, from [h0, context, h1];
//   projection: frame + stop outputs dealt over all blocks.
// Weights: int8 keeps both layers' rows (152 KB a block at production
// width) in shared memory for the whole launch; bf16 keeps layer 0's (128
// KB) and streams layer 1's (176 KB a block, 23 MB a step) through L2 into
// registers, the first window requested between the barrier's arrival and
// its wait. The host packs each block's rows in the order its lanes read
// them (ops/decode_kernel.py::pack_gate_weights). h0 / h1 ping-pong between
// two global buffers, read with ld.cg (never through L1).
// Past H 1024 (on an H100) a gate block owns more than 8 units, so its 4U
// gate rows take up to 4 m-tiles (a second build of the kernel, MT = 4; the
// production widths keep theirs, MT = 2), and its weight rows outgrow the
// block (464 KB int8, 352 KB bf16 at H 2048): the block keeps resident the
// first windows of each layer that fit beside the launch's other regions
// and streams the rest from L2 every step (make_layout; r0 / r1). A gate
// product deeper than kMaxK (4,608 at int8 H 2048) is staged in pieces of
// kMaxK, in int8 after a first pass for the row's scale. The attention
// phase loops over the attention units (a lane a float4 of them), so it
// takes any width.
// Past H 2048 (int8; the bf16 mode's weights are past what the reference
// admits there) a gate block owns U = ceil(H / (SMs - 4)) > 16 units, more
// than four m-tiles of gate rows: a third build (decode_kernel<true, 4,
// true>) covers them in passes of up to four m-tiles over the same staged
// activation rows, each pass's partial sums in a region of their own
// beside the staged rows, so the registers of a pass are the MT = 4
// build's. Its weights outgrow L2 too (129 MB at H 3072): the windows that
// fit stay resident, the rest stream from device memory every step; where
// wq does not fit beside the rest, the query's share reads it from L2.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 16;      // batch rows: two n-tiles of 8
// m-tiles of a block's 4U gate rows: the kernel is built for MT = 2 (U <= 8,
// H <= 1024 on an H100) and MT = 4 (U <= 16, H <= 2048), each launch taking
// the smaller that holds its rows; int8 past kMaxMt m-tiles takes the
// multi-pass build (passes of kMaxMt).
constexpr int kMaxMt = 4;
constexpr int kGroup = 8;      // blocks that share a batch row's attention
constexpr int kPre = 4;        // prenet blocks
constexpr int kPos = 4;        // memory positions a warp scores at a time
constexpr int kRows = 4;       // batch rows a staging pass
constexpr int kMaxK = 4096;    // depth of a staging piece (rows deeper are staged in pieces)
constexpr int kW1Batch = 1;    // bf16 layer-1 windows a warp requests at a time
constexpr int kCtx = 12;       // memory values a context thread requests ahead
constexpr double kFix = 4294967296.0;  // 2^32: fixed-point scale of the query sums

// Order of the pointer and dimension tables (ops/decode_kernel.py builds them).
enum Ptr {
  W0, W1, S0, B0, S1, B1, WPROJ, BPROJ, WP1, BP1, WP2, BP2, WQ, CK, WLOC, V,
  KEYS, MEMORY, MASK, M1, M2,
  H0_IN, C0_IN, H1_IN, C1_IN, W_IN, CUM_IN, CTX_IN, PREV_IN,
  YS, ALIGNS, H0_OUT, C0_OUT, H1_OUT, C1_OUT, W_OUT, CUM_OUT, CTX_OUT, PREV_OUT,
  SCRATCH, BAR, N_PTR
};
enum Dim { DK, DB, DS, DA, DD, DH, DP1, DP2, DMEL, DR, DCONVK, DCONVC, DQUANT, N_DIM };

// The grid and the shared-memory layout, the same on the host and the card.
struct Layout {
  int U, nblk, grid, group, mt, nt;  // units a block, gate blocks, blocks, attention group, tiles
  int K0p, K1p, win, nw0, nw1;       // padded depths, k a window, windows a layer
  int r0, r1;                        // resident windows of each layer (of nw0, nw1)
  int xstride;                       // bytes of a staged activation row
  int loc_res, pre_res;              // wloc + ck / the prenet weights in shared memory
  int wq_res;                        // the block's wq rows in shared memory
  size_t w, misc, att, scr, total;   // byte offsets of the regions and the size
};

struct DecArgs {
  int K, B, S, A, D, H, P1, P2, mel, r, conv_k, conv_c, quant;
  int K0, K1, NO;
  Layout L;
  const unsigned char* w[2];  // packed gate weights (ops/decode_kernel.py::pack_gate_weights)
  const float* scale[2];      // (4H) per-column weight scales (int8 mode)
  const float* bias[2];       // (4H)
  const float *wproj, *bproj;  // (NO, H + D), (NO): frames then the stop logit
  const float *wp1, *bp1, *wp2, *bp2;  // (P1, mel), (P2, P1) rows per output
  const float *wq, *ck, *wloc, *v;     // (H, A), (conv_k, 2, C), (C, A), (A)
  const float *keys, *memory, *mask;   // (B, S, A), (B, S, D), (B, S)
  const float *m1, *m2;                // (K, B, P1), (K, B, P2) or null
  const float *h_in[2], *c_in[2], *w_in, *cum_in, *ctx_in, *prev_in;
  float *ys, *aligns;                  // (K, B, NO), (K, B, S)
  float *h_out[2], *c_out[2], *w_out, *cum_out, *ctx_out, *prev_out;
  float *h_buf[2];                     // (2, B, H) ping-pong per layer
  float *ctx_buf, *a2;                 // (B, D), (B, P2)
  unsigned long long* qacc;            // (2, B, A) fixed-point query sums, by step parity
  unsigned int* bar;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// bytes of a staged row: a multiple of 16 that is 64 mod 128 (conflict-free
// 16-byte loads of 8 rows x 64 bytes).
__host__ __device__ inline int x_stride(int bytes) {
  const int s = (bytes + 63) / 64 * 64;
  return s % 128 == 0 ? s + 64 : s;
}

// Regions: the block's packed weight rows (gate blocks) or the prenet
// weights (prenet blocks); launch-long f32 state (own wq rows, bias and
// scale of both layers, c0 / c1); the attention row's state (location
// projection and conv kernel where they fit, v, (w, cum), mask); and the
// per-phase scratch. r0 / r1 of each m-tile's windows are resident.
__host__ __device__ inline void place(const DecArgs& a, Layout& L, int r0, int r1, int max_smem) {
  L.r0 = r0;
  L.r1 = r1;
  L.w = 0;
  L.misc = L.w + (size_t)1024 * L.mt * (r0 + r1);
  const size_t pad = (size_t)a.S + a.conv_k - 1;
  const size_t loc = (size_t)a.conv_c * a.A + (size_t)a.conv_k * 2 * a.conv_c;
  const size_t att = (size_t)mstts_round_up(a.A + 2 * (int)pad + a.S, 4);
  // Scratch: gates (staged rows, or over them the warps' partial sums; gate
  // values, row scales, a reduction); attention (location features, query,
  // context partials, energies); prenet (layer 1 and the fed-back frame).
  // Past kMaxMt m-tiles the passes' partial sums take a region of their own
  // beside the staged rows, which every pass reads.
  const bool mp = L.mt > kMaxMt;
  const size_t part = sizeof(float) * (size_t)kWarps * 16 * (mp ? kMaxMt : L.mt) * 8 * L.nt;
  const size_t xs = (size_t)a.B * L.xstride;
  const size_t gate = (mp ? align16(xs) + align16(part) : align16(xs > part ? xs : part)) +
                      sizeof(float) * ((size_t)16 * L.mt * kMaxB + kMaxB + kRows * kWarps);
  const size_t attn = sizeof(float) * ((size_t)kWarps * a.conv_c * kPos + a.A + kThreads + a.S);
  // prenet: layer 1, the inputs [n_in][4], the partial sums
  const size_t per = (a.P2 + kPre - 1) / kPre;
  const size_t pre = sizeof(float) * (2 * (size_t)a.B * a.P1 + a.P1 + per + a.B * per + (size_t)a.B * a.mel + 24 +
                                      4 * (size_t)(a.mel > a.P1 ? a.mel : a.P1) + (size_t)kThreads * kRows * 2);
  size_t scr = gate > attn ? gate : attn;
  scr = scr > pre ? scr : pre;
  // The location weights leave shared memory first; past kMaxMt m-tiles
  // then wq.
  for (int drop = 0; drop < (mp ? 3 : 2); ++drop) {
    L.loc_res = drop == 0;
    L.wq_res = drop < 2;
    const size_t misc = (L.wq_res ? (size_t)L.U * a.A : 0) + 4 * 16 * (size_t)L.mt +
                        2 * (size_t)a.B * L.U;
    L.att = L.misc + align16(sizeof(float) * misc);
    L.scr = L.att + align16(sizeof(float) * (att + (L.loc_res ? loc : 0)));
    L.total = L.scr + scr;
    if (L.total <= (size_t)max_smem) break;
  }
  const size_t pre_w = sizeof(float) * ((size_t)a.P1 * a.mel +
                                        (size_t)(a.P2 + kPre - 1) / kPre * a.P1);
  L.pre_res = pre_w <= L.scr;
}

// The grid, then the regions. Every window is resident (int8 both layers,
// bf16 layer 0; bf16 layer 1 streams every step) unless the weights alone
// outgrow a block: when not even a launch over one row at one position
// fits beside them (past H 1024 on an H100), the windows resident are as
// many as fit beside this launch's other regions, layer 0's first, and the
// rest of each m-tile's windows stream from L2 every step.
__host__ __device__ inline Layout make_layout(const DecArgs& a, int nsm, int max_smem) {
  Layout L = {};
  L.U = (a.H + (nsm - kPre) - 1) / (nsm - kPre);
  L.nblk = (a.H + L.U - 1) / L.U;
  L.grid = L.nblk + kPre;
  const int per_row = a.B > 0 ? L.nblk / a.B : 1;
  L.group = per_row < 1 ? 1 : (per_row < kGroup ? per_row : kGroup);
  L.mt = (4 * L.U + 15) / 16;
  L.nt = (a.B + 7) / 8;
  const bool q = a.quant != 0;
  L.win = q ? 64 : 32;
  L.K0p = (a.K0 + L.win - 1) / L.win * L.win;
  L.K1p = (a.K1 + L.win - 1) / L.win * L.win;
  L.nw0 = L.K0p / L.win;
  L.nw1 = L.K1p / L.win;
  L.xstride = x_stride((q ? 1 : 2) * (L.K0p > L.K1p ? L.K0p : L.K1p));
  const int full1 = q ? L.nw1 : 0;
  place(a, L, L.nw0, full1, max_smem);
  if (L.total <= (size_t)max_smem) return L;
  DecArgs one = a;
  one.B = 1;
  one.S = 1;
  Layout L1 = L;
  L1.nt = 1;
  place(one, L1, L.nw0, full1, max_smem);
  if (L1.total <= (size_t)max_smem) return L;  // the rows or positions are too many
  place(a, L, 0, 0, max_smem);
  if (L.total > (size_t)max_smem) return L;
  const int nres = (int)(((size_t)max_smem - L.total) / ((size_t)1024 * L.mt));
  const int r0 = nres < L.nw0 ? nres : L.nw0;
  const int r1 = nres - r0 < full1 ? nres - r0 : full1;
  place(a, L, r0, r1, max_smem);
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// m16n8k32 s8 x s8 -> s32. Fragments of lane l (g = l / 4, t = l % 4): A a0
// = (row g, k 4t..4t+3), a1 = (row g + 8, same k), a2 = (row g, k 16 + 4t..),
// a3 = (row g + 8, k 16 + 4t..); B b0 = (k 4t..4t+3, n g), b1 = (k 16 + 4t..,
// n g); C as the bf16 MMA's.
__device__ __forceinline__ void mma_s8(int* c, uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One window of a gate product. A lane holds 16 consecutive bytes of k of
// weight rows g and g + 8 (lo, hi) and of activation row g (x): 16 int8 or 8
// bf16 values. The sum over the window does not depend on which MMA slot
// carries which k, as long as A and B carry the same (common.cuh's
// permuted-k pair).
template <bool Q>
__device__ __forceinline__ void window_mma(float* cf, int* ci, const uint4& lo, const uint4& hi,
                                           const uint4& x) {
  if constexpr (Q) {
    mma_s8(ci, lo.x, hi.x, lo.y, hi.y, x.x, x.y);
    mma_s8(ci, lo.z, hi.z, lo.w, hi.w, x.z, x.w);
  } else {
    mstts_mma_bf16_k32(cf, lo, hi, x);
  }
}

// The launch's dynamic shared memory. Every region is addressed from this
// array, so that the compiler knows the space and uses shared-memory
// loads and stores.
extern __shared__ __align__(16) unsigned char smem[];

// The arguments stay in the launch's parameter space (__grid_constant__):
// the decoder holds a reference, so that no copy lands in local memory.
// MT: m-tiles a pass of the gate product holds (L.mt <= MT, or MP: passes of MT).
template <bool Q, int MT, bool MP>
struct Decoder {
  const DecArgs& a;
  int tid, warp, lane, u0, Uown, role;  // role: 0 gate block, 1 prenet block
  int row, slice;                       // attention: batch row and context slice, or -1

  __device__ explicit Decoder(const DecArgs& args) : a(args) {
    tid = threadIdx.x;
    warp = tid / 32;
    lane = tid % 32;
    const int j = blockIdx.x;
    role = j < a.L.nblk ? 0 : 1;
    u0 = j * a.L.U;
    Uown = role == 0 ? min(a.L.U, a.H - u0) : 0;
    row = role == 0 && j < a.B * a.L.group ? j / a.L.group : -1;
    slice = row >= 0 ? j % a.L.group : -1;
  }

  // -- shared memory ----------------------------------------------------------
  __device__ unsigned char* wts() const { return smem + a.L.w; }
  __device__ float* misc() const { return reinterpret_cast<float*>(smem + a.L.misc); }
  __device__ float* wq_s() const { return misc(); }  // [U][A] where wq_res
  __device__ float* bias_s(int l) const {
    return misc() + (a.L.wq_res ? a.L.U * a.A : 0) + l * 16 * a.L.mt;
  }
  __device__ float* scale_s(int l) const { return bias_s(2) + l * 16 * a.L.mt; }
  __device__ float* c_s(int l) const { return scale_s(2) + l * a.B * a.L.U; }  // [B][U]
  // Attention region: [v (A)] [(w, cum) (S + conv_k - 1)] [mask (S)], then,
  // where they fit, [wloc (C, A)] [ck (conv_k, 2, C)]: 16-byte aligned
  // first, so v and wloc are read as float4.
  __device__ float* att() const { return reinterpret_cast<float*>(smem + a.L.att); }
  __device__ float* v_s() const { return att(); }                           // [A]
  __device__ float2* wc_s() const { return reinterpret_cast<float2*>(att() + a.A); }
  __device__ float* mask_s() const {
    return reinterpret_cast<float*>(wc_s() + a.S + a.conv_k - 1);
  }
  __device__ float* loc_region() const {
    return att() + mstts_round_up(a.A + 2 * (a.S + a.conv_k - 1) + a.S, 4);
  }
  __device__ const float* wloc_p() const { return a.L.loc_res ? loc_region() : a.wloc; }
  __device__ const float* ck_p() const {
    return a.L.loc_res ? loc_region() + a.conv_c * a.A : a.ck;
  }
  __device__ unsigned char* scr() const { return smem + a.L.scr; }

  // -- launch-long state ------------------------------------------------------
  __device__ void load_state() {
    const Layout& L = a.L;
    if (role == 0) {
      // The resident windows: the first r of each m-tile's nw of each layer
      // (all of them but where the weights outgrow the block; bf16 layer 1
      // streams), m-tile after m-tile.
      unsigned char* dst = wts();
      for (int l = 0; l < 2; ++l) {
        const int nw = l == 0 ? L.nw0 : L.nw1, r = l == 0 ? L.r0 : L.r1;
        const size_t n = (size_t)1024 * L.mt * r, run = (size_t)1024 * r;
        const unsigned char* src = a.w[l] + (size_t)blockIdx.x * 1024 * L.mt * nw;
        for (size_t i = (size_t)tid * 16; i < n; i += (size_t)kThreads * 16) {
          const size_t m = i / run;
          mstts_cp_async16(dst + i, src + m * 1024 * nw + (i - m * run));
        }
        dst += n;
      }
      if (L.wq_res)
        for (int i = tid; i < L.U * a.A; i += kThreads)
          wq_s()[i] = i < Uown * a.A ? a.wq[(size_t)u0 * a.A + i] : 0.0f;
      for (int i = tid; i < 2 * 16 * L.mt; i += kThreads) {
        const int l = i / (16 * L.mt), r = i % (16 * L.mt), g = r / L.U, u = r % L.U;
        const bool ok = g < 4 && u < Uown;
        const int col = g * a.H + u0 + u;
        bias_s(l)[r] = ok ? a.bias[l][col] : 0.0f;
        scale_s(l)[r] = ok ? a.scale[l][col] : 0.0f;
      }
      for (int i = tid; i < 2 * a.B * L.U; i += kThreads) {
        const int l = i / (a.B * L.U), b = (i / L.U) % a.B, u = i % L.U;
        c_s(l)[b * L.U + u] = u < Uown ? a.c_in[l][(size_t)b * a.H + u0 + u] : 0.0f;
      }
      if (row >= 0) {
        const int pad = a.S + a.conv_k - 1, lo = (a.conv_k - 1) / 2;
        for (int i = tid; i < a.A; i += kThreads) v_s()[i] = a.v[i];
        for (int i = tid; i < a.S; i += kThreads) mask_s()[i] = a.mask[(size_t)row * a.S + i];
        for (int i = tid; i < pad; i += kThreads) {
          const int s = i - lo;
          const bool in = s >= 0 && s < a.S;
          wc_s()[i] = in ? make_float2(a.w_in[(size_t)row * a.S + s], a.cum_in[(size_t)row * a.S + s])
                         : make_float2(0.0f, 0.0f);
        }
        if (L.loc_res) {
          float* wl = loc_region();
          for (int i = tid; i < a.conv_c * a.A; i += kThreads) wl[i] = a.wloc[i];
          float* ck = wl + a.conv_c * a.A;
          for (int i = tid; i < a.conv_k * 2 * a.conv_c; i += kThreads) ck[i] = a.ck[i];
        }
      }
    } else if (L.pre_res) {
      // Prenet block x: wp1 transposed (mel, P1), then its outputs' rows of
      // wp2 transposed (P1, per): a warp's 32 outputs read 32 neighbouring
      // words.
      float* p = reinterpret_cast<float*>(wts());
      const int x = blockIdx.x - L.nblk, per = (a.P2 + kPre - 1) / kPre;
      for (int i = tid; i < a.P1 * a.mel; i += kThreads) {
        const int o = i / a.mel, c = i % a.mel;
        p[c * a.P1 + o] = a.wp1[i];
      }
      float* p2 = p + a.P1 * a.mel;
      for (int i = tid; i < per * a.P1; i += kThreads) {
        const int oo = i / a.P1, c = i % a.P1, o = x * per + oo;
        p2[c * per + oo] = o < a.P2 ? a.wp2[(size_t)o * a.P1 + c] : 0.0f;
      }
    }
    mstts_cp_async_wait_all();
    __syncthreads();
  }

  // -- prenet: both layers in the prenet blocks -------------------------------
  // out[b][o] = relu(sum_c x[c][b] w[c][o] + bias[o]) * keep[b][o] for the
  // block's n_out outputs: a thread takes an output pair and up to kRows
  // rows over a share of c (a float2 of w and a float4 of x a step: eight
  // FMAs for two shared-memory loads), the shares are added in order.
  // x: [n_in][4] f32 (rows b0 .. b0 + 3, zero past B) in shared memory; w:
  // [n_in][n_out] (transposed, resident) or the device copy [n_out][n_in].
  // bias [n_valid] and keep [B][n_valid] (or null) are shared-memory
  // copies of the layer's slice.
  __device__ void prenet_layer(const float* x, int n_in, const float* w, bool res, int n_out,
                               int n_valid, const float* bias, const float* keep, int b0,
                               int rows, float* out, int out_stride, float* part) const {
    const int pairs = (n_out + 1) / 2;
    const int parts = max(1, min(kThreads / pairs, n_in / 4));
    const int pr = tid % pairs, pi = tid / pairs;
    const int c0 = pi * ((n_in + parts - 1) / parts), c1 = min(n_in, c0 + (n_in + parts - 1) / parts);
    float acc[2][kRows] = {};
    if (pi < parts) {
      const int o = 2 * pr;
      for (int c = c0; c < c1; ++c) {
        const float4 xv = *reinterpret_cast<const float4*>(x + 4 * c);
        float w0, w1;
        if (res) {
          const float2 wv = *reinterpret_cast<const float2*>(w + (size_t)c * n_out + o);
          w0 = wv.x;
          w1 = wv.y;
        } else {
          w0 = o < n_valid ? __ldg(w + (size_t)o * n_in + c) : 0.0f;
          w1 = o + 1 < n_valid ? __ldg(w + (size_t)(o + 1) * n_in + c) : 0.0f;
        }
        const float xr[kRows] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[0][r] = fmaf(xr[r], w0, acc[0][r]);
          acc[1][r] = fmaf(xr[r], w1, acc[1][r]);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[(pi * kRows + r) * 2 * pairs + 2 * pr + e] = acc[e][r];
    }
    __syncthreads();
    for (int i = tid; i < rows * n_valid; i += kThreads) {
      const int r = i / n_valid, o = i - r * n_valid;
      float y = 0.0f;
      for (int q = 0; q < parts; ++q) y += part[(q * kRows + r) * 2 * pairs + o];
      y = fmaxf(y + bias[o], 0.0f);
      if (keep != nullptr) y *= keep[(b0 + r) * n_valid + o];
      out[(size_t)(b0 + r) * out_stride + o] = y;
    }
    __syncthreads();
  }

  __device__ void prenet(int k, const float* prev, int prev_stride) {
    if (role != 1) return;
    const int B = a.B, P1 = a.P1, P2 = a.P2, mel = a.mel;
    const int x = blockIdx.x - a.L.nblk, per = (P2 + kPre - 1) / kPre;
    const int o2 = x * per, nv2 = max(0, min(per, P2 - o2));
    const bool res = a.L.pre_res;
    const float* wp1 = res ? reinterpret_cast<const float*>(wts()) : a.wp1;
    const float* wp2 = res ? wp1 + P1 * mel : a.wp2 + (size_t)o2 * P1;
    // Scratch: layer 1 [B][P1]; the layers' biases and keep masks (this
    // block's slice of layer 2); the fed-back frame [mel][4] rows a group;
    // the layers' inputs [n_in][4]; partial sums. Every global value the
    // phase reads is requested at its start: one L2 round trip.
    float* a1 = reinterpret_cast<float*>(scr());
    float* bias1 = a1 + mstts_round_up(B * P1, 4);
    float* bias2 = bias1 + mstts_round_up(P1, 4);
    float* keep1 = bias2 + mstts_round_up(per, 4);
    float* keep2 = keep1 + mstts_round_up(B * P1, 4);
    float* frame = keep2 + mstts_round_up(B * per, 4);
    float* xin = frame + mstts_round_up(B * mel, 4);
    float* part = xin + 4 * (mel > P1 ? mel : P1);
    const float* m1 = a.m1 != nullptr ? a.m1 + (size_t)k * B * P1 : nullptr;
    const float* m2 = a.m2 != nullptr ? a.m2 + (size_t)k * B * P2 : nullptr;
    for (int i = tid; i < B * mel; i += kThreads) {
      const int b = i / mel;
      frame[i] = __ldcg(prev + (size_t)b * prev_stride + (i - b * mel));
    }
    for (int i = tid; i < P1; i += kThreads) bias1[i] = __ldg(a.bp1 + i);
    for (int i = tid; i < nv2; i += kThreads) bias2[i] = __ldg(a.bp2 + o2 + i);
    if (m1 != nullptr)
      for (int i = tid; i < B * P1; i += kThreads) keep1[i] = __ldg(m1 + i);
    if (m2 != nullptr)
      for (int i = tid; i < B * nv2; i += kThreads) {
        const int b = i / nv2;
        keep2[i] = __ldg(m2 + (size_t)b * P2 + o2 + (i - b * nv2));
      }
    __syncthreads();
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      for (int i = tid; i < 4 * mel; i += kThreads) {
        const int c = i / 4, r = i % 4;
        xin[i] = r < rows ? frame[(b0 + r) * mel + c] : 0.0f;
      }
      __syncthreads();
      prenet_layer(xin, mel, wp1, res, P1, P1, bias1, m1 != nullptr ? keep1 : nullptr, b0, rows,
                   a1, P1, part);
    }
    for (int b0 = 0; b0 < B; b0 += kRows) {
      const int rows = min(kRows, B - b0);
      for (int i = tid; i < 4 * P1; i += kThreads) {
        const int c = i / 4, r = i % 4;
        xin[i] = r < rows ? a1[(b0 + r) * P1 + c] : 0.0f;
      }
      __syncthreads();
      if (nv2 > 0)
        prenet_layer(xin, P1, wp2, res, res ? per : nv2, nv2, bias2,
                     m2 != nullptr ? keep2 : nullptr, b0, rows, a.a2 + o2, P2, part);
    }
  }

  // -- gates: stage [x0, x1, x2], tensor-core product, cell -------------------
  // Segment widths n0, D, H (x0: prenet or h0; x1: context; x2: h). Rows of
  // up to kRows batch rows at a time: every thread's 16-byte loads are
  // requested before the first is used (one L2 round trip), then the row's
  // scale (int8) and the quantized (or bf16) values go to shared memory.
  __device__ void stage(const float* x0, int n0, const float* x1, const float* x2, int Kdim,
                        int Kp, unsigned char* xs, float* amax_s, float* red) const {
    const int B_ = a.B;
    const int D_ = a.D;
    const int H_ = a.H;
    const int L_xstride = a.L.xstride;
    const int n1 = n0 + D_;
    const int kd4 = Kdim / 4;
    auto load4 = [&](int b, int i) -> float4 {
      const float* src = i < n0   ? x0 + (size_t)b * n0 + i
                         : i < n1 ? x1 + (size_t)b * D_ + (i - n0)
                                  : x2 + (size_t)b * H_ + (i - n1);
      return __ldcg(reinterpret_cast<const float4*>(src));
    };
    // A row is staged in pieces of kMaxK values (one piece up to kMaxK
    // deep). A thread's 16-byte loads of a piece: row r of the group, loads
    // tid + n kThreads (kMaxK / 4 <= 2 kThreads). In int8 mode a row deeper
    // than one piece takes its scale from a first pass over every piece.
    const int pieces = (Kdim + kMaxK - 1) / kMaxK;
    for (int b0 = 0; b0 < B_; b0 += kRows) {
      const int rows = min(kRows, B_ - b0);
      float4 v[kRows][2];
      auto load_piece = [&](int p) {
        const int k0 = p * kMaxK, kd4p = min(kd4 - k0 / 4, kMaxK / 4);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int q = tid + n * kThreads;
            v[r][n] = r < rows && q < kd4p ? load4(b0 + r, k0 + 4 * q)
                                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          }
      };
      auto row_scales = [&](float (&m)[kRows]) {
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float mr = warp_max(m[r]);
          if (lane == 0) red[r * kWarps + warp] = mr;
        }
        __syncthreads();
        if (tid < rows) {
          float mm = 0.0f;
          for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red[tid * kWarps + w]);
          amax_s[b0 + tid] = fmaxf(mm, 1e-8f) / 127.0f;
        }
        __syncthreads();
      };
      auto absmax = [&](float (&m)[kRows]) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int n = 0; n < 2; ++n)
            m[r] = fmaxf(m[r], fmaxf(fmaxf(fabsf(v[r][n].x), fabsf(v[r][n].y)),
                                     fmaxf(fabsf(v[r][n].z), fabsf(v[r][n].w))));
      };
      if (Q && pieces > 1) {
        float m[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int p = 0; p < pieces; ++p) {
          load_piece(p);
          absmax(m);
        }
        row_scales(m);
      }
      for (int p = 0; p < pieces; ++p) {
        load_piece(p);
        if (Q && pieces == 1) {
          float m[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
          absmax(m);
          row_scales(m);
        }
        const int k0 = p * kMaxK, kd4p = min(kd4 - k0 / 4, kMaxK / 4);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (r >= rows) break;
          unsigned char* row = xs + (size_t)(b0 + r) * L_xstride + (Q ? k0 : 2 * k0);
          const float am = Q ? amax_s[b0 + r] : 1.0f;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int q = tid + n * kThreads;
            if (q >= kd4p) continue;
            const float4 vv = v[r][n];
            if (Q) {
              char4 c;
              c.x = (signed char)fminf(fmaxf(rintf(vv.x / am), -127.0f), 127.0f);
              c.y = (signed char)fminf(fmaxf(rintf(vv.y / am), -127.0f), 127.0f);
              c.z = (signed char)fminf(fmaxf(rintf(vv.z / am), -127.0f), 127.0f);
              c.w = (signed char)fminf(fmaxf(rintf(vv.w / am), -127.0f), 127.0f);
              *reinterpret_cast<char4*>(row + 4 * q) = c;
            } else {
              __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(row + 8 * q);
              dst[0] = __floats2bfloat162_rn(vv.x, vv.y);
              dst[1] = __floats2bfloat162_rn(vv.z, vv.w);
            }
          }
        }
      }
    }
    // The depth padding of every staged row is zero.
    const int npad = Kp - Kdim;
    for (int i = tid; i < B_ * npad; i += kThreads) {
      const int b = i / npad, kx = Kdim + i % npad;
      if (Q)
        xs[(size_t)b * L_xstride + kx] = 0;
      else
        reinterpret_cast<__nv_bfloat16*>(xs + (size_t)b * L_xstride)[kx] = __float2bfloat16(0.0f);
    }
    __syncthreads();
  }

  // This warp's windows of the product into acc (m-tile, n-tile) for the
  // mtp m-tiles from m0 (a pass; all of them but past kMaxMt). The layer's
  // first nres windows of each m-tile from shared memory (w_s), the rest
  // streamed from device memory: bf16 layer 1 (nres 0) kW1Batch windows at
  // a time, of which `pre` holds the first batch, requested before the
  // phase's barrier wait; any other partly resident layer (past H 1024)
  // window by window.
  __device__ void product(int layer, int nw, int nres, const unsigned char* w_s,
                          const unsigned char* xs, float (&accf)[MT][2][4], int (&acci)[MT][2][4],
                          uint4 (&pre)[kW1Batch][MT][2], int m0, int mtp) const {
    const int B_ = a.B;
    const int L_mt = mtp;
    const int L_nt = a.L.nt;
    const int L_xstride = a.L.xstride;
    const int g = lane >> 2, t = lane & 3;
    auto xfrag = [&](int w, int nt) -> uint4 {
      const int n = 8 * nt + g;
      if (nt >= L_nt || n >= B_) return make_uint4(0u, 0u, 0u, 0u);
      return *reinterpret_cast<const uint4*>(xs + (size_t)n * L_xstride + w * 64 + 16 * t);
    };
    if (nres == nw) {
      for (int w = warp; w < nw; w += kWarps) {
        const uint4 x[2] = {xfrag(w, 0), xfrag(w, 1)};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= L_mt) break;
          const unsigned char* p = w_s + ((size_t)(m0 + m) * nw + w) * 1024 + 16 * lane;
          const uint4 lo = *reinterpret_cast<const uint4*>(p);
          const uint4 hi = *reinterpret_cast<const uint4*>(p + 512);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (nt < L_nt) window_mma<Q>(accf[m][nt], acci[m][nt], lo, hi, x[nt]);
        }
      }
      return;
    }
    const unsigned char* base = a.w[layer] + (size_t)blockIdx.x * 1024 * a.L.mt * nw;
    if (Q || layer == 0 || nres > 0) {
      for (int w = warp; w < nw; w += kWarps) {
        const uint4 x[2] = {xfrag(w, 0), xfrag(w, 1)};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= L_mt) break;
          uint4 lo, hi;
          if (w < nres) {
            const unsigned char* p = w_s + ((size_t)(m0 + m) * nres + w) * 1024 + 16 * lane;
            lo = *reinterpret_cast<const uint4*>(p);
            hi = *reinterpret_cast<const uint4*>(p + 512);
          } else {
            const unsigned char* p = base + ((size_t)(m0 + m) * nw + w) * 1024 + 16 * lane;
            lo = __ldg(reinterpret_cast<const uint4*>(p));
            hi = __ldg(reinterpret_cast<const uint4*>(p + 512));
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (nt < L_nt) window_mma<Q>(accf[m][nt], acci[m][nt], lo, hi, x[nt]);
        }
      }
      return;
    }
    for (int w0 = warp; w0 < nw; w0 += kWarps * kW1Batch) {
      uint4 wv[kW1Batch][MT][2];
      if (w0 == warp) {
#pragma unroll
        for (int bi = 0; bi < kW1Batch; ++bi)
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            wv[bi][m][0] = pre[bi][m][0];
            wv[bi][m][1] = pre[bi][m][1];
          }
      } else {
        request_w1(base, nw, w0, wv);
      }
#pragma unroll
      for (int bi = 0; bi < kW1Batch; ++bi) {
        const int w = w0 + bi * kWarps;
        if (w >= nw) break;
        const uint4 x[2] = {xfrag(w, 0), xfrag(w, 1)};
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          if (m >= L_mt) break;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            if (nt < L_nt) window_mma<Q>(accf[m][nt], acci[m][nt], wv[bi][m][0], wv[bi][m][1], x[nt]);
        }
      }
    }
  }

  // A warp's kW1Batch windows w0, w0 + kWarps, ... of the streamed layer.
  __device__ void request_w1(const unsigned char* base, int nw, int w0,
                             uint4 (&wv)[kW1Batch][MT][2]) const {
#pragma unroll
    for (int bi = 0; bi < kW1Batch; ++bi) {
      const int w = w0 + bi * kWarps;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (w < nw && m < a.L.mt) {
          const unsigned char* p = base + ((size_t)m * nw + w) * 1024 + 16 * lane;
          wv[bi][m][0] = __ldg(reinterpret_cast<const uint4*>(p));
          wv[bi][m][1] = __ldg(reinterpret_cast<const uint4*>(p + 512));
        } else {
          wv[bi][m][0] = wv[bi][m][1] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
  }

  __device__ void prefetch_w1(uint4 (&pre)[kW1Batch][MT][2]) const {
    if (role == 0)
      request_w1(a.w[1] + (size_t)blockIdx.x * 1024 * a.L.mt * a.L.nw1, a.L.nw1, warp, pre);
  }

  // One layer's step for this block's units. Layer 0 also adds the units'
  // share of the attention query into qacc.
  __device__ void gates(int layer, const float* x0, int n0, const float* x1, const float* h_prev,
                        float* h_next, unsigned long long* qacc,
                        uint4 (&pre)[kW1Batch][MT][2]) {
    const int B_ = a.B;
    const int A_ = a.A;
    const int H_ = a.H;
    const int K0_ = a.K0;
    const int K1_ = a.K1;
    const int L_U = a.L.U;
    const int L_mt = a.L.mt;
    const int L_nt = a.L.nt;
    const int L_xstride = a.L.xstride;
    const int L_nw0 = a.L.nw0;
    const int L_nw1 = a.L.nw1;
    const int L_K0p = a.L.K0p;
    const int L_K1p = a.L.K1p;
    if (role != 0) return;
    const int Kdim = layer == 0 ? K0_ : K1_, Kp = layer == 0 ? L_K0p : L_K1p;
    const int nw = layer == 0 ? L_nw0 : L_nw1;
    const int ncol = 8 * L_nt, mt_pass = MP ? MT : L_mt;
    // Scratch: the staged rows, and over them (after the product) the
    // warps' partial sums [warp][row][col] (past kMaxMt m-tiles beside
    // them: every pass reads the staged rows); then the gate values
    // [row][kMaxB], the row scales and a reduction buffer.
    unsigned char* xs = scr();
    const size_t xs_bytes = (size_t)B_ * L_xstride;
    const size_t part_bytes = sizeof(float) * (size_t)kWarps * 16 * mt_pass * ncol;
    float* red = reinterpret_cast<float*>(scr() + (MP ? align16(xs_bytes) : 0));
    float* gv = reinterpret_cast<float*>(
        scr() + (MP ? align16(xs_bytes) + align16(part_bytes)
                    : align16(xs_bytes > part_bytes ? xs_bytes : part_bytes)));
    float* amax_s = gv + 16 * L_mt * kMaxB;
    float* mred = amax_s + kMaxB;
    stage(x0, n0, x1, h_prev, Kdim, Kp, xs, amax_s, mred);
    const unsigned char* w_s = layer == 0 ? wts() : wts() + (size_t)1024 * L_mt * a.L.r0;
    const float* sc = scale_s(layer);
    const float* bi = bias_s(layer);
    const int g = lane >> 2, t = lane & 3;
    const int passes = MP ? (L_mt + MT - 1) / MT : 1;
    for (int ps = 0; ps < passes; ++ps) {
      const int m0 = MT * ps, mtp = MP ? min(MT, L_mt - m0) : L_mt, rows16 = 16 * mtp;
      float accf[MT][2][4] = {};
      int acci[MT][2][4] = {};
      product(layer, nw, layer == 0 ? a.L.r0 : a.L.r1, w_s, xs, accf, acci, pre, m0, mtp);
      if (!MP) __syncthreads();  // the staged rows are consumed: their space takes the partial sums
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        if (m >= mtp) break;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (nt >= L_nt) break;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = 16 * m + g + 8 * (e >> 1), c = 8 * nt + 2 * t + (e & 1);
            red[(warp * rows16 + r) * ncol + c] = Q ? __int_as_float(acci[m][nt][e]) : accf[m][nt][e];
          }
        }
      }
      __syncthreads();
      for (int i = tid; i < rows16 * B_; i += kThreads) {
        const int r = i / B_, c = i % B_, rg = 16 * m0 + r;
        float v;
        if (Q) {
          int sum = 0;
          for (int w = 0; w < kWarps; ++w) sum += __float_as_int(red[(w * rows16 + r) * ncol + c]);
          v = __int2float_rn(sum) * (amax_s[c] * sc[rg]);
        } else {
          v = 0.0f;
          for (int w = 0; w < kWarps; ++w) v += red[(w * rows16 + r) * ncol + c];
        }
        gv[rg * kMaxB + c] = v + bi[rg];
      }
      __syncthreads();
    }
    float* cs = c_s(layer);
    float* hown = red;  // [B][U]: the partial sums are consumed
    for (int i = tid; i < B_ * Uown; i += kThreads) {
      const int b = i / Uown, u = i % Uown;
      const float ig = mstts_sigmoid(gv[u * kMaxB + b]);
      const float fg = mstts_sigmoid(gv[(L_U + u) * kMaxB + b]);
      const float gg = tanhf(gv[(2 * L_U + u) * kMaxB + b]);
      const float og = mstts_sigmoid(gv[(3 * L_U + u) * kMaxB + b]);
      const float c = fg * cs[b * L_U + u] + ig * gg;
      const float h = og * tanhf(c);
      cs[b * L_U + u] = c;
      h_next[(size_t)b * H_ + u0 + u] = h;
      hown[b * L_U + u] = h;
    }
    if (qacc != nullptr) {
      __syncthreads();
      const float* wq = a.L.wq_res ? wq_s() : a.wq + (size_t)u0 * A_;
      for (int i = tid; i < B_ * A_; i += kThreads) {
        const int b = i / A_, ai = i % A_;
        float acc = 0.0f;
        for (int u = 0; u < Uown; ++u) acc = fmaf(hown[b * L_U + u], wq[u * A_ + ai], acc);
        atomicAdd(qacc + i, (unsigned long long)__double2ll_rn((double)acc * kFix));
      }
    }
  }

  // -- attention for batch row `row`: energies, softmax, a context slice ----
  __device__ void attention(int k, const unsigned long long* qacc, unsigned long long* qnext,
                            float* ctx_new) {
    const int B_ = a.B;
    const int S_ = a.S;
    const int A_ = a.A;
    const int D_ = a.D;
    const int conv_k_ = a.conv_k;
    const int conv_c_ = a.conv_c;
    const int L_group = a.L.group;
    const float* const keys_ = a.keys;
    const float* const memory_ = a.memory;
    float* const aligns_ = a.aligns;
    if (row < 0) return;
    const int b = row, lo = (conv_k_ - 1) / 2;
    // Scratch: location features per warp [C][kPos] and the query (read as
    // float4), context partials, energies.
    float* loc_s = reinterpret_cast<float*>(scr());
    float* q_s = loc_s + kWarps * conv_c_ * kPos;
    float* part = q_s + A_;
    float* e_s = part + kThreads;
    // The context slice's memory values: thread (channel d, part pi) sums
    // positions pi, pi + parts, ...; the first kCtx of them are requested
    // now, with the row's first keys and its query, so that the phase waits
    // on one L2 round trip.
    const int per = (D_ + L_group - 1) / L_group, d0 = slice * per;
    const int nd = max(0, min(per, D_ - d0));
    const int parts = nd > 0 ? max(1, kThreads / nd) : 1;
    const int d = tid % max(nd, 1), pi = tid / max(nd, 1);
    const bool ctx_thread = nd > 0 && pi < parts;
    const float* mem = memory_ + (size_t)b * S_ * D_ + d0 + d;
    float mv[kCtx];
#pragma unroll
    for (int j = 0; j < kCtx; ++j) {
      const int s = pi + j * parts;
      mv[j] = ctx_thread && s < S_ ? __ldg(mem + (size_t)s * D_) : 0.0f;
    }
    // The row's query; the block's share of the next step's sums is zeroed.
    for (int i = tid; i < A_; i += kThreads)
      q_s[i] = (float)((double)(long long)__ldcg(qacc + (size_t)b * A_ + i) / kFix);
    {
      const int per = (A_ + L_group - 1) / L_group;
      for (int i = slice * per + tid; i < min(A_, (slice + 1) * per); i += kThreads)
        qnext[(size_t)b * A_ + i] = 0ull;
    }
    __syncthreads();
    const int a4n = A_ / 4;
    const float* ck = ck_p();
    const float* wloc = wloc_p();
    const float* msk = mask_s();
    const float4* v4s = reinterpret_cast<const float4*>(v_s());
    float2* wc = wc_s();
    float4* loc4 = reinterpret_cast<float4*>(loc_s) + warp * conv_c_;  // [channel][position]
    const float4* key4 = reinterpret_cast<const float4*>(keys_ + (size_t)b * S_ * A_);
    for (int s0 = warp; s0 < S_; s0 += kWarps * kPos) {
      int sp[kPos];  // positions past the end repeat the last one and are dropped
      float4 kv[kPos];  // the first keys are requested before the conv
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
        sp[p] = min(s0 + kWarps * p, S_ - 1);
        kv[p] = lane < a4n ? __ldg(key4 + (size_t)sp[p] * a4n + lane)
                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      for (int c = lane; c < conv_c_; c += 32) {
        float aw[kPos] = {0.0f, 0.0f, 0.0f, 0.0f}, ac[kPos] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
        for (int tap = 0; tap < conv_k_; ++tap) {
          const float kw = ck[(tap * 2) * conv_c_ + c], kc = ck[(tap * 2 + 1) * conv_c_ + c];
#pragma unroll
          for (int p = 0; p < kPos; ++p) {
            const float2 x = wc[sp[p] + tap];
            aw[p] = fmaf(x.x, kw, aw[p]);
            ac[p] = fmaf(x.y, kc, ac[p]);
          }
        }
        loc4[c] = make_float4(aw[0] + ac[0], aw[1] + ac[1], aw[2] + ac[2], aw[3] + ac[3]);
      }
      __syncwarp();
      float partv[kPos] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int a4 = lane; a4 < a4n; a4 += 32) {
        if (a4 != lane) {
#pragma unroll
          for (int p = 0; p < kPos; ++p) kv[p] = __ldg(key4 + (size_t)sp[p] * a4n + a4);
        }
        float4 la[kPos];
#pragma unroll
        for (int p = 0; p < kPos; ++p) la[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
        for (int c = 0; c < conv_c_; ++c) {
          const float4 l4 = loc4[c];
          const float l[kPos] = {l4.x, l4.y, l4.z, l4.w};
          const float4 wl = reinterpret_cast<const float4*>(wloc)[c * a4n + a4];
#pragma unroll
          for (int p = 0; p < kPos; ++p) {
            la[p].x = fmaf(l[p], wl.x, la[p].x);
            la[p].y = fmaf(l[p], wl.y, la[p].y);
            la[p].z = fmaf(l[p], wl.z, la[p].z);
            la[p].w = fmaf(l[p], wl.w, la[p].w);
          }
        }
        const float4 q4 = reinterpret_cast<const float4*>(q_s)[a4];
        const float4 v4 = v4s[a4];
#pragma unroll
        for (int p = 0; p < kPos; ++p) {
          partv[p] = fmaf(tanhf(q4.x + kv[p].x + la[p].x), v4.x, partv[p]);
          partv[p] = fmaf(tanhf(q4.y + kv[p].y + la[p].y), v4.y, partv[p]);
          partv[p] = fmaf(tanhf(q4.z + kv[p].z + la[p].z), v4.z, partv[p]);
          partv[p] = fmaf(tanhf(q4.w + kv[p].w + la[p].w), v4.w, partv[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
        const float e = warp_sum(partv[p]);
        if (lane == 0 && s0 + kWarps * p < S_) e_s[sp[p]] = msk[sp[p]] > 0.0f ? e : -1e9f;
      }
      __syncwarp();
    }
    __syncthreads();
    if (warp == 0) {
      float m = -INFINITY;
      for (int s = lane; s < S_; s += 32) m = fmaxf(m, e_s[s]);
      m = warp_max(m);
      float sum = 0.0f;
      for (int s = lane; s < S_; s += 32) {
        const float p = expf(e_s[s] - m);
        e_s[s] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      for (int s = lane; s < S_; s += 32) e_s[s] = e_s[s] / sum;
    }
    __syncthreads();
    for (int s = tid; s < S_; s += kThreads) {
      const float p = e_s[s];
      wc[lo + s] = make_float2(p, wc[lo + s].y + p);
      if (slice == 0) aligns_[((size_t)k * B_ + b) * S_ + s] = p;
    }
    // The context slice from the values requested at the phase's start (and
    // any positions past them); the parts are added in order.
    float acc = 0.0f;
    if (ctx_thread) {
#pragma unroll
      for (int j = 0; j < kCtx; ++j) {
        const int s = pi + j * parts;
        if (s < S_) acc = fmaf(e_s[s], mv[j], acc);
      }
      for (int s = pi + kCtx * parts; s < S_; s += parts) acc = fmaf(e_s[s], __ldg(mem + (size_t)s * D_), acc);
      part[tid] = acc;
    }
    __syncthreads();
    if (tid < nd) {
      float c = 0.0f;
      for (int p = 0; p < parts; ++p) c += part[p * nd + tid];
      ctx_new[(size_t)b * D_ + d0 + tid] = c;
    }
  }

  // -- projection: frame + stop outputs over all blocks -----------------------
  __device__ void projection(int k, const float* h1, const float* ctx) {
    const int K_ = a.K;
    const int B_ = a.B;
    const int D_ = a.D;
    const int H_ = a.H;
    const int mel_ = a.mel;
    const int r_ = a.r;
    const int NO_ = a.NO;
    const float* const wproj_ = a.wproj;
    const float* const bproj_ = a.bproj;
    float* const ys_ = a.ys;
    float* const prev_out_ = a.prev_out;
    float* red_s = reinterpret_cast<float*>(scr());
    const int n4 = (H_ + D_) / 4;
    for (int o = blockIdx.x; o < NO_; o += gridDim.x) {
      const float4* wr = reinterpret_cast<const float4*>(wproj_ + (size_t)o * (H_ + D_));
      const float bias = __ldg(bproj_ + o);
      for (int b0 = 0; b0 < B_; b0 += kRows) {
        const int rows = min(kRows, B_ - b0);
        float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = tid; i < n4; i += kThreads) {
          const float4 wv = __ldg(wr + i);
          const int e = 4 * i;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (j < rows) {
              const float* xp = e < H_ ? h1 + (size_t)(b0 + j) * H_ + e
                                        : ctx + (size_t)(b0 + j) * D_ + (e - H_);
              const float4 xv = __ldcg(reinterpret_cast<const float4*>(xp));
              acc[j] = fmaf(xv.x, wv.x, acc[j]);
              acc[j] = fmaf(xv.y, wv.y, acc[j]);
              acc[j] = fmaf(xv.z, wv.z, acc[j]);
              acc[j] = fmaf(xv.w, wv.w, acc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kRows; ++j) {
          const float sum = warp_sum(acc[j]);
          if (lane == 0) red_s[j * kWarps + warp] = sum;
        }
        __syncthreads();
        if (tid < rows) {
          float y = bias;
          for (int w = 0; w < kWarps; ++w) y += red_s[tid * kWarps + w];
          ys_[((size_t)k * B_ + b0 + tid) * NO_ + o] = y;
          const int f = o - mel_ * (r_ - 1);
          if (k == K_ - 1 && f >= 0 && f < mel_) prev_out_[(size_t)(b0 + tid) * mel_ + f] = y;
        }
        __syncthreads();
      }
    }
  }

  __device__ void finish() {
    if (role != 0) return;
    for (int i = tid; i < a.B * Uown; i += kThreads) {
      const int b = i / Uown, u = i % Uown;
      a.c_out[0][(size_t)b * a.H + u0 + u] = c_s(0)[b * a.L.U + u];
      a.c_out[1][(size_t)b * a.H + u0 + u] = c_s(1)[b * a.L.U + u];
    }
    if (slice == 0) {
      const int lo = (a.conv_k - 1) / 2;
      for (int s = tid; s < a.S; s += kThreads) {
        a.w_out[(size_t)row * a.S + s] = wc_s()[lo + s].x;
        a.cum_out[(size_t)row * a.S + s] = wc_s()[lo + s].y;
      }
    }
  }
};

template <bool Q, int MT, bool MP>
__global__ void __launch_bounds__(kThreads, 1) decode_kernel(const __grid_constant__ DecArgs a) {
  Decoder<Q, MT, MP> d(a);
  // The query sums start at zero (both parities).
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < 2 * a.B * a.A; i += gridDim.x * kThreads)
    a.qacc[i] = 0ull;
  d.load_state();
  unsigned int epoch = 0;  // of the grid barrier
  uint4 pre[kW1Batch][MT][2] = {};
  for (int k = 0; k < a.K; ++k) {
    // State versions: before step 0 the inputs, after step K-1 the outputs.
    const float* h_old[2];
    float* h_new[2];
    for (int l = 0; l < 2; ++l) {
      h_old[l] = k == 0 ? a.h_in[l] : a.h_buf[l] + (size_t)(k & 1) * a.B * a.H;
      h_new[l] = k == a.K - 1 ? a.h_out[l] : a.h_buf[l] + (size_t)((k + 1) & 1) * a.B * a.H;
    }
    const float* ctx_old = k == 0 ? a.ctx_in : a.ctx_buf;
    float* ctx_new = k == a.K - 1 ? a.ctx_out : a.ctx_buf;
    const float* prev = k == 0 ? a.prev_in
                               : a.ys + (size_t)(k - 1) * a.B * a.NO + a.mel * (a.r - 1);
    const int prev_stride = k == 0 ? a.mel : a.NO;
    unsigned long long* qcur = a.qacc + (size_t)(k & 1) * a.B * a.A;
    unsigned long long* qnext = a.qacc + (size_t)((k + 1) & 1) * a.B * a.A;

    d.prenet(k, prev, prev_stride);
    mstts_grid_barrier(a.bar, epoch);
    d.gates(0, a.a2, a.P2, ctx_old, h_old[0], h_new[0], qcur, pre);
    mstts_grid_barrier(a.bar, epoch);
    d.attention(k, qcur, qnext, ctx_new);
    // bf16: the first layer-1 weight windows depend on no other block.
    mstts_grid_arrive(a.bar, epoch);
    if (!Q) d.prefetch_w1(pre);
    mstts_grid_wait(a.bar, epoch);
    d.gates(1, h_new[0], a.H, ctx_new, h_old[1], h_new[1], nullptr, pre);
    mstts_grid_barrier(a.bar, epoch);
    d.projection(k, h_new[1], ctx_new);
    if (k + 1 < a.K) mstts_grid_barrier(a.bar, epoch);
  }
  d.finish();
}

}  // namespace

// The grid and shared memory of a launch, for the wrapper's packing and the
// tests: 10 ints (U, gate blocks, blocks, attention group, m-tiles, window,
// bytes of shared memory, 1 if it fits the card, resident windows of layer
// 0 and of layer 1).
MSTTS_EXPORT int mstts_decode_layout(const int* d, void* out) {
  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  DecArgs a = {};
  a.B = d[DB]; a.S = d[DS]; a.A = d[DA]; a.D = d[DD]; a.H = d[DH];
  a.P1 = d[DP1]; a.P2 = d[DP2]; a.mel = d[DMEL]; a.conv_k = d[DCONVK]; a.conv_c = d[DCONVC];
  a.quant = d[DQUANT];
  a.K0 = a.P2 + a.D + a.H;
  a.K1 = 2 * a.H + a.D;
  if (nsm <= kPre) return (int)cudaErrorInvalidConfiguration;
  const Layout L = make_layout(a, nsm, max_smem);
  int* o = static_cast<int*>(out);
  o[0] = L.U; o[1] = L.nblk; o[2] = L.grid; o[3] = L.group; o[4] = L.mt; o[5] = L.win;
  o[6] = (int)L.total;
  o[7] = L.total <= (size_t)max_smem && L.grid <= nsm && (L.mt <= kMaxMt || a.quant) &&
         a.B <= L.nblk;
  o[8] = L.r0;
  o[9] = L.r1;
  return 0;
}

MSTTS_EXPORT int mstts_decode_segment(const void* const* p, const int* d, void* stream) {
  DecArgs a = {};
  a.K = d[DK]; a.B = d[DB]; a.S = d[DS]; a.A = d[DA]; a.D = d[DD]; a.H = d[DH];
  a.P1 = d[DP1]; a.P2 = d[DP2]; a.mel = d[DMEL]; a.r = d[DR];
  a.conv_k = d[DCONVK]; a.conv_c = d[DCONVC];
  a.quant = d[DQUANT];
  const bool quantized = a.quant != 0;
  a.K0 = a.P2 + a.D + a.H;
  a.K1 = 2 * a.H + a.D;
  a.NO = a.mel * a.r + 1;
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto fm = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  a.w[0] = static_cast<const unsigned char*>(p[W0]);
  a.w[1] = static_cast<const unsigned char*>(p[W1]);
  a.scale[0] = f(S0); a.scale[1] = f(S1);
  a.bias[0] = f(B0); a.bias[1] = f(B1);
  a.wproj = f(WPROJ); a.bproj = f(BPROJ);
  a.wp1 = f(WP1); a.bp1 = f(BP1); a.wp2 = f(WP2); a.bp2 = f(BP2);
  a.wq = f(WQ); a.ck = f(CK); a.wloc = f(WLOC); a.v = f(V);
  a.keys = f(KEYS); a.memory = f(MEMORY); a.mask = f(MASK);
  a.m1 = f(M1); a.m2 = f(M2);
  a.h_in[0] = f(H0_IN); a.c_in[0] = f(C0_IN); a.h_in[1] = f(H1_IN); a.c_in[1] = f(C1_IN);
  a.w_in = f(W_IN); a.cum_in = f(CUM_IN); a.ctx_in = f(CTX_IN); a.prev_in = f(PREV_IN);
  a.ys = fm(YS); a.aligns = fm(ALIGNS);
  a.h_out[0] = fm(H0_OUT); a.c_out[0] = fm(C0_OUT); a.h_out[1] = fm(H1_OUT); a.c_out[1] = fm(C1_OUT);
  a.w_out = fm(W_OUT); a.cum_out = fm(CUM_OUT); a.ctx_out = fm(CTX_OUT); a.prev_out = fm(PREV_OUT);
  // Scratch: h0 (2, B, H), h1 (2, B, H), ctx (B, D), a2 (B, P2), then the
  // query sums (2, B, A) as 64-bit integers (8-byte aligned by the wrapper).
  float* s = fm(SCRATCH);
  a.h_buf[0] = s; s += (size_t)2 * a.B * a.H;
  a.h_buf[1] = s; s += (size_t)2 * a.B * a.H;
  a.ctx_buf = s;  s += (size_t)a.B * a.D;
  a.a2 = s;       s += (size_t)a.B * a.P2;
  a.qacc = reinterpret_cast<unsigned long long*>(s);
  a.bar = static_cast<unsigned int*>(const_cast<void*>(p[BAR]));

  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (a.K < 1 || a.B < 1 || a.B > kMaxB || a.S < 1 || a.A < 1 || a.A % 4 || a.H % 16 ||
      a.D % 16 || a.P2 % 16 || a.P1 % 4 || a.mel % 4 || a.r < 1 || a.conv_c % 4 ||
      a.P1 > 2 * kThreads || a.P2 > 8 * kThreads || nsm <= kPre)
    return (int)cudaErrorInvalidValue;
  // The staging's 16-byte loads: state rows and scratch must be aligned.
  for (int i : {H0_IN, H1_IN, CTX_IN, H0_OUT, H1_OUT, CTX_OUT, SCRATCH, KEYS, W0, W1})
    if (reinterpret_cast<uintptr_t>(p[i]) % 16) return (int)cudaErrorMisalignedAddress;
  if (reinterpret_cast<uintptr_t>(a.qacc) % 8) return (int)cudaErrorMisalignedAddress;
  a.L = make_layout(a, nsm, max_smem);
  if (a.B > a.L.nblk || a.L.total > (size_t)max_smem || a.L.grid > nsm ||
      (a.L.mt > kMaxMt && !quantized))
    return (int)cudaErrorInvalidValue;
  // The production widths (two m-tiles) keep their own build of the kernel,
  // up to four m-tiles a second, past them (int8) the multi-pass third.
  const bool wide = a.L.mt > 2, passes = a.L.mt > kMaxMt;
  const void* kernel = quantized ? (passes ? (const void*)decode_kernel<true, 4, true>
                                    : wide ? (const void*)decode_kernel<true, 4, false>
                                           : (const void*)decode_kernel<true, 2, false>)
                                 : (wide ? (const void*)decode_kernel<false, 4, false>
                                         : (const void*)decode_kernel<false, 2, false>);
  MSTTS_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)a.L.total));
  void* params[] = {&a};
  MSTTS_CHECK(cudaLaunchCooperativeKernel(kernel, dim3(a.L.grid), dim3(kThreads), params,
                                          a.L.total, static_cast<cudaStream_t>(stream)));
  MSTTS_RETURN_LAUNCH_ERROR();
}
