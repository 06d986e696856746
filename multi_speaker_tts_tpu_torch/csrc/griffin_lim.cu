// Staged (8-leaf) Griffin-Lim at n_fft = 1024: one persistent launch a call.
//
// Replaces multi_speaker_tts_tpu/ops/griffin_lim_staged.py::griffin_lim_staged
// (kernel body _gl_staged_kernel; momentum branch body_m). Same fixed-point
// map: zero-phase start, per-class 128 x 128 leaf products joined to the
// frame by an exact 8-point butterfly, classes 0-4 kept (640 lanes,
// Hermitian pruning), bf16 leaf operands with f32 sums, bf16 target
// magnitudes, window-square OLA normalisation over the uncropped rows,
// mag * rsqrt(|X|^2 + 1e-12) projection, centred crop. Momentum mode (pre /
// pim non-null): each fresh spectrum X is extrapolated against the previous
// one P before the projection, X - beta P with beta = m / (1 + m), and X is
// stored as the next P in two bf16 (B, T, 640) buffers, as the TPU kernel
// keeps its previous projections in the magnitudes' dtype.
//
// What bounds it on an H100: by bytes and operations, the tensor-core
// operations (B = 4, T = 128, 60 iterations: 32.5 GFLOP, 33 us at 989
// TFLOP/s; inputs and outputs under 1 MB). The iteration is a chain of
// dependent all-to-all steps over the utterance (every frame's spectrum
// needs its overlapping neighbours' synthesis), so the floor of this design
// is its grid barriers: 2 n_iter + 1 rounds (0.17 ms at 60 iterations on
// 128 blocks of an H100, where a call at B = 4, T = 128 takes 0.56 ms).
//
// Design: one cooperative launch runs every iteration. A frame tile is 16
// frames of one utterance (the M of mma.sync m16n8k16). The grid is 4
// blocks per tile slot, at most one block an SM (132 blocks on an H100:
// 128 at B = 4, T = 128); a block walks tiles slot, slot + slots, ...
// Block b always serves class group cg = b % 4: {0, 4} (the two real
// classes, whose products are half as deep) or one complex class 1, 2, 3,
// so the four groups do equal work. An iteration is two phases, each ended
// by the grid barrier (common.cuh):
//
//   spectra (tile, cg): z operands of the tile's 16 frames (bf16, from the
//     reframe phase) -> forward leaf products -> momentum -> projection ->
//     bf16 projected spectra in shared memory -> inverse leaf products ->
//     u planes (f32) of the group's classes. Forward and inverse of a class
//     need only that class's spectra, so they share one block and the
//     projected spectra never leave shared memory.
//   reframe (tile, m slice): for 32 of the 128 leaf positions m, the
//     inverse butterfly and synthesis window of the tile's frames and their
//     K - 1 neighbours on each side (the OLA halo, recomputed by every
//     owner: no barrier inside the phase), the overlap-add of the K frames
//     under each signal row, the normaliser, the analysis window and the
//     forward butterfly -> the tile's z operands (bf16) at those m. Every
//     step of that chain is elementwise in m.
//
// A prologue runs the spectra phase's inverse half on the zero-phase start
// (spectra = magnitudes); after the last iteration an output phase runs the
// reframe phase's overlap-add on the crop's rows.
//
// The leaf matrices stay in shared memory for the whole launch: a block
// holds its group's forward leaves M_c = [Mr | Mi] (bf16, 64 KB a class,
// 128 KB for {0, 4}), loaded once by cp.async. The inverse leaf of class c
// is (two / 128) conj(M_c)^T with two = 2 for the mirrored classes 1-3:
// the same bf16 values transposed, times a power of two. So the forward
// reads M_c by ldmatrix.trans and the inverse by ldmatrix, and the inverse
// sums are scaled by two / 128 (exact). A complex product runs as four real
// ones, the minus signs applied to the A fragments (a sign-bit flip).
//
// Through device memory (L2-resident) go only the f32 u planes (4 KB a
// frame) and the bf16 z operands (2 KB a frame), each written once and
// read by the other phase's blocks after a barrier (ld.cg / cp.async.cg),
// and, in momentum mode, the bf16 P, read and written by the same thread.
//
// hop is a template parameter through K = 1024 / hop in {2, 4, 8} (hop
// 512, 256, 128); the wrapper refuses any other hop before launch.
#include <algorithm>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kN = 1024;      // n_fft
constexpr int kL = 128;       // leaf length
constexpr int kG = 640;       // stored lanes: 5 classes x 128
constexpr int kF = 16;        // frames a tile: one MMA row tile
constexpr int kThreads = 256; // 8 warps; warp w owns leaf positions [16w, 16w + 16)
constexpr int kSlice = 32;    // leaf positions m a reframe unit
constexpr int kLdM = kL + 8;  // leaf matrix row (bf16), 272 bytes: ldmatrix conflict-free
constexpr int kLdT = 2 * kL + 8;  // operand tile row (bf16): [re | im] or [z0 | z4]
constexpr float kR2 = 0.70710678118654752f;
constexpr size_t kSmemMats = sizeof(bf16) * 4 * kL * kLdM;
constexpr size_t kSmemTiles = sizeof(bf16) * 3 * kF * kLdT;  // Z, Y[0], Y[1]

__host__ __device__ constexpr size_t frames_smem(int K) {
  return sizeof(float) * (kF + 2 * (K - 1)) * 8 * kSlice;
}

__host__ __device__ constexpr size_t gl_smem(int K) {
  return kSmemMats + (kSmemTiles > frames_smem(K) ? kSmemTiles : frames_smem(K));
}

struct GlArgs {
  const bf16* mag;    // (B, T, 640) target magnitudes, staged lane order
  const bf16* mats;   // (5, 2, 128, 128): class c, [Mr, Mi], [m][t] of M_c
  const float* win;   // (8, 128) analysis window blocks
  const float* syn;   // (8, 128) synthesis window blocks (1/8 folded in)
  const float* wsum;  // (T + K - 1, hop) inverse window-square OLA sum
  float* u;           // (B T, 8, 128) u planes: u0, u1r, u1i, u2r, u2i, u3r, u3i, u4
  bf16* z;            // (B T, 8, 128) z operands: z0, z4, z1r, z1i, z2r, z2i, z3r, z3i
  bf16* pre;          // (B, T, 640) previous X re / im (momentum), or null
  bf16* pim;
  float* out;         // (B, (T - 1) hop)
  unsigned int* bar;  // grid barrier counter, zeroed by the wrapper
  int B, T, n_iter;
  float beta;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void neg4(uint32_t* d, const uint32_t* s) {
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] = s[i] ^ 0x80008000u;
}

// A fragment (16 frames x 16 k) of an operand tile at column c0.
__device__ __forceinline__ void load_a(uint32_t* r, const bf16* tile, int c0, int lane) {
  mstts_ldmatrix_x4(r, tile + (lane & 15) * kLdT + c0 + (lane >> 4) * 8);
}

// Forward B fragments: M[k0 .. k0 + 15][n0 .. n0 + 15] (two n-tiles).
__device__ __forceinline__ void load_b_fwd(uint32_t* r, const bf16* M, int k0, int n0, int lane) {
  mstts_ldmatrix_x4_trans(r, M + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdM + n0 +
                                 (lane >> 4) * 8);
}

// Inverse B fragments: B[k = t][n = m] = M[m][t], t in k0 .. k0 + 15, m in
// n0 .. n0 + 15 (two n-tiles).
__device__ __forceinline__ void load_b_inv(uint32_t* r, const bf16* M, int k0, int n0, int lane) {
  mstts_ldmatrix_x4(r, M + (n0 + (lane & 7) + (lane >> 4) * 8) * kLdM + k0 +
                           ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ void mma2(float (*acc)[4], const uint32_t* a, const uint32_t* b) {
  mstts_mma_bf16(acc[0], a[0], a[1], a[2], a[3], b[0], b[1]);
  mstts_mma_bf16(acc[1], a[0], a[1], a[2], a[3], b[2], b[3]);
}

template <int K, bool kMom>
struct Staged {
  static constexpr int kHop = kN / K;
  static constexpr int kPerRow = kHop / kL;  // 128-blocks a signal row
  static constexpr int kHalo = K - 1;
  static constexpr int kNF = kF + 2 * kHalo;  // frames a reframe unit synthesises

  GlArgs a;
  unsigned char* smem;
  int cg, lane, warp, tpb;

  __device__ Staged(const GlArgs& args, unsigned char* s) : a(args), smem(s) {
    cg = blockIdx.x % 4;
    lane = threadIdx.x % 32;
    warp = threadIdx.x / 32;
    tpb = (a.T + kF - 1) / kF;
  }

  __device__ bf16* mat(int i) const { return reinterpret_cast<bf16*>(smem) + i * kL * kLdM; }
  __device__ bf16* tile(int i) const {
    return reinterpret_cast<bf16*>(smem + kSmemMats) + i * kF * kLdT;
  }
  __device__ float* frames() const { return reinterpret_cast<float*>(smem + kSmemMats); }

  // The group's leaf matrices: {0, 4}: Mr0, Mi0, Mr4, Mi4; class c: Mr, Mi.
  __device__ void load_mats() {
    const int nm = cg == 0 ? 4 : 2;
    for (int i = threadIdx.x; i < nm * kL * (kL / 8); i += kThreads) {
      const int q = i / (kL * kL / 8), r = (i / (kL / 8)) % kL, c = i % (kL / 8);
      const int cls = cg == 0 ? (q < 2 ? 0 : 4) : cg;
      const bf16* src = a.mats + ((size_t)(cls * 2 + q % 2) * kL + r) * kL + 8 * c;
      mstts_cp_async16(mat(q) + r * kLdM + 8 * c, src);
    }
    mstts_cp_async_wait_all();
    __syncthreads();
  }

  // -- spectra phase: z -> X -> projection -> Y -> u ------------------------
  __device__ void spectra(int tl, bool first) {
    const int bi = tl / tpb, t0 = (tl % tpb) * kF, nv = min(kF, a.T - t0);
    const size_t fr0 = (size_t)bi * a.T + t0;  // first frame of the tile
    const int g8 = lane >> 2, tq = lane & 3, n0 = 16 * warp;
    bf16* Z = tile(0);
    bf16* Y0 = tile(1);
    bf16* Y1 = tile(2);
    __syncthreads();  // the previous tile's readers of Z, Y are done
    if (first) {
      // Zero-phase start: Y = (mag, 0) of each class of the group.
      for (int i = threadIdx.x; i < 2 * kF * 2 * kL; i += kThreads) {
        const int ci = i / (kF * 2 * kL), f = (i / (2 * kL)) % kF, c = i % (2 * kL);
        const int cls = cg == 0 ? 4 * ci : cg;
        bf16 v = __float2bfloat16(0.0f);
        if (c < kL && f < nv) v = a.mag[(fr0 + f) * kG + cls * kL + c];
        if (cg == 0 || ci == 0) (ci == 0 ? Y0 : Y1)[f * kLdT + c] = v;
      }
    } else {
      // Target magnitudes and, in momentum mode, the previous X of this
      // thread's projection elements, loaded ahead of the products.
      uint32_t mg[2][2][2] = {}, pp[2][2][2][2] = {};
#pragma unroll
      for (int ci = 0; ci < 2; ++ci)
#pragma unroll
        for (int lt = 0; lt < 2; ++lt)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int f = g8 + 8 * half;
            if ((ci == 1 && cg != 0) || f >= nv) continue;
            const size_t o = (fr0 + f) * kG + (cg == 0 ? 4 * ci : cg) * kL + n0 + 8 * lt + 2 * tq;
            mg[ci][lt][half] = __ldg(reinterpret_cast<const uint32_t*>(a.mag + o));
            if constexpr (kMom) {
              pp[ci][lt][half][0] = *reinterpret_cast<const uint32_t*>(a.pre + o);
              pp[ci][lt][half][1] = *reinterpret_cast<const uint32_t*>(a.pim + o);
            }
          }
      for (int i = threadIdx.x; i < kF * 32; i += kThreads) {
        const int f = i / 32, c = i % 32;
        bf16* dst = Z + f * kLdT + 8 * c;
        if (f < nv)
          mstts_cp_async16(dst, a.z + (fr0 + f) * 8 * kL + cg * 2 * kL + 8 * c);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
      }
      mstts_cp_async_wait_all();
      __syncthreads();

      // Forward leaf products: X[plane][lane tile][4], this warp's 16 lanes.
      //   {0, 4}: planes X0re, X0im, X4re, X4im = z0 Mr0, z0 Mi0, z4 Mr4, z4 Mi4;
      //   class c: Xre = zr Mr - zi Mi, Xim = zr Mi + zi Mr.
      float x[4][2][4] = {};
#pragma unroll
      for (int kb = 0; kb < kL / 16; ++kb) {
        uint32_t a0[4], a1[4], b0[4], b1[4];
        load_a(a0, Z, 16 * kb, lane);
        load_a(a1, Z, kL + 16 * kb, lane);
        load_b_fwd(b0, mat(0), 16 * kb, n0, lane);
        load_b_fwd(b1, mat(1), 16 * kb, n0, lane);
        if (cg == 0) {
          uint32_t b2[4], b3[4];
          load_b_fwd(b2, mat(2), 16 * kb, n0, lane);
          load_b_fwd(b3, mat(3), 16 * kb, n0, lane);
          mma2(x[0], a0, b0);
          mma2(x[1], a0, b1);
          mma2(x[2], a1, b2);
          mma2(x[3], a1, b3);
        } else {
          uint32_t a1n[4];
          neg4(a1n, a1);
          mma2(x[0], a0, b0);
          mma2(x[0], a1n, b1);
          mma2(x[1], a0, b1);
          mma2(x[1], a1, b0);
        }
      }

      // Momentum and projection, in registers; Y (bf16) into shared memory.
#pragma unroll
      for (int ci = 0; ci < 2; ++ci) {
        if (ci == 1 && cg != 0) break;
        const int cls = cg == 0 ? 4 * ci : cg;
        bf16* Yt = ci == 0 ? Y0 : Y1;
#pragma unroll
        for (int lt = 0; lt < 2; ++lt) {
          const int ln = n0 + 8 * lt + 2 * tq;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int f = g8 + 8 * half;
            float re[2] = {x[2 * ci][lt][2 * half], x[2 * ci][lt][2 * half + 1]};
            float im[2] = {x[2 * ci + 1][lt][2 * half], x[2 * ci + 1][lt][2 * half + 1]};
            uint32_t yr = 0u, yi = 0u;
            if (f < nv) {
              const size_t o = (fr0 + f) * kG + cls * kL + ln;
              if constexpr (kMom) {
                const float2 p = unpack_bf16(pp[ci][lt][half][0]);
                const float2 q = unpack_bf16(pp[ci][lt][half][1]);
                *reinterpret_cast<uint32_t*>(a.pre + o) = pack_bf16(re[0], re[1]);
                *reinterpret_cast<uint32_t*>(a.pim + o) = pack_bf16(im[0], im[1]);
                re[0] -= a.beta * p.x;
                re[1] -= a.beta * p.y;
                im[0] -= a.beta * q.x;
                im[1] -= a.beta * q.y;
              }
              const float2 m = unpack_bf16(mg[ci][lt][half]);
              const float s0 = m.x * rsqrtf(re[0] * re[0] + im[0] * im[0] + 1e-12f);
              const float s1 = m.y * rsqrtf(re[1] * re[1] + im[1] * im[1] + 1e-12f);
              yr = pack_bf16(re[0] * s0, re[1] * s1);
              yi = pack_bf16(im[0] * s0, im[1] * s1);
            }
            *reinterpret_cast<uint32_t*>(Yt + f * kLdT + ln) = yr;
            *reinterpret_cast<uint32_t*>(Yt + f * kLdT + kL + ln) = yi;
          }
        }
      }
    }
    __syncthreads();

    // Inverse leaf products, this warp's 16 positions m:
    //   {0, 4}: u0 = (Y0r Mr0^T + Y0i Mi0^T) / 128, u4 likewise;
    //   class c: ur = (Yr Mr^T + Yi Mi^T) / 64, ui = (Yi Mr^T - Yr Mi^T) / 64.
    float u[2][2][4] = {};
#pragma unroll
    for (int kb = 0; kb < kL / 16; ++kb) {
      uint32_t ar[4], ai[4], b0[4], b1[4];
      load_a(ar, Y0, 16 * kb, lane);
      load_a(ai, Y0, kL + 16 * kb, lane);
      load_b_inv(b0, mat(0), 16 * kb, n0, lane);
      load_b_inv(b1, mat(1), 16 * kb, n0, lane);
      mma2(u[0], ar, b0);
      mma2(u[0], ai, b1);
      if (cg == 0) {
        uint32_t cr[4], ci[4], b2[4], b3[4];
        load_a(cr, Y1, 16 * kb, lane);
        load_a(ci, Y1, kL + 16 * kb, lane);
        load_b_inv(b2, mat(2), 16 * kb, n0, lane);
        load_b_inv(b3, mat(3), 16 * kb, n0, lane);
        mma2(u[1], cr, b2);
        mma2(u[1], ci, b3);
      } else {
        uint32_t arn[4];
        neg4(arn, ar);
        mma2(u[1], ai, b0);
        mma2(u[1], arn, b1);
      }
    }
    const float scale = cg == 0 ? 1.0f / kL : 2.0f / kL;
    const int plane0 = cg == 0 ? 0 : 2 * cg - 1, plane1 = cg == 0 ? 7 : 2 * cg;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int plane = p == 0 ? plane0 : plane1;
#pragma unroll
      for (int lt = 0; lt < 2; ++lt) {
        const int ln = n0 + 8 * lt + 2 * tq;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int f = g8 + 8 * half;
          if (f < nv)
            *reinterpret_cast<float2*>(a.u + ((fr0 + f) * 8 + plane) * kL + ln) =
                make_float2(u[p][lt][2 * half] * scale, u[p][lt][2 * half + 1] * scale);
        }
      }
    }
  }

  // -- reframe and output phases --------------------------------------------
  // Synthesised frames t0 - kHalo .. t0 + 15 + kHalo at the slice's 32
  // positions m: xs[i][j][mm] = block j of frame t0 - kHalo + i (zero
  // outside the utterance).
  __device__ void synthesise(int bi, int t0, int m0) {
    // All of a thread's u loads (written by other blocks: through L2) are
    // issued before any is used, so their latencies overlap.
    constexpr int kItems = (kNF * kSlice + kThreads - 1) / kThreads;
    float uv[kItems][8];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + threadIdx.x;
      const int fi = i / kSlice, tf = t0 - kHalo + fi;
      const bool live = fi < kNF && tf >= 0 && tf < a.T;
      const float* p = a.u + ((size_t)bi * a.T + (live ? tf : 0)) * 8 * kL + m0 + i % kSlice;
#pragma unroll
      for (int pl = 0; pl < 8; ++pl) uv[k][pl] = live ? __ldcg(p + pl * kL) : 0.0f;
    }
    float* xs = frames();
    __syncthreads();  // the previous tile's readers of xs are done
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int i = k * kThreads + threadIdx.x;
      if (i >= kNF * kSlice) break;
      const int fi = i / kSlice, mm = i % kSlice, m = m0 + mm;
      const float u0 = uv[k][0], Ur1 = uv[k][1], Ui1 = uv[k][2], Ur2 = uv[k][3];
      const float Ui2 = uv[k][4], Ur3 = uv[k][5], Ui3 = uv[k][6], u4 = uv[k][7];
      const float P = u0 + u4, Q = u0 - u4;
      const float E0 = P + Ur2, E1 = Q - Ui2, E2 = P - Ur2, E3 = Q + Ui2;
      const float g1 = (Ur1 - Ui1) * kR2, h1 = (Ur1 + Ui1) * kR2;
      const float g3 = (Ur3 - Ui3) * kR2, h3 = (Ur3 + Ui3) * kR2;
      const float O0 = Ur1 + Ur3, O1 = g1 - h3, O2 = Ui3 - Ui1, O3 = g3 - h1;
      const float e[4] = {E0, E1, E2, E3}, o[4] = {O0, O1, O2, O3};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        xs[(fi * 8 + j) * kSlice + mm] = (e[j] + o[j]) * __ldg(a.syn + j * kL + m);
        xs[(fi * 8 + j + 4) * kSlice + mm] = (e[j] - o[j]) * __ldg(a.syn + (j + 4) * kL + m);
      }
    }
    __syncthreads();
  }

  // Signal row `row`, column block jj, position m = m0 + mm: the
  // overlap-add of the K frames under it (in the plain version's order),
  // times the normaliser.
  __device__ float row_sample(int t0, int row, int jj, int m0, int mm) const {
    const float* xs = frames();
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < K; ++q) {
      const int fi = row - q - (t0 - kHalo);
      s += xs[(fi * 8 + q * kPerRow + jj) * kSlice + mm];
    }
    return s * __ldg(a.wsum + (size_t)row * kHop + jj * kL + m0 + mm);
  }

  __device__ void reframe(int tl) {
    const int bi = tl / tpb, t0 = (tl % tpb) * kF, m0 = cg * kSlice;
    synthesise(bi, t0, m0);
    for (int i = threadIdx.x; i < kF * kSlice; i += kThreads) {
      const int f = i / kSlice, mm = i % kSlice, t = t0 + f, m = m0 + mm;
      if (t >= a.T) continue;
      float b[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = row_sample(t0, t + j / kPerRow, j % kPerRow, m0, mm) * __ldg(a.win + j * kL + m);
      float s[4], d[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[j] = b[j] + b[j + 4];
        d[j] = b[j] - b[j + 4];
      }
      const float u0 = s[0] + s[2], u1 = s[1] + s[3];
      const float v0 = s[0] - s[2], v1 = s[1] - s[3];
      const float p = (d[1] - d[3]) * kR2, q = (d[1] + d[3]) * kR2;
      const float zv[8] = {u0 + u1, u0 - u1, d[0] + p, -q - d[2], v0, -v1, d[0] - p, -q + d[2]};
      bf16* dst = a.z + ((size_t)bi * a.T + t) * 8 * kL + m;
#pragma unroll
      for (int pl = 0; pl < 8; ++pl) dst[pl * kL] = __float2bfloat16(zv[pl]);
    }
  }

  // The centred crop: output frame t is signal row K / 2 + t.
  __device__ void output(int tl) {
    const int bi = tl / tpb, t0 = (tl % tpb) * kF, m0 = cg * kSlice;
    synthesise(bi, t0, m0);
    for (int i = threadIdx.x; i < kF * kSlice; i += kThreads) {
      const int f = i / kSlice, mm = i % kSlice, t = t0 + f;
      if (t >= a.T - 1) continue;
      float* dst = a.out + ((size_t)bi * (a.T - 1) + t) * kHop + m0 + mm;
#pragma unroll
      for (int jj = 0; jj < kPerRow; ++jj) dst[jj * kL] = row_sample(t0, K / 2 + t, jj, m0, mm);
    }
  }
};

template <int K, bool kMom>
__global__ void __launch_bounds__(kThreads, 1) gl_staged_kernel(GlArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  Staged<K, kMom> st(a, smem);
  const int slot = blockIdx.x / 4, slots = gridDim.x / 4;
  const int ntiles = a.B * st.tpb;
  st.load_mats();
  unsigned int epoch = 0;
  for (int tl = slot; tl < ntiles; tl += slots) st.spectra(tl, true);
  mstts_grid_barrier(a.bar, epoch);
  for (int it = 0; it < a.n_iter; ++it) {
    for (int tl = slot; tl < ntiles; tl += slots) st.reframe(tl);
    mstts_grid_barrier(a.bar, epoch);
    for (int tl = slot; tl < ntiles; tl += slots) st.spectra(tl, false);
    mstts_grid_barrier(a.bar, epoch);
  }
  for (int tl = slot; tl < ntiles; tl += slots) st.output(tl);
}

template <int K, bool kMom>
cudaError_t grid_of(int B, int T, int* blocks) {
  int dev = 0, nsm = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gl_staged_kernel<K, kMom>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)gl_smem(K));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gl_staged_kernel<K, kMom>,
                                                        kThreads, gl_smem(K));
  if (err != cudaSuccess) return err;
  const int ntiles = B * ((T + kF - 1) / kF);
  const int slots = std::min(ntiles, std::min(per_sm, 1) * nsm / 4);
  if (slots < 1) return cudaErrorInvalidConfiguration;
  *blocks = 4 * slots;
  return cudaSuccess;
}

template <int K, bool kMom>
int launch(const GlArgs& a, cudaStream_t stream) {
  int blocks = 0;
  MSTTS_CHECK((grid_of<K, kMom>(a.B, a.T, &blocks)));
  GlArgs c = a;
  void* params[] = {&c};
  MSTTS_CHECK(cudaLaunchCooperativeKernel((const void*)gl_staged_kernel<K, kMom>, dim3(blocks),
                                          dim3(kThreads), params, gl_smem(K), stream));
  MSTTS_RETURN_LAUNCH_ERROR();
}

bool valid(int B, int T, int hop) {
  return B >= 1 && T >= 2 && (hop == 128 || hop == 256 || hop == 512);
}

}  // namespace

// The launch's block count for these shapes (the same in both modes).
MSTTS_EXPORT int mstts_gl_staged_blocks(int B, int T, int hop, void* blocks_out) {
  if (!valid(B, T, hop)) return (int)cudaErrorInvalidValue;
  int* out = static_cast<int*>(blocks_out);
  switch (hop) {
    case 128: return (int)grid_of<8, false>(B, T, out);
    case 256: return (int)grid_of<4, false>(B, T, out);
    default: return (int)grid_of<2, false>(B, T, out);
  }
}

// mats: (5, 2, 128, 128) bf16 forward leaves [Mr, Mi]; u, z: the (B T, 8,
// 128) f32 and bf16 scratch; pre / pim: null for the plain iteration, else
// the two zeroed bf16 (B, T, 640) previous-projection buffers; bar: a zeroed
// counter.
MSTTS_EXPORT int mstts_gl_staged(const void* mag, const void* mats, const void* win,
                                 const void* syn, const void* wsum, void* u, void* z,
                                 void* out, void* pre, void* pim, void* bar, int B, int T,
                                 int hop, int n_iter, float beta, void* stream) {
  if (!valid(B, T, hop) || n_iter < 0 || (pre == nullptr) != (pim == nullptr))
    return (int)cudaErrorInvalidValue;
  GlArgs a;
  a.mag = static_cast<const bf16*>(mag);
  a.mats = static_cast<const bf16*>(mats);
  a.win = static_cast<const float*>(win);
  a.syn = static_cast<const float*>(syn);
  a.wsum = static_cast<const float*>(wsum);
  a.u = static_cast<float*>(u);
  a.z = static_cast<bf16*>(z);
  a.pre = static_cast<bf16*>(pre);
  a.pim = static_cast<bf16*>(pim);
  a.out = static_cast<float*>(out);
  a.bar = static_cast<unsigned int*>(bar);
  a.B = B;
  a.T = T;
  a.n_iter = n_iter;
  a.beta = beta;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool mom = pre != nullptr;
  switch (hop) {
    case 128: return mom ? launch<8, true>(a, st) : launch<8, false>(a, st);
    case 256: return mom ? launch<4, true>(a, st) : launch<4, false>(a, st);
    default: return mom ? launch<2, true>(a, st) : launch<2, false>(a, st);
  }
}
