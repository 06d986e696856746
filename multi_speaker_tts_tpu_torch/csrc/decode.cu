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
// even, per-column weight scale, exact s32 accumulation by __dp4a) and bf16
// (operands rounded to bf16, f32 accumulation). Everything else is f32.
//
// What bounds it on an H100, and the design: with a batch of 4 the step is
// a chain of six small dependent phases, so it is bound by latency (one L2
// round trip and one grid-wide exchange per phase), then by the weight
// bytes a step touches (19.9 MB int8, 39.8 MB bf16 at production width),
// never by operations. The TPU kernel's tiling (VMEM-resident layer 0,
// layer 1 streamed in 128-column tiles, lane and row padding) is not
// carried over. Here one cooperative launch of about one block per SM runs
// all K steps with no host work between them:
//   - block j owns U hidden units of BOTH layers and their 4U gate columns
//     (the scheme of lstm_persistent.cuh), so each cell update is local and
//     c0 / c1 stay in its shared memory for the whole segment;
//   - int8 mode keeps the block's weight rows of both layers (about 152 KB
//     per SM at production width) in shared memory for the whole segment:
//     the weights are read from device memory ONCE per launch;
//   - bf16 mode (304 KB per SM, which no SM holds) keeps layer 0's rows
//     (128 KB) in shared memory too, where they fit, and re-reads layer
//     1's rows (23 MB in all) every step through L2;
//   - every block stages the whole activation row [x, ctx, h] of each batch
//     row itself: all of a thread's 16-byte loads from L2 are requested
//     before the first is used (one L2 round trip, not one per element),
//     and the row is quantized (or rounded to bf16) from registers;
//   - a warp computes two gate columns at a time for all batch rows, so
//     each staged activation read from shared memory serves both; lanes
//     walk K in 16-byte pieces (in bf16 mode a lane requests four pieces of
//     both weight rows before it uses the first);
//   - the two prenet layers are spread over the grid one output per warp;
//     the projection one output per block, its H + D products dealt over
//     all threads;
//   - attention for batch row b runs in block b (w and cum, the mask and
//     the location conv and projection weights stay in its shared memory),
//     the other blocks wait. Its query q = h0 . wq is not an H-deep product
//     in one block: each block adds its own units' share right after cell 0
//     (its rows of wq sit in shared memory) into a per-block partial, and
//     block b sums the partials of row b in block order. A warp scores four
//     memory positions at a time, four attention units per lane;
//   - phases are separated by six grid barriers per step (prenet 1, prenet
//     2, gates 0, attention, gates 1, projection); h0 / h1 ping-pong
//     between two global buffers, read with ld.cg (never through L1).
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // batch rows per pass over a weight row
// 16-byte pieces of activations a thread stages per group of kRows batch
// rows: kRows rows of up to kMaxK values.
constexpr int kStageVec = 8;
constexpr int kMaxK = kStageVec * kThreads * 4 / kRows;
constexpr int kCols = 2;  // gate columns a warp sums at a time
// 16-byte pieces of each bf16 weight row a lane requests from L2 at a time.
constexpr int kRowVec = 4;
constexpr int kQVec = 8;  // 16-byte loads of q partials a thread keeps in flight
constexpr int kPos = 4;   // memory positions a warp scores at a time

// Order of the pointer and dimension tables (ops/decode_kernel.py builds them).
enum Ptr {
  W0, W1, S0, B0, S1, B1, WPROJ, BPROJ, WP1, BP1, WP2, BP2, WQ, CK, WLOC, V,
  KEYS, MEMORY, MASK, M1, M2,
  H0_IN, C0_IN, H1_IN, C1_IN, W_IN, CUM_IN, CTX_IN, PREV_IN,
  YS, ALIGNS, H0_OUT, C0_OUT, H1_OUT, C1_OUT, W_OUT, CUM_OUT, CTX_OUT, PREV_OUT,
  SCRATCH, BAR, N_PTR
};
enum Dim { DK, DB, DS, DA, DD, DH, DP1, DP2, DMEL, DR, DCONVK, DCONVC, DQUANT, N_DIM };

struct DecArgs {
  int K, B, S, A, D, H, P1, P2, mel, r, conv_k, conv_c;
  int U, nblk, K0, K1, NO;
  int w0_resident;  // bf16 mode: layer 0's weight rows stay in shared memory too
  const void* w[2];      // (4H, K0), (4H, K1): int8 or bf16 rows per gate column
  const float* scale[2]; // (4H) per-column weight scales (int8 mode)
  const float* bias[2];  // (4H)
  const float *wproj, *bproj;  // (NO, H + D), (NO): frames then the stop logit
  const float *wp1, *bp1, *wp2, *bp2;  // (P1, mel), (P2, P1) rows per output
  const float *wq, *ck, *wloc, *v;     // (H, A), (conv_k, 2, C), (C, A), (A)
  const float *keys, *memory, *mask;   // (B, S, A), (B, S, D), (B, S)
  const float *m1, *m2;                // (K, B, P1), (K, B, P2) or null
  const float *h_in[2], *c_in[2], *w_in, *cum_in, *ctx_in, *prev_in;
  float *ys, *aligns;                  // (K, B, NO), (K, B, S)
  float *h_out[2], *c_out[2], *w_out, *cum_out, *ctx_out, *prev_out;
  float *h_buf[2];                     // (2, B, H) ping-pong per layer
  float *ctx_buf, *a1, *a2;            // (B, D), (B, P1), (B, P2)
  float *qpart;                        // (nblk, B, A) per-block shares of q
  unsigned int* bar;
};

struct Smem {
  size_t w, xs, f32, total;  // byte offsets of the regions, and the size
};

// Floats of the launch-long and per-phase f32 arrays, in the order the
// kernel lays them out: those read 16 bytes at a time first.
__host__ __device__ inline size_t smem_floats(const DecArgs& a) {
  const int pad = a.S + a.conv_k - 1;
  const int red_rows = a.B > kRows ? a.B : kRows;
  return (size_t)4 * kThreads                       // partial sums of q / of the context
      + (size_t)a.conv_c * a.A                      // location projection
      + (size_t)2 * a.A                             // v, q
      + (size_t)kWarps * a.conv_c * kPos            // location features per warp
      + (size_t)a.conv_k * 2 * a.conv_c             // location conv kernel, (w, cum) pairs
      + (size_t)2 * pad                             // (w, cum) pairs, padded
      + (size_t)2 * a.S                             // energies, memory mask
      + (size_t)a.U * a.A + (size_t)a.B * a.U       // own rows of wq, own new h0
      + (size_t)a.B                                 // amax
      + (size_t)red_rows * kWarps                   // per-warp partials of a block reduction
      + (size_t)4 * 4 * a.U                         // own columns' bias and scale, both layers
      + (size_t)a.B * 4 * a.U                       // gates
      + (size_t)2 * a.B * a.U;                      // c0, c1
}

__host__ __device__ inline Smem smem_layout(const DecArgs& a, bool quantized) {
  Smem m;
  const int Kmax = a.K0 > a.K1 ? a.K0 : a.K1;
  m.w = 0;
  m.xs = quantized ? (size_t)4 * a.U * (a.K0 + a.K1)
                   : (a.w0_resident ? (size_t)4 * a.U * a.K0 * 2 : 0);
  m.f32 = m.xs + (size_t)a.B * Kmax * (quantized ? 1 : 2);
  m.f32 = (m.f32 + 15) / 16 * 16;
  m.total = m.f32 + sizeof(float) * smem_floats(a);
  return m;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// acc[j] += sum_i x[j * xstride + i] * w[i] over this lane's share of i < n
// (n a multiple of 4, w 16-byte aligned), for j < rows. w is constant for the
// launch; x was written by other blocks. ``x_vec``: every x row is 16-byte
// aligned too.
__device__ __forceinline__ void lane_dot(const float* __restrict__ w, const float* x,
                                         int xstride, int n, int rows, bool x_vec,
                                         float (&acc)[kRows]) {
  for (int i = 4 * (threadIdx.x % 32); i < n; i += 128) {
    const float4 wv = __ldg(reinterpret_cast<const float4*>(w + i));
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      if (j < rows) {
        const float* xp = x + (size_t)j * xstride + i;
        float4 xv;
        if (x_vec) {
          xv = __ldcg(reinterpret_cast<const float4*>(xp));
        } else {
          xv = make_float4(__ldcg(xp), __ldcg(xp + 1), __ldcg(xp + 2), __ldcg(xp + 3));
        }
        acc[j] = fmaf(xv.x, wv.x, acc[j]);
        acc[j] = fmaf(xv.y, wv.y, acc[j]);
        acc[j] = fmaf(xv.z, wv.z, acc[j]);
        acc[j] = fmaf(xv.w, wv.w, acc[j]);
      }
    }
  }
}

// One LSTM layer's step for the units this block owns: stage [x0, ctx, h]
// (quantized per row or rounded to bf16), gate columns by warp, cell.
// Layer 0 (``qpart`` given) also adds its units' share of the attention
// query, h_new[:, own] . wq[own, :], into this block's partial.
template <bool Q>
__device__ void gate_phase(const DecArgs& a, int layer, int Kdim, const float* x0, int n0,
                           const float* ctx, const float* h_prev, float* h_next,
                           const int8_t* w_s, unsigned char* xs, float* amax_s, float* red_s,
                           const float* bias_s, const float* scale_s, float* g_s, float* c_s,
                           int u0, int Uown, float* hown_s, const float* wq_s, float* qpart) {
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n1 = n0 + a.D;
  const int kd4 = Kdim / 4;
  // Values i .. i+3 of batch row b's [x0, ctx, h]: the three widths are
  // multiples of 4 and the rows 16-byte aligned, so a piece never straddles.
  auto load4 = [&](int b, int i) -> float4 {
    const float* src = i < n0   ? x0 + (size_t)b * n0 + i
                       : i < n1 ? ctx + (size_t)b * a.D + (i - n0)
                                : h_prev + (size_t)b * a.H + (i - n1);
    return __ldcg(reinterpret_cast<const float4*>(src));
  };
  for (int b0 = 0; b0 < a.B; b0 += kRows) {
    const int rows = min(kRows, a.B - b0);
    const int nvec = rows * kd4;
    float4 v[kStageVec];
#pragma unroll
    for (int j = 0; j < kStageVec; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < nvec) {
        const int rb = idx / kd4;
        v[j] = load4(b0 + rb, (idx - rb * kd4) * 4);
      } else {
        v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    if (Q) {
      float m[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kStageVec; ++j) {
        const int rb = (tid + j * kThreads) / kd4;  // >= rows past the end: v is 0
        const float mx = fmaxf(fmaxf(fabsf(v[j].x), fabsf(v[j].y)),
                               fmaxf(fabsf(v[j].z), fabsf(v[j].w)));
#pragma unroll
        for (int r = 0; r < kRows; ++r) m[r] = rb == r ? fmaxf(m[r], mx) : m[r];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float mm = warp_max(m[r]);
        if (lane == 0 && r < rows) red_s[(b0 + r) * kWarps + warp] = mm;
      }
      __syncthreads();
      if (tid < rows) {
        float mm = 0.0f;
        for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, red_s[(b0 + tid) * kWarps + w]);
        amax_s[b0 + tid] = fmaxf(mm, 1e-8f) / 127.0f;
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kStageVec; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < nvec) {
        const int rb = idx / kd4;
        const size_t at = (size_t)(b0 + rb) * Kdim + (size_t)(idx - rb * kd4) * 4;
        if (Q) {
          const float am = amax_s[b0 + rb];
          char4 q;
          q.x = (signed char)fminf(fmaxf(rintf(v[j].x / am), -127.0f), 127.0f);
          q.y = (signed char)fminf(fmaxf(rintf(v[j].y / am), -127.0f), 127.0f);
          q.z = (signed char)fminf(fmaxf(rintf(v[j].z / am), -127.0f), 127.0f);
          q.w = (signed char)fminf(fmaxf(rintf(v[j].w / am), -127.0f), 127.0f);
          *reinterpret_cast<char4*>(xs + at) = q;
        } else {
          __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(xs + 2 * at);
          dst[0] = __floats2bfloat162_rn(v[j].x, v[j].y);
          dst[1] = __floats2bfloat162_rn(v[j].z, v[j].w);
        }
      }
    }
  }
  __syncthreads();

  // A warp takes kCols gate columns at a time: each staged activation it
  // reads from shared memory serves all of them.
  const int R = 4 * Uown;
  for (int lr0 = warp; lr0 < R; lr0 += kWarps * kCols) {
    int lrs[kCols];  // columns past the end repeat the last one and are dropped
#pragma unroll
    for (int cidx = 0; cidx < kCols; ++cidx) lrs[cidx] = min(lr0 + kWarps * cidx, R - 1);
    for (int b0 = 0; b0 < a.B; b0 += kRows) {
      const int rows = min(kRows, a.B - b0);
      float sums[kCols][kRows];
      if (Q) {
        const int8_t* xq = reinterpret_cast<const int8_t*>(xs) + (size_t)b0 * Kdim;
        int acc[kCols][kRows] = {};
        for (int i = lane; i < Kdim / 16; i += 32) {
          int4 w16[kCols];
#pragma unroll
          for (int cidx = 0; cidx < kCols; ++cidx)
            w16[cidx] = reinterpret_cast<const int4*>(w_s + (size_t)lrs[cidx] * Kdim)[i];
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (j < rows) {
              const int4 xv = reinterpret_cast<const int4*>(xq + (size_t)j * Kdim)[i];
#pragma unroll
              for (int cidx = 0; cidx < kCols; ++cidx) {
                acc[cidx][j] = __dp4a(w16[cidx].x, xv.x, acc[cidx][j]);
                acc[cidx][j] = __dp4a(w16[cidx].y, xv.y, acc[cidx][j]);
                acc[cidx][j] = __dp4a(w16[cidx].z, xv.z, acc[cidx][j]);
                acc[cidx][j] = __dp4a(w16[cidx].w, xv.w, acc[cidx][j]);
              }
            }
          }
        }
#pragma unroll
        for (int cidx = 0; cidx < kCols; ++cidx)
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            sums[cidx][j] = __int2float_rn(warp_sum(acc[cidx][j])) *
                            (amax_s[min(b0 + j, a.B - 1)] * scale_s[lrs[cidx]]);
      } else {
        const __nv_bfloat16* xb = reinterpret_cast<const __nv_bfloat16*>(xs) + (size_t)b0 * Kdim;
        // Each column's weight row: in shared memory, or streamed from L2.
        const bool resident = w_s != nullptr;
        const uint4* wr[kCols];
#pragma unroll
        for (int cidx = 0; cidx < kCols; ++cidx) {
          const int g = lrs[cidx] / Uown, u = lrs[cidx] - g * Uown;
          wr[cidx] = resident
              ? reinterpret_cast<const uint4*>(w_s + (size_t)lrs[cidx] * Kdim * 2)
              : reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.w[layer]) +
                                               (size_t)(g * a.H + u0 + u) * Kdim);
        }
        float acc[kCols][kRows] = {};
        for (int i0 = lane; i0 < Kdim / 8; i0 += 32 * kRowVec) {
          uint4 wv[kCols][kRowVec];  // all requested before the first is used
#pragma unroll
          for (int cidx = 0; cidx < kCols; ++cidx)
#pragma unroll
            for (int t = 0; t < kRowVec; ++t) {
              const int i = i0 + 32 * t;
              wv[cidx][t] = i >= Kdim / 8 ? make_uint4(0u, 0u, 0u, 0u)
                            : resident    ? wr[cidx][i]
                                          : __ldg(wr[cidx] + i);
            }
#pragma unroll
          for (int t = 0; t < kRowVec; ++t) {
            const int i = i0 + 32 * t;
            if (i < Kdim / 8) {
#pragma unroll
              for (int j = 0; j < kRows; ++j) {
                if (j < rows) {
                  const uint4 xv = reinterpret_cast<const uint4*>(xb + (size_t)j * Kdim)[i];
                  const __nv_bfloat162* xp = reinterpret_cast<const __nv_bfloat162*>(&xv);
#pragma unroll
                  for (int e = 0; e < 4; ++e) {
                    const float2 xf = __bfloat1622float2(xp[e]);
#pragma unroll
                    for (int cidx = 0; cidx < kCols; ++cidx) {
                      const float2 wf = __bfloat1622float2(
                          reinterpret_cast<const __nv_bfloat162*>(&wv[cidx][t])[e]);
                      acc[cidx][j] = fmaf(wf.x, xf.x, acc[cidx][j]);
                      acc[cidx][j] = fmaf(wf.y, xf.y, acc[cidx][j]);
                    }
                  }
                }
              }
            }
          }
        }
#pragma unroll
        for (int cidx = 0; cidx < kCols; ++cidx)
#pragma unroll
          for (int j = 0; j < kRows; ++j) sums[cidx][j] = warp_sum(acc[cidx][j]);
      }
      if (lane == 0) {
#pragma unroll
        for (int cidx = 0; cidx < kCols; ++cidx)
          if (lr0 + kWarps * cidx < R)
#pragma unroll
            for (int j = 0; j < kRows; ++j)
              if (j < rows)
                g_s[(b0 + j) * 4 * a.U + lrs[cidx]] = sums[cidx][j] + bias_s[lrs[cidx]];
      }
    }
  }
  __syncthreads();

  for (int i = tid; i < a.B * Uown; i += kThreads) {
    const int b = i / Uown, u = i - b * Uown;
    const float* gb = g_s + b * 4 * a.U;
    const float ig = mstts_sigmoid(gb[u]);
    const float fg = mstts_sigmoid(gb[Uown + u]);
    const float gg = tanhf(gb[2 * Uown + u]);
    const float og = mstts_sigmoid(gb[3 * Uown + u]);
    const float c = fg * c_s[b * a.U + u] + ig * gg;
    const float h = og * tanhf(c);
    c_s[b * a.U + u] = c;
    h_next[(size_t)b * a.H + u0 + u] = h;
    if (qpart != nullptr) hown_s[b * a.U + u] = h;
  }
  if (qpart != nullptr) {
    __syncthreads();
    for (int i = tid; i < a.B * a.A; i += kThreads) {
      const int b = i / a.A, ai = i - b * a.A;
      float acc = 0.0f;
      for (int u = 0; u < Uown; ++u) acc = fmaf(hown_s[b * a.U + u], wq_s[u * a.A + ai], acc);
      qpart[((size_t)blockIdx.x * a.B + b) * a.A + ai] = acc;
    }
  }
}

template <bool Q>
__global__ void __launch_bounds__(kThreads) decode_kernel(DecArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem lay = smem_layout(a, Q);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int u0 = blockIdx.x * a.U;
  const int Uown = min(a.U, a.H - u0);
  const int pad = a.S + a.conv_k - 1, lo = (a.conv_k - 1) / 2;
  int8_t* w_s = reinterpret_cast<int8_t*>(smem_raw + lay.w);
  unsigned char* xs = smem_raw + lay.xs;
  float* part_s = reinterpret_cast<float*>(smem_raw + lay.f32);  // 16-byte aligned
  float* wloc_s = part_s + 4 * kThreads;
  float* v_s = wloc_s + a.conv_c * a.A;
  float* q_s = v_s + a.A;
  float* loc_s = q_s + a.A;
  float2* ck_s = reinterpret_cast<float2*>(loc_s + kWarps * a.conv_c * kPos);  // [tap][channel]
  float2* wc_s = ck_s + a.conv_k * a.conv_c;                             // [position]
  float* e_s = reinterpret_cast<float*>(wc_s + pad);
  float* mask_s = e_s + a.S;
  float* wq_s = mask_s + a.S;
  float* hown_s = wq_s + a.U * a.A;
  float* amax_s = hown_s + a.B * a.U;
  float* red_s = amax_s + a.B;
  float* bias_s = red_s + (a.B > kRows ? a.B : kRows) * kWarps;  // [layer][4U]
  float* scale_s = bias_s + 2 * 4 * a.U;                         // [layer][4U]
  float* g_s = scale_s + 2 * 4 * a.U;
  float* c_s[2] = {g_s + a.B * 4 * a.U, g_s + a.B * 4 * a.U + a.B * a.U};
  const bool row_block = blockIdx.x < a.B;  // runs attention for row blockIdx.x
  const int gw = warp * gridDim.x + blockIdx.x, n_gw = kWarps * gridDim.x;

  // Launch-long state: weight rows (int8: both layers; bf16: layer 0 where
  // it fits), own rows of wq, c0 / c1, and in the row blocks the attention
  // weights and location parameters.
  {
    const int esize = Q ? 1 : 2, n_layers = Q ? 2 : a.w0_resident;
    size_t off = 0;
    for (int layer = 0; layer < n_layers; ++layer) {
      const int row_bytes = (layer == 0 ? a.K0 : a.K1) * esize, r16 = row_bytes / 16;
      const unsigned char* src = static_cast<const unsigned char*>(a.w[layer]);
      for (int i = tid; i < 4 * Uown * r16; i += kThreads) {
        const int lr = i / r16, k16 = i - lr * r16;
        const int g = lr / Uown, u = lr - g * Uown;
        reinterpret_cast<uint4*>(w_s + off + (size_t)lr * row_bytes)[k16] = __ldg(
            reinterpret_cast<const uint4*>(src + (size_t)(g * a.H + u0 + u) * row_bytes) + k16);
      }
      off += (size_t)4 * a.U * row_bytes;
    }
  }
  for (int i = tid; i < a.B * Uown; i += kThreads) {
    const int b = i / Uown, u = i - b * Uown;
    c_s[0][b * a.U + u] = a.c_in[0][(size_t)b * a.H + u0 + u];
    c_s[1][b * a.U + u] = a.c_in[1][(size_t)b * a.H + u0 + u];
  }
  for (int i = tid; i < Uown * a.A; i += kThreads) wq_s[i] = __ldg(a.wq + (size_t)u0 * a.A + i);
  for (int i = tid; i < 2 * 4 * Uown; i += kThreads) {
    const int layer = i / (4 * Uown), lr = i - layer * 4 * Uown;
    const int col = (lr / Uown) * a.H + u0 + lr % Uown;
    bias_s[layer * 4 * a.U + lr] = a.bias[layer][col];
    scale_s[layer * 4 * a.U + lr] = a.scale[layer][col];
  }
  if (row_block) {
    for (int i = tid; i < a.conv_k * a.conv_c; i += kThreads) {
      const int tap = i / a.conv_c, c = i - tap * a.conv_c;
      ck_s[i] = make_float2(__ldg(a.ck + (size_t)(tap * 2) * a.conv_c + c),
                            __ldg(a.ck + (size_t)(tap * 2 + 1) * a.conv_c + c));
    }
    for (int i = tid; i < a.conv_c * a.A; i += kThreads) wloc_s[i] = __ldg(a.wloc + i);
    for (int i = tid; i < a.A; i += kThreads) v_s[i] = __ldg(a.v + i);
    for (int i = tid; i < a.S; i += kThreads) mask_s[i] = a.mask[(size_t)blockIdx.x * a.S + i];
    for (int i = tid; i < pad; i += kThreads) {
      const int s = i - lo;
      const bool in = s >= 0 && s < a.S;
      wc_s[i] = in ? make_float2(a.w_in[(size_t)blockIdx.x * a.S + s],
                                 a.cum_in[(size_t)blockIdx.x * a.S + s])
                   : make_float2(0.0f, 0.0f);
    }
  }
  __syncthreads();

  unsigned int epoch = 0;  // of the grid barrier
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

    // Prenet layer 1 and 2: one output unit per warp of the grid, all rows.
    for (int layer = 0; layer < 2; ++layer) {
      const int n_in = layer == 0 ? a.mel : a.P1, n_out = layer == 0 ? a.P1 : a.P2;
      const float* wt = layer == 0 ? a.wp1 : a.wp2;
      const float* bt = layer == 0 ? a.bp1 : a.bp2;
      const float* x = layer == 0 ? prev : a.a1;
      const int xstride = layer == 0 ? prev_stride : a.P1;
      const float* m = layer == 0 ? a.m1 : a.m2;
      float* out = layer == 0 ? a.a1 : a.a2;
      for (int o = gw; o < n_out; o += n_gw) {
        const float bias = __ldg(bt + o);
        for (int b0 = 0; b0 < a.B; b0 += kRows) {
          const int rows = min(kRows, a.B - b0);
          float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
          float keep[kRows];  // requested with the operands, not after the sum
#pragma unroll
          for (int j = 0; j < kRows; ++j)
            keep[j] = m != nullptr && j < rows ? __ldg(m + ((size_t)k * a.B + b0 + j) * n_out + o)
                                               : 1.0f;
          // The fed-back frame sits inside a row of ys: not 16-byte aligned.
          lane_dot(wt + (size_t)o * n_in, x + (size_t)b0 * xstride, xstride, n_in, rows,
                   layer == 1, acc);
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            const float sum = warp_sum(acc[j]);
            if (lane == 0 && j < rows) {
              out[(size_t)(b0 + j) * n_out + o] = fmaxf(sum + bias, 0.0f) * keep[j];
            }
          }
        }
      }
      mstts_grid_barrier(a.bar, epoch);
    }

    // Layer 0: gates from [prenet, previous context, h0] and cell 0.
    gate_phase<Q>(a, 0, a.K0, a.a2, a.P2, ctx_old, h_old[0], h_new[0],
                  Q || a.w0_resident ? w_s : nullptr, xs, amax_s, red_s,
                  bias_s, scale_s, g_s, c_s[0], u0, Uown, hown_s, wq_s, a.qpart);
    mstts_grid_barrier(a.bar, epoch);

    // Attention and context for row b in block b.
    if (row_block) {
      const int b = blockIdx.x;
      const int a4n = a.A / 4;
      // q = the blocks' shares of h0 . wq, summed in block order: groups of
      // A / 4 threads take every ngroups-th block, kQVec loads in flight.
      {
        const int ngroups = kThreads / a4n, g = tid / a4n, a4 = tid - g * a4n;
        const float4* qp = reinterpret_cast<const float4*>(a.qpart) + (size_t)b * a4n + a4;
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (g < ngroups) {
          for (int blk0 = g; blk0 < (int)gridDim.x; blk0 += ngroups * kQVec) {
            float4 pv[kQVec];
#pragma unroll
            for (int t = 0; t < kQVec; ++t) {
              const int blk = blk0 + t * ngroups;
              pv[t] = blk < (int)gridDim.x ? __ldcg(qp + (size_t)blk * a.B * a4n)
                                           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            }
#pragma unroll
            for (int t = 0; t < kQVec; ++t) {
              acc.x += pv[t].x;
              acc.y += pv[t].y;
              acc.z += pv[t].z;
              acc.w += pv[t].w;
            }
          }
          reinterpret_cast<float4*>(part_s)[tid] = acc;
        }
        __syncthreads();
        if (tid < a.A) {
          float q = 0.0f;
          for (int gg = 0; gg < ngroups; ++gg) q += part_s[gg * a.A + tid];
          q_s[tid] = q;
        }
        __syncthreads();
      }
      // Energies: a warp takes kPos memory positions at a time, so that each
      // shared-memory read of the conv kernel and of the location projection
      // serves kPos independent sums. Location conv with a lane per channel,
      // then four neighbouring attention units per lane.
      float4* loc4 = reinterpret_cast<float4*>(loc_s) + warp * a.conv_c;  // [channel][position]
      const float4* key4 = reinterpret_cast<const float4*>(a.keys + (size_t)b * a.S * a.A);
      for (int s0 = warp; s0 < a.S; s0 += kWarps * kPos) {
        int sp[kPos];  // positions past the end repeat the last one and are dropped
        float4 kv[kPos];
#pragma unroll
        for (int p = 0; p < kPos; ++p) {
          sp[p] = min(s0 + kWarps * p, a.S - 1);
          kv[p] = lane < a4n ? __ldg(key4 + (size_t)sp[p] * a4n + lane)
                             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        for (int c = lane; c < a.conv_c; c += 32) {
          float aw[kPos] = {0.0f, 0.0f, 0.0f, 0.0f}, ac[kPos] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 2
          for (int tap = 0; tap < a.conv_k; ++tap) {
            const float2 kk = ck_s[tap * a.conv_c + c];
#pragma unroll
            for (int p = 0; p < kPos; ++p) {
              const float2 x = wc_s[sp[p] + tap];
              aw[p] = fmaf(x.x, kk.x, aw[p]);
              ac[p] = fmaf(x.y, kk.y, ac[p]);
            }
          }
          loc4[c] = make_float4(aw[0] + ac[0], aw[1] + ac[1], aw[2] + ac[2], aw[3] + ac[3]);
        }
        __syncwarp();
        float part[kPos] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int a4 = lane; a4 < a4n; a4 += 32) {
          if (a4 != lane) {
#pragma unroll
            for (int p = 0; p < kPos; ++p) kv[p] = __ldg(key4 + (size_t)sp[p] * a4n + a4);
          }
          float4 la[kPos];
#pragma unroll
          for (int p = 0; p < kPos; ++p) la[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
          for (int c = 0; c < a.conv_c; ++c) {
            const float4 l4 = loc4[c];
            const float l[kPos] = {l4.x, l4.y, l4.z, l4.w};
            const float4 wl = reinterpret_cast<const float4*>(wloc_s)[c * a4n + a4];
#pragma unroll
            for (int p = 0; p < kPos; ++p) {
              la[p].x = fmaf(l[p], wl.x, la[p].x);
              la[p].y = fmaf(l[p], wl.y, la[p].y);
              la[p].z = fmaf(l[p], wl.z, la[p].z);
              la[p].w = fmaf(l[p], wl.w, la[p].w);
            }
          }
          const float4 q4 = reinterpret_cast<const float4*>(q_s)[a4];
          const float4 v4 = reinterpret_cast<const float4*>(v_s)[a4];
#pragma unroll
          for (int p = 0; p < kPos; ++p) {
            part[p] = fmaf(tanhf(q4.x + kv[p].x + la[p].x), v4.x, part[p]);
            part[p] = fmaf(tanhf(q4.y + kv[p].y + la[p].y), v4.y, part[p]);
            part[p] = fmaf(tanhf(q4.z + kv[p].z + la[p].z), v4.z, part[p]);
            part[p] = fmaf(tanhf(q4.w + kv[p].w + la[p].w), v4.w, part[p]);
          }
        }
#pragma unroll
        for (int p = 0; p < kPos; ++p) {
          const float e = warp_sum(part[p]);
          if (lane == 0 && s0 + kWarps * p < a.S) e_s[sp[p]] = mask_s[sp[p]] > 0.0f ? e : -1e9f;
        }
        __syncwarp();
      }
      __syncthreads();
      if (warp == 0) {
        float m = -INFINITY;
        for (int s = lane; s < a.S; s += 32) m = fmaxf(m, e_s[s]);
        m = warp_max(m);
        float sum = 0.0f;
        for (int s = lane; s < a.S; s += 32) {
          const float p = expf(e_s[s] - m);
          e_s[s] = p;
          sum += p;
        }
        sum = warp_sum(sum);
        for (int s = lane; s < a.S; s += 32) e_s[s] = e_s[s] / sum;
      }
      __syncthreads();
      for (int s = tid; s < a.S; s += kThreads) {
        const float p = e_s[s];
        wc_s[lo + s] = make_float2(p, wc_s[lo + s].y + p);
        a.aligns[((size_t)k * a.B + b) * a.S + s] = p;
      }
      // Context: a thread per memory channel walks the positions (a warp
      // reads 128 contiguous bytes of a position's row at a time).
      for (int d = tid; d < a.D; d += kThreads) {
        const float* mem = a.memory + (size_t)b * a.S * a.D + d;
        float acc = 0.0f;
#pragma unroll 8
        for (int s = 0; s < a.S; ++s) acc = fmaf(e_s[s], __ldg(mem + (size_t)s * a.D), acc);
        ctx_new[(size_t)b * a.D + d] = acc;
      }
    }
    mstts_grid_barrier(a.bar, epoch);

    // Layer 1: gates from [h0, context, h1] and cell 1.
    gate_phase<Q>(a, 1, a.K1, h_new[0], a.H, ctx_new, h_old[1], h_new[1],
                  Q ? w_s + (size_t)4 * a.U * a.K0 : nullptr, xs, amax_s, red_s, bias_s + 4 * a.U,
                  scale_s + 4 * a.U, g_s, c_s[1], u0, Uown, nullptr, nullptr, nullptr);
    mstts_grid_barrier(a.bar, epoch);

    // Frame + stop projection of [h1, context]: one output per block at a
    // time, its H + D products dealt over all threads (one L2 round trip).
    const int n4 = (a.H + a.D) / 4;
    for (int o = blockIdx.x; o < a.NO; o += gridDim.x) {
      const float4* wr = reinterpret_cast<const float4*>(a.wproj + (size_t)o * (a.H + a.D));
      const float bias = __ldg(a.bproj + o);
      for (int b0 = 0; b0 < a.B; b0 += kRows) {
        const int rows = min(kRows, a.B - b0);
        float acc[kRows] = {0.0f, 0.0f, 0.0f, 0.0f};
        for (int i = tid; i < n4; i += kThreads) {
          const float4 wv = __ldg(wr + i);
          const int e = 4 * i;
#pragma unroll
          for (int j = 0; j < kRows; ++j) {
            if (j < rows) {
              const float* xp = e < a.H ? h_new[1] + (size_t)(b0 + j) * a.H + e
                                        : ctx_new + (size_t)(b0 + j) * a.D + (e - a.H);
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
          a.ys[((size_t)k * a.B + b0 + tid) * a.NO + o] = y;
          const int f = o - a.mel * (a.r - 1);
          if (k == a.K - 1 && f >= 0 && f < a.mel) a.prev_out[(size_t)(b0 + tid) * a.mel + f] = y;
        }
        __syncthreads();
      }
    }
    if (k + 1 < a.K) mstts_grid_barrier(a.bar, epoch);
  }

  for (int i = tid; i < a.B * Uown; i += kThreads) {
    const int b = i / Uown, u = i - b * Uown;
    a.c_out[0][(size_t)b * a.H + u0 + u] = c_s[0][b * a.U + u];
    a.c_out[1][(size_t)b * a.H + u0 + u] = c_s[1][b * a.U + u];
  }
  if (row_block) {
    for (int s = tid; s < a.S; s += kThreads) {
      a.w_out[(size_t)blockIdx.x * a.S + s] = wc_s[lo + s].x;
      a.cum_out[(size_t)blockIdx.x * a.S + s] = wc_s[lo + s].y;
    }
  }
}

}  // namespace

MSTTS_EXPORT int mstts_decode_segment(const void* const* p, const int* d, void* stream) {
  DecArgs a = {};
  a.K = d[DK]; a.B = d[DB]; a.S = d[DS]; a.A = d[DA]; a.D = d[DD]; a.H = d[DH];
  a.P1 = d[DP1]; a.P2 = d[DP2]; a.mel = d[DMEL]; a.r = d[DR];
  a.conv_k = d[DCONVK]; a.conv_c = d[DCONVC];
  const bool quantized = d[DQUANT] != 0;
  a.K0 = a.P2 + a.D + a.H;
  a.K1 = 2 * a.H + a.D;
  a.NO = a.mel * a.r + 1;
  auto f = [&](int i) { return static_cast<const float*>(p[i]); };
  auto fm = [&](int i) { return static_cast<float*>(const_cast<void*>(p[i])); };
  a.w[0] = p[W0]; a.w[1] = p[W1];
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
  // Scratch: h0 (2, B, H), h1 (2, B, H), ctx (B, D), a1 (B, P1), a2 (B, P2),
  // then the q partials (SMs, B, A).
  float* s = fm(SCRATCH);
  a.h_buf[0] = s; s += (size_t)2 * a.B * a.H;
  a.h_buf[1] = s; s += (size_t)2 * a.B * a.H;
  a.ctx_buf = s;  s += (size_t)a.B * a.D;
  a.a1 = s;       s += (size_t)a.B * a.P1;
  a.a2 = s;       s += (size_t)a.B * a.P2;
  a.qpart = s;
  a.bar = static_cast<unsigned int*>(const_cast<void*>(p[BAR]));

  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (a.K < 1 || a.B < 1 || a.S < 1 || a.A < 1 || a.A > kThreads || a.H % 16 || a.D % 16 ||
      a.P2 % 16 || a.P1 % 4 || a.mel % 4 || a.r < 1 || a.K0 > kMaxK || a.K1 > kMaxK ||
      a.A % 4 || a.conv_c % 4)
    return (int)cudaErrorInvalidValue;
  // The staging's 16-byte loads: state rows and scratch must be aligned.
  for (int i : {H0_IN, H1_IN, CTX_IN, H0_OUT, H1_OUT, CTX_OUT, SCRATCH, KEYS})
    if (reinterpret_cast<uintptr_t>(p[i]) % 16) return (int)cudaErrorMisalignedAddress;
  // One block per SM at most (all co-resident for the grid barrier).
  a.U = (a.H + nsm - 1) / nsm;
  a.nblk = (a.H + a.U - 1) / a.U;
  a.w0_resident = 1;  // bf16 mode: only where layer 0's rows fit beside the rest
  if (!quantized && smem_layout(a, false).total > (size_t)max_smem) a.w0_resident = 0;
  const Smem lay = smem_layout(a, quantized);
  if (a.B > a.nblk || lay.total > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  const void* kernel = quantized ? (const void*)decode_kernel<true> : (const void*)decode_kernel<false>;
  MSTTS_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)lay.total));
  void* params[] = {&a};
  MSTTS_CHECK(cudaLaunchCooperativeKernel(kernel, dim3(a.nblk), dim3(kThreads), params,
                                          lay.total, static_cast<cudaStream_t>(stream)));
  MSTTS_RETURN_LAUNCH_ERROR();
}
