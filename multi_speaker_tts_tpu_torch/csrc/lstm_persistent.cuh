// Persistent LSTM recurrence on tensor cores: one cooperative launch runs
// every time step.
//
// Shared by lstm.cu (GE2E layer: replaces
// multi_speaker_tts_tpu/ops/lstm_pallas.py::lstm_seq_layer_fwd, kernel body
// _fwd_kernel) and bilstm.cu (text-encoder BiLSTM, both directions in one
// launch: replaces ops/birnn_pallas.py::_bilstm_fwd_impl, kernel body
// _bilstm_fwd_kernel). Numerics follow the TPU kernels: bf16 operands, f32
// accumulation, f32 gates and cell state, h stored as bf16 (the carried h
// is used only as a bf16 matmul operand, so storing it bf16 loses nothing
// the next step would have used). As in _fwd_kernel, which sums
// dot(x_t, W_ih) and dot(h, W_hh) as two f32-accumulated products, the
// input half and the recurrent half are summed separately in f32.
//
// What bounds it: the time steps are sequential, and each one needs
// h_{t-1} from every block. So a step costs one grid barrier plus one L2
// round trip of h (B x H bf16, 48 KB at B = 32, H = 768), and the launch
// costs T of those. Bytes and operations are far below that (the weights
// are read from device memory once per launch; the GE2E layer's products
// are ~19 GFLOP at B = 32, ~20 us of tensor cores). The design keeps
// everything else off that chain:
//
// - Block j of direction d owns U hidden units and their 4U gate columns.
//   Its slice of W_ih and W_hh (gate column n = g*U + u <- global column
//   g*H + u0 + u) is loaded into shared memory once and stays there.
// - Phase 0 (GE2E, D > 0), before the time loop: the block computes the
//   input half X = x . W_ih + b of its own columns for all T*B rows on
//   tensor cores into an f32 scratch (T, B, 4H) that the wrapper
//   allocates. No barrier: a block reads back only its own columns. The
//   BiLSTM (D = 0) reads the gates its caller hoisted (gx, bias included).
// - A step: h_{t-1} (B rows of ys, contiguous) is staged into shared
//   memory by cp.async (16 bytes a thread, L2 only), each warp the columns
//   of its own k range, so no block-wide barrier precedes the product
//   h_{t-1} [B, H] . W_hh slice [H, 4U]. It runs as mma.sync m16n8k16
//   (ldmatrix for both operands; B padded with zero rows to a multiple of
//   16, 4U to a multiple of 8), K split across the 8 warps, the partial
//   tiles added in shared memory in a fixed order; the cell update adds
//   the input half and writes h_t.
// - The grid barrier is split (common.cuh): after arriving, the block
//   stores the step's residuals and puts the next step's input half
//   (loaded into registers at the start of the step) into shared memory,
//   then waits. Neither depends on other blocks.
// - Shared-memory rows are padded so that ldmatrix's eight 16-byte rows
//   fall in distinct banks (stride an odd multiple of 16 bytes), and the
//   phase-0 weight rows so that a quarter-warp's 16-byte loads of two rows
//   do (stride 64 mod 128 bytes).
//
// Residual mode (training): with g_res / c_res set, each step also stores
// the f32 pre-activation gates rounded to bf16 and c_{t-1} rounded to bf16,
// in natural time, which is what the TPU kernels store with
// save_residuals=True and what the reverse kernel (lstm_bwd.cuh) reads.
// They are staged as a bf16 tile and written after the barrier's arrival,
// one run of U units per row and gate in the widest aligned pieces (4
// bytes at U = 6, 8 at U = 4; 16 would need 16-byte aligned runs, U a
// multiple of 8).
#pragma once

#include <algorithm>

#include "common.cuh"

namespace mstts {

constexpr int kLstmThreads = 256;
constexpr int kLstmWarps = kLstmThreads / 32;
// Rows a launch: at most kLstmMT m-tiles of 16. Larger batches take more
// launches (lstm_run); at B = 64 two launches of 32 rows took the time of
// one of 64, and the step's code, which every step fetches again, is smaller.
constexpr int kLstmMaxRows = 32;
constexpr int kLstmMT = kLstmMaxRows / 16;
constexpr int kLstmNGroup = 3;    // n-tiles of 8 gate columns a warp holds at once
constexpr int kLstmRing = 2;      // phase 0: 32-wide k chunks a warp loads ahead
constexpr int kLstmPre = 4;       // input-half values a thread prefetches a step

struct LstmArgs {
  int T;      // time steps
  int B;      // rows in this launch
  int Bs;     // row stride of the time-major tensors (the full batch)
  int D;      // input width (0: gates precomputed in gx)
  int H;      // hidden units per direction
  int U;      // hidden units per block
  int nblk;   // blocks per direction
  const __nv_bfloat16* x;      // (T, Bs, D) when D > 0
  const __nv_bfloat16* gx[2];  // (T, Bs, 4H) hoisted gates + bias when D == 0
  const __nv_bfloat16* w[2];   // (4H, D + H): row n = [W_ih[:, n]; W_hh[:, n]]
  const float* bias[2];        // (4H) when D > 0
  float* xg;                   // (T, Bs, 4H) f32 scratch for phase 0 when D > 0
  __nv_bfloat16* ys[2];        // (T, Bs, H), natural time for both directions
  float* h_last;               // (Bs, H) direction 0 final h, or null
  float* c_last;               // (Bs, H) direction 0 final c, or null
  __nv_bfloat16* g_res[2];     // (T, Bs, 4H) pre-activation gates, or null
  __nv_bfloat16* c_res[2];     // (T, Bs, H) cell state before the step, or null
  unsigned int* bar;           // the grid barrier's arrival counter, zeroed by the wrapper
  unsigned int epoch0;         // arrivals counted by this call's earlier launches
};

__host__ __device__ inline size_t lstm_smem_bytes(int U, int D, int H, int B) {
  const int NP = mstts_round_up(4 * U, 8), BP = mstts_round_up(B, 16);
  const size_t bf16 = (size_t)NP * (D > 0 ? mstts_k32_stride(D) : 0) +
                      (size_t)(NP + BP) * mstts_ldmatrix_stride(H);
  const size_t f32 = (size_t)kLstmWarps * BP * NP + (size_t)B * NP + (size_t)B * U;
  return 2 * bf16 + 4 * f32 + 2 * ((size_t)B * 4 * U + (size_t)B * U);
}

__global__ void __launch_bounds__(kLstmThreads, 1) lstm_persistent_kernel(LstmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, H = a.H, B = a.B, H4 = 4 * a.H;
  const int dir = blockIdx.x / a.nblk;
  const int u0 = (blockIdx.x % a.nblk) * a.U;
  const int U = min(a.U, H - u0);  // units owned (the last block may own fewer)
  const int R = 4 * U;             // gate columns owned: n = g*U + u
  const int NP = mstts_round_up(4 * a.U, 8), NT = (R + 7) / 8;
  const int BP = mstts_round_up(B, 16), MT = BP / 16;
  const int DS = D > 0 ? mstts_k32_stride(D) : 0, HS = mstts_ldmatrix_stride(H);
  __nv_bfloat16* wx_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NP][DS] W_ih columns
  __nv_bfloat16* wh_s = wx_s + (size_t)NP * DS;                      // [NP][HS] W_hh columns
  __nv_bfloat16* h_s = wh_s + (size_t)NP * HS;                       // [BP][HS] h_{t-1}
  float* part_s = reinterpret_cast<float*>(h_s + (size_t)BP * HS);   // [warp][BP][NP]
  float* pre_s = part_s + (size_t)kLstmWarps * BP * NP;              // [B][NP] input half
  float* c_s = pre_s + (size_t)B * NP;                               // [B][a.U]
  __nv_bfloat16* gres_s = reinterpret_cast<__nv_bfloat16*>(c_s + (size_t)B * a.U);  // [B][R]
  __nv_bfloat16* cres_s = gres_s + (size_t)B * 4 * a.U;                             // [B][a.U]

  // Zero the padded tiles (rows past R or B, columns past D or H), then
  // load the resident weight slice: local row r = g*U + u <- global row
  // g*H + u0 + u.
  const size_t n_bf16_16 = ((size_t)NP * DS + (size_t)(NP + BP) * HS) / 8;
  for (size_t i = threadIdx.x; i < n_bf16_16; i += kLstmThreads)
    reinterpret_cast<uint4*>(wx_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < B * a.U; i += kLstmThreads) c_s[i] = 0.0f;
  __syncthreads();
  const int K8 = (D + H) / 8, D8 = D / 8;
  for (int i = threadIdx.x; i < R * K8; i += kLstmThreads) {
    const int r = i / K8, k8 = i - r * K8;
    const int g = r / U, u = r - g * U;
    const uint4 v =
        __ldg(reinterpret_cast<const uint4*>(a.w[dir] + (size_t)(g * H + u0 + u) * (D + H)) + k8);
    if (k8 < D8)
      reinterpret_cast<uint4*>(wx_s + (size_t)r * DS)[k8] = v;
    else
      reinterpret_cast<uint4*>(wh_s + (size_t)r * HS)[k8 - D8] = v;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, tq = lane & 3;  // fragment row / column pair of this lane

  // Phase 0: X[m, n] = x[m] . W_ih[:, n] + b[n] for the rows m = t*B + b of
  // this launch and the block's columns, 32 rows (two m-tiles) a warp at a
  // time. Each lane loads 8 consecutive k of rows g8 + {0, 8, 16, 24}
  // straight from global memory (mstts_mma_bf16_k32 pairs them with the same
  // k of the weight rows); the loads of the next two 32-wide k chunks are in
  // flight while the current two's MMAs run. Every block reads all of x
  // (3 MB at the train shape) through L2, so this phase is bound by L2
  // bandwidth and by the loads a lane keeps in flight.
  if (D > 0) {
    const int M = a.T * B, kchunks = (D + 31) / 32;
    for (int m0 = warp * 32; m0 < M; m0 += kLstmWarps * 32) {
      const __nv_bfloat16* xr[4];
      size_t row[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + g8 + 8 * r;
        row[r] = (size_t)(m / B) * a.Bs + m % B;
        xr[r] = m < M ? a.x + row[r] * D + tq * 8 : nullptr;
      }
      auto load = [&](uint4 (&buf)[kLstmRing][4], int kc) {
#pragma unroll
        for (int q = 0; q < kLstmRing; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            buf[q][r] = (kc + q < kchunks && (kc + q) * 32 + tq * 8 < D && xr[r] != nullptr)
                            ? __ldg(reinterpret_cast<const uint4*>(xr[r] + (kc + q) * 32))
                            : make_uint4(0u, 0u, 0u, 0u);
      };
      for (int ng = 0; ng < NT; ng += kLstmNGroup) {
        float acc[2][kLstmNGroup][4] = {};
        uint4 cur[kLstmRing][4], nxt[kLstmRing][4];
        load(cur, 0);
        for (int kc = 0; kc < kchunks; kc += kLstmRing) {
          const bool more = kc + kLstmRing < kchunks;
          if (more) load(nxt, kc + kLstmRing);
#pragma unroll
          for (int q = 0; q < kLstmRing; ++q) {
#pragma unroll
            for (int j = 0; j < kLstmNGroup; ++j) {
              if (kc + q < kchunks && ng + j < NT) {
                const uint4 b = *reinterpret_cast<const uint4*>(
                    wx_s + (size_t)((ng + j) * 8 + g8) * DS + (kc + q) * 32 + tq * 8);
                mstts_mma_bf16_k32(acc[0][j], cur[q][0], cur[q][1], b);
                mstts_mma_bf16_k32(acc[1][j], cur[q][2], cur[q][3], b);
              }
            }
          }
          if (more) {
#pragma unroll
            for (int q = 0; q < kLstmRing; ++q)
#pragma unroll
              for (int r = 0; r < 4; ++r) cur[q][r] = nxt[q][r];
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int j = 0; j < kLstmNGroup; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 2 * mi + (e >> 1);  // row slot: g8 + 8r
              const int n = (ng + j) * 8 + 2 * tq + (e & 1);
              if (ng + j < NT && xr[r] != nullptr && n < R) {
                const int col = (n / U) * H + u0 + n % U;
                a.xg[row[r] * H4 + col] = acc[mi][j][e] + a.bias[dir][col];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the block's own xg writes, visible to its threads
  }

  // The input half of step s: phase 0's scratch (read through L2) or the
  // caller's hoisted gates. fetch_pre loads up to kLstmPre values a thread
  // into registers a step ahead; put_pre stores them into pre_s and loads
  // any further values (4U > 32 gate columns) directly.
  float pre_v[kLstmPre];
  auto pre_at = [&](int s, int i) {
    const int t = dir == 0 ? s : a.T - 1 - s;
    const int b = i / R, n = i - b * R;
    const size_t off = ((size_t)t * a.Bs + b) * H4 + (n / U) * H + u0 + n % U;
    return D > 0 ? __ldcg(a.xg + off) : __bfloat162float(__ldg(a.gx[dir] + off));
  };
  auto fetch_pre = [&](int s) {
#pragma unroll
    for (int q = 0; q < kLstmPre; ++q) {
      const int i = q * kLstmThreads + threadIdx.x;
      if (i < B * R) pre_v[q] = pre_at(s, i);
    }
  };
  auto put_pre = [&](int s) {
#pragma unroll
    for (int q = 0; q < kLstmPre; ++q) {
      const int i = q * kLstmThreads + threadIdx.x;
      if (i < B * R) pre_s[(i / R) * NP + i % R] = pre_v[q];
    }
    for (int i = kLstmPre * kLstmThreads + threadIdx.x; i < B * R; i += kLstmThreads)
      pre_s[(i / R) * NP + i % R] = pre_at(s, i);
  };
  // Residual runs of step s: four gate runs and one c_{t-1} run per row,
  // stored by warps 1-7: thread 0 fences after the barrier's wait, which
  // would wait for stores of its own.
  auto store_residuals = [&](int s) {
    const int t = dir == 0 ? s : a.T - 1 - s;
    for (int i = threadIdx.x - 32; i < B * 5; i += kLstmThreads - 32) {
      if (i < 0) break;
      const int b = i / 5, k = i - b * 5;
      const size_t row = (size_t)t * a.Bs + b;
      if (k < 4)
        mstts_store_bf16_run(a.g_res[dir] + row * H4 + k * H + u0, gres_s + (b * 4 + k) * U, U);
      else
        mstts_store_bf16_run(a.c_res[dir] + row * H + u0, cres_s + b * U, U);
    }
  };
  fetch_pre(0);
  put_pre(0);

  const int ksteps = (H + 15) / 16;
  const int kb = warp * ksteps / kLstmWarps, ke = (warp + 1) * ksteps / kLstmWarps;
  const bool residuals = a.g_res[dir] != nullptr;
  unsigned int epoch = a.epoch0;  // of the grid barrier
  for (int s = 0; s < a.T; ++s) {
    const int t = dir == 0 ? s : a.T - 1 - s;  // natural time of this step
    const int tp = dir == 0 ? t - 1 : t + 1;   // natural time of h_{prev}
    if (s + 1 < a.T) fetch_pre(s + 1);  // in flight through the step
    if (s > 0) {  // at s = 0, h_s holds zeros
      // Each warp stages the columns of h_{t-1} that its own k range reads
      // (and no other warp does), so it waits for its own copies only.
      // Written by other blocks this launch: cp.async.cg reads through L2.
      const int c0 = 2 * kb, cw = min(2 * ke, H / 8) - c0;  // 8-column pieces
      const __nv_bfloat16* src = a.ys[dir] + (size_t)tp * a.Bs * H;
      for (int i = lane; i < B * cw; i += 32) {
        const int b = i / cw, k8 = c0 + i % cw;
        mstts_cp_async16(h_s + (size_t)b * HS + 8 * k8, src + (size_t)b * H + 8 * k8);
      }
      mstts_cp_async_wait_all();
      __syncwarp();
    }

    // The recurrent half: this warp's k range of h_{t-1} . W_hh slice.
    for (int ng = 0; ng < NT; ng += kLstmNGroup) {
      float acc[kLstmMT][kLstmNGroup][4] = {};
      for (int ks = kb; ks < ke; ++ks) {
        const int k0 = ks * 16;
        uint32_t bf[kLstmNGroup][2];
#pragma unroll
        for (int j = 0; j < kLstmNGroup; ++j)
          if (ng + j < NT)
            mstts_ldmatrix_x2(bf[j], wh_s + (size_t)((ng + j) * 8 + (lane & 7)) * HS + k0 +
                                         ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < kLstmMT; ++mi) {
          if (mi < MT) {
            uint32_t af[4];
            mstts_ldmatrix_x4(af, h_s + (size_t)(mi * 16 + (lane & 15)) * HS + k0 +
                                      (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < kLstmNGroup; ++j)
              if (ng + j < NT)
                mstts_mma_bf16(acc[mi][j], af[0], af[1], af[2], af[3], bf[j][0], bf[j][1]);
          }
        }
      }
      float* pw = part_s + (size_t)warp * BP * NP;
#pragma unroll
      for (int mi = 0; mi < kLstmMT; ++mi) {
#pragma unroll
        for (int j = 0; j < kLstmNGroup; ++j) {
          if (mi < MT && ng + j < NT) {
            const int m = mi * 16 + g8, n = (ng + j) * 8 + 2 * tq;
            *reinterpret_cast<float2*>(pw + m * NP + n) = make_float2(acc[mi][j][0], acc[mi][j][1]);
            *reinterpret_cast<float2*>(pw + (m + 8) * NP + n) =
                make_float2(acc[mi][j][2], acc[mi][j][3]);
          }
        }
      }
    }
    __syncthreads();

    // Cell update: gates = input half + the warps' partials, in warp order.
    for (int i = threadIdx.x; i < B * U; i += kLstmThreads) {
      const int b = i / U, u = i - b * U;
      float gs[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int n = g * U + u;
        float v = pre_s[b * NP + n];
#pragma unroll
        for (int w = 0; w < kLstmWarps; ++w) v += part_s[((size_t)w * BP + b) * NP + n];
        gs[g] = v;
      }
      const float ig = mstts_sigmoid(gs[0]);
      const float fg = mstts_sigmoid(gs[1]);
      const float gg = tanhf(gs[2]);
      const float og = mstts_sigmoid(gs[3]);
      const float c_prev = c_s[b * a.U + u];
      const float c = fg * c_prev + ig * gg;
      const float h = og * tanhf(c);
      c_s[b * a.U + u] = c;
      a.ys[dir][((size_t)t * a.Bs + b) * H + u0 + u] = __float2bfloat16(h);
      if (residuals) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gres_s[(b * 4 + g) * U + u] = __float2bfloat16(gs[g]);
        cres_s[b * U + u] = __float2bfloat16(c_prev);
      }
      if (s == a.T - 1 && dir == 0 && a.h_last != nullptr) {
        a.h_last[(size_t)b * H + u0 + u] = h;
        a.c_last[(size_t)b * H + u0 + u] = c;
      }
    }
    if (s + 1 < a.T) {
      // h_t is out: arrive, then do what needs no other block, then wait.
      mstts_grid_arrive(a.bar, epoch);
      put_pre(s + 1);
      if (residuals) store_residuals(s);
      mstts_grid_wait(a.bar, epoch);
    } else if (residuals) {
      __syncthreads();
      store_residuals(s);
    }
  }
}

// Runs the recurrence for all rows, in launches of as many rows as shared
// memory and the kLstmMT m-tiles of a step hold. `a` arrives with its
// pointers at row 0 and a.B = a.Bs.
inline int lstm_run(LstmArgs a, int ndir, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (a.D % 8 != 0 || a.H % 8 != 0 || a.T < 1 || a.Bs < 1 || (a.D > 0 && a.xg == nullptr))
    return (int)cudaErrorInvalidValue;
  MSTTS_CHECK(mstts_recurrence_grid(ndir, a.H, &a.U, &a.nblk));
  int rows = std::min(a.Bs, kLstmMaxRows);
  while (rows > 1 && lstm_smem_bytes(a.U, a.D, a.H, rows) > (size_t)max_smem) rows = (rows + 1) / 2;
  const size_t smem_max_rows = lstm_smem_bytes(a.U, a.D, a.H, rows);
  if (smem_max_rows > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  MSTTS_CHECK(cudaFuncSetAttribute(lstm_persistent_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem_max_rows));
  const dim3 grid(ndir * a.nblk), block(kLstmThreads);
  for (int b0 = 0; b0 < a.Bs; b0 += rows) {
    LstmArgs c = a;
    c.B = std::min(rows, a.Bs - b0);
    c.epoch0 = (unsigned int)(b0 / rows) * grid.x * (unsigned int)(a.T - 1);
    if (c.x) c.x += (size_t)b0 * a.D;
    if (c.xg) c.xg += (size_t)b0 * 4 * a.H;
    for (int d = 0; d < ndir; ++d) {
      if (c.gx[d]) c.gx[d] += (size_t)b0 * 4 * a.H;
      c.ys[d] += (size_t)b0 * a.H;
      if (c.g_res[d]) {
        c.g_res[d] += (size_t)b0 * 4 * a.H;
        c.c_res[d] += (size_t)b0 * a.H;
      }
    }
    if (c.h_last) {
      c.h_last += (size_t)b0 * a.H;
      c.c_last += (size_t)b0 * a.H;
    }
    void* params[] = {&c};
    MSTTS_CHECK(cudaLaunchCooperativeKernel((const void*)lstm_persistent_kernel, grid, block,
                                            params, lstm_smem_bytes(a.U, a.D, a.H, c.B), stream));
  }
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace mstts
