// Persistent LSTM recurrence: one cooperative launch runs every time step.
//
// Shared by lstm.cu (GE2E layer, input projection fused into the step) and
// bilstm.cu (text-encoder BiLSTM, both directions in one launch, input
// gates hoisted by the caller). Numerics follow the TPU kernels: bf16
// operands, f32 accumulation, f32 gates and cell state, h stored as bf16
// (the carried h is used only as a bf16 matmul operand, so storing it bf16
// loses nothing the next step would have used).
//
// Design (cuDNN persistent-RNN style): block j of direction d owns U hidden
// units and their 4U gate columns. Its slice of the fused weights
// [W_ih; W_hh] (4U rows of K = D + H bf16, transposed so a gate column is
// contiguous) is loaded into shared memory once and stays there for the
// whole sequence. Each step the block stages [x_t, h_{t-1}] for its rows
// in shared memory (h_{t-1} read from the bf16 outputs through L2), every
// warp reduces whole dot products with lanes walking K in bf16 pairs, the
// cell update writes h_t, and a grid barrier publishes h_t to every block.
// Bounded on an H100 by the per-step barrier and L2 latency, not by bytes
// or FLOPs: the weights are read from device memory once per launch.
//
// Residual mode (training): with g_res / c_res set, each step also stores
// the f32 pre-activation gates rounded to bf16 and c_{t-1} rounded to bf16,
// in natural time, which is what the TPU kernels store with
// save_residuals=True and what the reverse kernel (lstm_bwd.cuh) reads.
#pragma once

#include <algorithm>

#include "common.cuh"

namespace mstts {

constexpr int kLstmThreads = 256;

struct LstmArgs {
  int T;      // time steps
  int B;      // rows in this launch
  int Bs;     // row stride of the time-major tensors (the full batch)
  int D;      // fused input width (0: gates precomputed in gx)
  int H;      // hidden units per direction
  int U;      // hidden units per block
  int nblk;   // blocks per direction
  const __nv_bfloat16* x;      // (T, Bs, D) when D > 0
  const __nv_bfloat16* gx[2];  // (T, Bs, 4H) hoisted gates + bias when D == 0
  const __nv_bfloat16* w[2];   // (4H, D + H): row n = [W_ih[:, n]; W_hh[:, n]]
  const float* bias[2];        // (4H) when D > 0
  __nv_bfloat16* ys[2];        // (T, Bs, H), natural time for both directions
  float* h_last;               // (Bs, H) direction 0 final h, or null
  float* c_last;               // (Bs, H) direction 0 final c, or null
  __nv_bfloat16* g_res[2];     // (T, Bs, 4H) pre-activation gates, or null
  __nv_bfloat16* c_res[2];     // (T, Bs, H) cell state before the step, or null
  unsigned int* bar;           // the grid barrier's arrival counter, zeroed by the wrapper
  unsigned int epoch0;         // arrivals counted by this call's earlier launches
};

__host__ __device__ inline size_t lstm_smem_bytes(int U, int K, int B) {
  return sizeof(__nv_bfloat16) * ((size_t)4 * U * K + (size_t)B * K) +
         sizeof(float) * ((size_t)B * 4 * U + (size_t)B * U);
}

__global__ void __launch_bounds__(kLstmThreads) lstm_persistent_kernel(LstmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int K = a.D + a.H;
  const int K8 = K / 8, D8 = a.D / 8;
  const int dir = blockIdx.x / a.nblk;
  const int u0 = (blockIdx.x % a.nblk) * a.U;
  const int U = min(a.U, a.H - u0);  // units owned (the last block may own fewer)
  const int R = 4 * U;               // gate rows owned
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [4*a.U][K]
  __nv_bfloat16* xh_s = w_s + (size_t)4 * a.U * K;                   // [B][K]
  float* g_s = reinterpret_cast<float*>(xh_s + (size_t)a.B * K);     // [B][4*a.U]
  float* c_s = g_s + (size_t)a.B * 4 * a.U;                          // [B][a.U]

  // Resident weight slice: local row r = g*U + u <- global row g*H + u0 + u.
  for (int i = threadIdx.x; i < R * K8; i += kLstmThreads) {
    const int r = i / K8, k8 = i - r * K8;
    const int g = r / U, u = r - g * U;
    const uint4* src = reinterpret_cast<const uint4*>(a.w[dir] + (size_t)(g * a.H + u0 + u) * K);
    reinterpret_cast<uint4*>(w_s + (size_t)r * K)[k8] = __ldg(src + k8);
  }
  for (int i = threadIdx.x; i < a.B * a.U; i += kLstmThreads) c_s[i] = 0.0f;
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarp = kLstmThreads / 32;
  unsigned int epoch = a.epoch0;  // of the grid barrier
  for (int s = 0; s < a.T; ++s) {
    const int t = dir == 0 ? s : a.T - 1 - s;   // natural time of this step
    const int tp = dir == 0 ? t - 1 : t + 1;    // natural time of h_{prev}
    for (int i = threadIdx.x; i < a.B * K8; i += kLstmThreads) {
      const int b = i / K8, k8 = i - b * K8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k8 < D8) {
        v = __ldg(reinterpret_cast<const uint4*>(a.x + ((size_t)t * a.Bs + b) * a.D) + k8);
      } else if (s > 0) {
        // Written by other blocks this launch: read through L2, never L1.
        v = __ldcg(reinterpret_cast<const uint4*>(a.ys[dir] + ((size_t)tp * a.Bs + b) * a.H) +
                   (k8 - D8));
      }
      reinterpret_cast<uint4*>(xh_s + (size_t)b * K)[k8] = v;
    }
    __syncthreads();

    for (int o = warp; o < a.B * R; o += nwarp) {
      const int b = o / R, r = o - b * R;
      const __nv_bfloat162* wr = reinterpret_cast<const __nv_bfloat162*>(w_s + (size_t)r * K);
      const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(xh_s + (size_t)b * K);
      float acc = 0.0f;
      for (int k2 = lane; k2 < K / 2; k2 += 32) {
        const float2 wf = __bfloat1622float2(wr[k2]);
        const float2 xf = __bfloat1622float2(xr[k2]);
        acc = fmaf(wf.x, xf.x, acc);
        acc = fmaf(wf.y, xf.y, acc);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) {
        const int g = r / U, u = r - g * U;
        const int col = g * a.H + u0 + u;
        const float pre = a.D > 0
            ? a.bias[dir][col]
            : __bfloat162float(a.gx[dir][((size_t)t * a.Bs + b) * 4 * a.H + col]);
        g_s[b * 4 * a.U + r] = acc + pre;
      }
    }
    __syncthreads();

    for (int i = threadIdx.x; i < a.B * U; i += kLstmThreads) {
      const int b = i / U, u = i - b * U;
      const float* gb = g_s + b * 4 * a.U;
      const float ig = mstts_sigmoid(gb[u]);
      const float fg = mstts_sigmoid(gb[U + u]);
      const float gg = tanhf(gb[2 * U + u]);
      const float og = mstts_sigmoid(gb[3 * U + u]);
      const float c_prev = c_s[b * a.U + u];
      const float c = fg * c_prev + ig * gg;
      const float h = og * tanhf(c);
      c_s[b * a.U + u] = c;
      const size_t row = (size_t)t * a.Bs + b;
      a.ys[dir][row * a.H + u0 + u] = __float2bfloat16(h);
      if (a.g_res[dir] != nullptr) {
        __nv_bfloat16* gr = a.g_res[dir] + row * 4 * a.H + u0 + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) gr[(size_t)g * a.H] = __float2bfloat16(gb[g * U + u]);
        a.c_res[dir][row * a.H + u0 + u] = __float2bfloat16(c_prev);
      }
      if (s == a.T - 1 && dir == 0 && a.h_last != nullptr) {
        a.h_last[(size_t)b * a.H + u0 + u] = h;
        a.c_last[(size_t)b * a.H + u0 + u] = c;
      }
    }
    if (s + 1 < a.T) mstts_grid_barrier(a.bar, epoch);
  }
}

// Runs the recurrence for all rows, in launches of as many rows as shared
// memory holds. `a` arrives with its pointers at row 0 and a.B = a.Bs.
inline int lstm_run(LstmArgs a, int ndir, cudaStream_t stream) {
  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  const int K = a.D + a.H;
  if (a.D % 8 != 0 || a.H % 8 != 0 || a.T < 1) return (int)cudaErrorInvalidValue;
  // One block per SM at most: every block must be co-resident for the
  // grid barrier, and fewer units per block means more parallel blocks.
  a.U = (ndir * a.H + nsm - 1) / nsm;
  a.nblk = (a.H + a.U - 1) / a.U;
  int rows = a.Bs;
  while (rows > 1 && lstm_smem_bytes(a.U, K, rows) > (size_t)max_smem) rows = (rows + 1) / 2;
  const size_t smem_max_rows = lstm_smem_bytes(a.U, K, rows);
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
                                            params, lstm_smem_bytes(a.U, K, c.B), stream));
  }
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace mstts
