// Persistent reverse LSTM recurrence: one cooperative launch runs every
// time step of the backward pass and emits the pre-activation gate
// gradients dG (T, B, 4H) bf16, nothing else.
//
// Shared by lstm_bwd.cu (GE2E layer, one direction) and bilstm_bwd.cu
// (text-encoder BiLSTM, both directions in one launch). It reverses the
// forward kernels of lstm_persistent.cuh from their residuals: the
// pre-activation gates and c_{t-1}, both bf16 in natural time.
//
// Numerics follow the TPU kernels (lstm_pallas.py::_bwd_kernel,
// birnn_pallas.py::_bilstm_bwd_kernel): the cell derivative is f32 from
// the bf16 residuals (c_t recomputed from c_{t-1}), the carries dh and dc
// are f32, dG is rounded to bf16 on store, and the carried
// dh_{t-1} = bf16(dG_t) . W_hh^T is a bf16 product with f32 accumulation.
//
// Design (the forward kernel's, reversed): W_hh^T for one GE2E layer is
// 4.7 MB of bf16, which no SM holds, so block j of direction d owns U of
// the H units. It keeps rows u0..u0+U of W_hh (H, 4H) -- the columns of
// W_hh^T that produce its units of dh_{t-1} -- in shared memory for the
// launch, together with its units' f32 carries dh and dc. A step:
//   1. the cell derivative of the block's units (all rows), dG_t stored;
//   2. the counter grid barrier of common.cuh (dG_t complete everywhere);
//   3. dh_{t-1}[b, u] = sum_n dG_t[b, n] W_hh[u, n] for the block's units:
//      one warp per batch row loads that row of dG_t from L2 into
//      registers at once (16 bytes a load, up to 16 loads a lane) and keeps
//      one f32 sum per owned unit.
// Direction 0 walks time in reverse; direction 1 (the BiLSTM's backward
// direction, which ran t = T-1 .. 0) walks natural time. The last step
// needs no product and no barrier.
//
// Bound on an H100: T steps of one grid barrier and one L2 round trip of
// dG_t; the bytes (residuals, dG, W_hh once) and the 2*T*B*4H*H FLOPs are
// far below it.
#pragma once

#include "common.cuh"

namespace mstts {

constexpr int kLstmBwdThreads = 256;
constexpr int kLstmBwdMaxU = 8;  // units summed at once (one f32 sum each per lane)
constexpr int kLstmBwdMaxLoads = 16;  // 16-byte loads of a dG row a lane holds: 4H <= 4096

struct LstmBwdArgs {
  int T;       // time steps
  int B;       // batch rows
  int H;       // hidden units per direction
  int U;       // hidden units per block
  int nblk;    // blocks per direction
  const __nv_bfloat16* gates[2];  // (T, B, 4H) pre-activation gates
  const __nv_bfloat16* c_prev[2]; // (T, B, H) cell state before each step
  const __nv_bfloat16* w[2];      // (H, 4H) W_hh: row k holds the 4H gate columns of unit k
  const float* d_hT;              // (B, H) direction 0's final-h cotangent, or null (zero)
  const float* d_ys[2];           // (T, B, H) per-step output cotangents, or null
  __nv_bfloat16* dG[2];           // (T, B, 4H) out
  unsigned int* bar;              // the grid barrier's arrival counter, zeroed by the wrapper
};

__host__ __device__ inline size_t lstm_bwd_smem_bytes(int U, int H, int B) {
  return sizeof(__nv_bfloat16) * (size_t)U * 4 * H + sizeof(float) * 2 * (size_t)B * U;
}

__device__ __forceinline__ void bf16x8_to_f32(const uint4 v, float* f) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(p[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__global__ void __launch_bounds__(kLstmBwdThreads) lstm_bwd_kernel(LstmBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H4 = 4 * a.H, K8 = H4 / 8;
  const int dir = blockIdx.x / a.nblk;
  const int u0 = (blockIdx.x % a.nblk) * a.U;
  const int U = min(a.U, a.H - u0);  // units owned (the last block may own fewer)
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [a.U][4H]
  float* dh_s = reinterpret_cast<float*>(w_s + (size_t)a.U * H4);  // [B][a.U]
  float* dc_s = dh_s + (size_t)a.B * a.U;                           // [B][a.U]

  for (int i = threadIdx.x; i < U * K8; i += kLstmBwdThreads) {
    const int u = i / K8, k8 = i - u * K8;
    reinterpret_cast<uint4*>(w_s + (size_t)u * H4)[k8] =
        __ldg(reinterpret_cast<const uint4*>(a.w[dir] + (size_t)(u0 + u) * H4) + k8);
  }
  for (int i = threadIdx.x; i < a.B * U; i += kLstmBwdThreads) {
    const int b = i / U, u = i - b * U;
    dh_s[b * a.U + u] =
        (dir == 0 && a.d_hT != nullptr) ? a.d_hT[(size_t)b * a.H + u0 + u] : 0.0f;
    dc_s[b * a.U + u] = 0.0f;
  }
  __syncthreads();

  const __nv_bfloat16* gates = a.gates[dir];
  const __nv_bfloat16* c_prev = a.c_prev[dir];
  const float* d_ys = a.d_ys[dir];
  __nv_bfloat16* dG = a.dG[dir];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarp = kLstmBwdThreads / 32;
  unsigned int epoch = 0;  // of the grid barrier
  for (int s = 0; s < a.T; ++s) {
    const int t = dir == 0 ? a.T - 1 - s : s;
    // 1. Cell derivative of the owned units.
    for (int i = threadIdx.x; i < a.B * U; i += kLstmBwdThreads) {
      const int b = i / U, u = i - b * U;
      const size_t row = (size_t)t * a.B + b;
      float dh = dh_s[b * a.U + u];
      if (d_ys != nullptr) dh += d_ys[row * a.H + u0 + u];
      const __nv_bfloat16* g = gates + row * H4 + u0 + u;
      const float ig = mstts_sigmoid(__bfloat162float(g[0]));
      const float fg = mstts_sigmoid(__bfloat162float(g[a.H]));
      const float gg = tanhf(__bfloat162float(g[2 * a.H]));
      const float og = mstts_sigmoid(__bfloat162float(g[3 * a.H]));
      const float cp = __bfloat162float(c_prev[row * a.H + u0 + u]);
      const float tc = tanhf(fg * cp + ig * gg);
      const float d_o = dh * tc * og * (1.0f - og);
      const float dc = dc_s[b * a.U + u] + dh * og * (1.0f - tc * tc);
      __nv_bfloat16* out = dG + row * H4 + u0 + u;
      out[0] = __float2bfloat16(dc * gg * ig * (1.0f - ig));
      out[a.H] = __float2bfloat16(dc * cp * fg * (1.0f - fg));
      out[2 * a.H] = __float2bfloat16(dc * ig * (1.0f - gg * gg));
      out[3 * a.H] = __float2bfloat16(d_o);
      dc_s[b * a.U + u] = dc * fg;
    }
    if (s + 1 == a.T) break;
    // 2. dG_t is complete in every block.
    mstts_grid_barrier(a.bar, epoch);
    // 3. dh_{t-1} of the owned units, one batch row per warp. The lane's
    // share of the row (K8 / 32 loads of 16 bytes) goes to registers
    // first, so its L2 round trips overlap instead of running one by one.
    for (int b = warp; b < a.B; b += nwarp) {
      // Written by other blocks this launch: read through L2, never L1.
      const uint4* drow = reinterpret_cast<const uint4*>(dG + ((size_t)t * a.B + b) * H4);
      uint4 dv[kLstmBwdMaxLoads];
#pragma unroll
      for (int it = 0; it < kLstmBwdMaxLoads; ++it) {
        const int k8 = lane + 32 * it;
        if (k8 < K8) dv[it] = __ldcg(drow + k8);
      }
      for (int ug = 0; ug < U; ug += kLstmBwdMaxU) {
        float acc[kLstmBwdMaxU];
#pragma unroll
        for (int j = 0; j < kLstmBwdMaxU; ++j) acc[j] = 0.0f;
#pragma unroll
        for (int it = 0; it < kLstmBwdMaxLoads; ++it) {
          const int k8 = lane + 32 * it;
          if (k8 < K8) {
            float d[8];
            bf16x8_to_f32(dv[it], d);
#pragma unroll
            for (int j = 0; j < kLstmBwdMaxU; ++j) {
              if (ug + j < U) {
                float wv[8];
                const uint4* wrow = reinterpret_cast<const uint4*>(w_s + (size_t)(ug + j) * H4);
                bf16x8_to_f32(wrow[k8], wv);
#pragma unroll
                for (int e = 0; e < 8; ++e) acc[j] = fmaf(d[e], wv[e], acc[j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < kLstmBwdMaxU; ++j) {
          float v = acc[j];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
          if (lane == 0 && ug + j < U) dh_s[b * a.U + ug + j] = v;
        }
      }
    }
    __syncthreads();
  }
}

// Runs the reverse recurrence of ndir directions in one cooperative launch.
inline int lstm_bwd_run(LstmBwdArgs a, int ndir, cudaStream_t stream) {
  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (a.H % 8 != 0 || a.T < 1 || a.B < 1 || 4 * a.H > 8 * 32 * kLstmBwdMaxLoads)
    return (int)cudaErrorInvalidValue;
  // One block per SM at most: every block must be co-resident for the
  // grid barrier, and fewer units per block means more parallel blocks.
  a.U = (ndir * a.H + nsm - 1) / nsm;
  a.nblk = (a.H + a.U - 1) / a.U;
  const size_t smem = lstm_bwd_smem_bytes(a.U, a.H, a.B);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  MSTTS_CHECK(cudaFuncSetAttribute(lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem));
  void* params[] = {&a};
  MSTTS_CHECK(cudaLaunchCooperativeKernel((const void*)lstm_bwd_kernel, dim3(ndir * a.nblk),
                                          dim3(kLstmBwdThreads), params, smem, stream));
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace mstts
