// Sequential floors of the recurrent kernels: the least time their T
// dependent steps take on the card with their design, whatever the rest of
// a step's arithmetic. Replaces no TPU kernel: chip_smoke.py times these
// beside the kernels (their rows' floor_ms).
//
// mstts_barrier_floor: `rounds` rounds of the persistent kernels' grid
// barrier on a grid of blocks of `threads` threads (256 where it is 0),
// with no arithmetic and no memory traffic besides the barrier's own. The
// grid is the recurrences' (the LSTM and BiLSTM kernels, common.cuh's
// mstts_recurrence_grid) or, with blocks > 0, that many blocks (the
// Griffin-Lim kernels' grids, griffin_lim.cu and griffin_lim_dense.cu, and
// the decode segment's 512-thread grid, decode.cu).
//
// mstts_gru_chain_floor: the BiGRU forward's (bigru.cu) grid and blocks,
// running T steps of only its dependent chain: the recurrent product of
// bigru_step.cuh (ldmatrix of h_{t-1}, the MMAs into four accumulators a
// gate), the accumulators' fixed-order sum, the bf16 store of h_t and the
// step's one __syncthreads. No input gates, no cell, no outputs.
//
// mstts_gru_bwd_chain_floor: the same for the BiGRU backward (bigru_bwd.cu):
// T steps of ldmatrix of bf16(dGh), the K = 3H MMAs of bigru_step.cuh's
// backward product, the accumulators' fixed-order sum, the bf16 stores of
// dGh and the block barrier. No residuals, no cell, no outputs.
#include "bigru_step.cuh"

__global__ void __launch_bounds__(1024, 1) mstts_barrier_floor_kernel(unsigned int* bar,
                                                                      int rounds) {
  unsigned int epoch = 0;
  for (int r = 0; r < rounds; ++r) mstts_grid_barrier(bar, epoch);
}

// blocks_out (host) receives the grid size, so that a caller can check the
// counter: rounds * blocks arrivals.
MSTTS_EXPORT int mstts_barrier_floor(void* bar, int rounds, int ndir, int H, int blocks,
                                     int threads, void* blocks_out, void* stream) {
  if (rounds < 0 || ndir < 1 || H < 1 || blocks < 0 || threads < 0 || threads > 1024 ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  int grid = blocks;
  if (grid == 0) {
    int U = 0, nblk = 0;
    MSTTS_CHECK(mstts_recurrence_grid(ndir, H, &U, &nblk));
    grid = ndir * nblk;
  }
  *static_cast<int*>(blocks_out) = grid;
  unsigned int* counter = static_cast<unsigned int*>(bar);
  void* params[] = {&counter, &rounds};
  MSTTS_CHECK(cudaLaunchCooperativeKernel((const void*)mstts_barrier_floor_kernel,
                                          dim3(grid), dim3(threads ? threads : 256), params, 0,
                                          static_cast<cudaStream_t>(stream)));
  MSTTS_RETURN_LAUNCH_ERROR();
}

namespace {

template <int KS>
__global__ void __launch_bounds__(32 * KS, 1) gru_chain_floor_kernel(const __nv_bfloat16* wt,
                                                                     int T) {
  constexpr int H = 16 * KS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int HS = mstts_ldmatrix_stride(H);
  __nv_bfloat16* h_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kGruRows][HS]
  __nv_bfloat16* w_s = h_s + 2 * kGruRows * HS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u0 = 16 * warp + (lane >> 2), tq = lane & 3;
  for (int i = threadIdx.x; i < 2 * kGruRows * HS / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(h_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  GruProduct<KS> product;
  product.load(wt, w_s);
  __syncthreads();
  for (int s = 0; s < T; ++s) {
    const int cur = s & 1;
    float acc[3][4][4] = {};
    product.run(acc, h_s + cur * kGruRows * HS + (lane & 7) * HS + ((lane >> 3) & 1) * 8);
    __nv_bfloat16* h_next = h_s + (cur ^ 1) * kGruRows * HS;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        v += (acc[q][0][e] + acc[q][1][e]) + (acc[q][2][e] + acc[q][3][e]);
      h_next[(2 * tq + (e & 1)) * HS + u0 + 8 * (e >> 1)] = __float2bfloat16(v);
    }
    __syncthreads();
  }
}

template <int KS>
__global__ void __launch_bounds__(32 * KS, 1) gru_bwd_chain_floor_kernel(const __nv_bfloat16* w,
                                                                         int T) {
  constexpr int H = 16 * KS, GS = mstts_ldmatrix_stride(3 * H);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* g_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][kGruRows][GS]
  __nv_bfloat16* w_s = g_s + 2 * kGruRows * GS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int u0 = 16 * warp + (lane >> 2), tq = lane & 3;
  for (int i = threadIdx.x; i < 2 * kGruRows * GS / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(g_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  GruProduct<KS, true> product;
  product.load(w, w_s);
  __syncthreads();
  for (int s = 0; s < T; ++s) {
    const int cur = s & 1;
    float acc[3][4][4] = {};
    product.run(acc, g_s + cur * kGruRows * GS + (lane & 7) * GS + (lane >> 3) * 8);
    __nv_bfloat16* g_next = g_s + (cur ^ 1) * kGruRows * GS;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = 0.0f;
#pragma unroll
      for (int q = 0; q < 3; ++q)
        v += (acc[q][0][e] + acc[q][1][e]) + (acc[q][2][e] + acc[q][3][e]);
      const __nv_bfloat16 b = __float2bfloat16(v);
#pragma unroll
      for (int q = 0; q < 3; ++q) g_next[(2 * tq + (e & 1)) * GS + q * H + u0 + 8 * (e >> 1)] = b;
    }
    __syncthreads();
  }
}

template <int KS>
int launch_gru_floor(const __nv_bfloat16* w, int T, int blocks, bool bwd, cudaStream_t stream) {
  constexpr int H = 16 * KS;
  if (bwd) {
    const size_t smem = sizeof(__nv_bfloat16) *
                        (2 * kGruRows * (size_t)mstts_ldmatrix_stride(3 * H) +
                         gru_wsmem_elems(H, true));
    MSTTS_CHECK(cudaFuncSetAttribute(gru_bwd_chain_floor_kernel<KS>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
    gru_bwd_chain_floor_kernel<KS><<<blocks, 32 * KS, smem, stream>>>(w, T);
    MSTTS_RETURN_LAUNCH_ERROR();
  }
  const size_t smem = sizeof(__nv_bfloat16) *
                      (2 * kGruRows * (size_t)mstts_ldmatrix_stride(H) + gru_wsmem_elems(H));
  MSTTS_CHECK(cudaFuncSetAttribute(gru_chain_floor_kernel<KS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  gru_chain_floor_kernel<KS><<<blocks, 32 * KS, smem, stream>>>(w, T);
  MSTTS_RETURN_LAUNCH_ERROR();
}

int gru_floor(const void* w, int T, int B, int H, bool bwd, void* blocks_out, void* stream) {
  if (H % 16 != 0 || H < 16 || H > 192 || T < 0 || B < 1) return (int)cudaErrorInvalidValue;
  const int blocks = 2 * ((B + kGruRows - 1) / kGruRows);
  *static_cast<int*>(blocks_out) = blocks;
  const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / 16) {
    case 1: return launch_gru_floor<1>(wb, T, blocks, bwd, st);
    case 2: return launch_gru_floor<2>(wb, T, blocks, bwd, st);
    case 3: return launch_gru_floor<3>(wb, T, blocks, bwd, st);
    case 4: return launch_gru_floor<4>(wb, T, blocks, bwd, st);
    case 5: return launch_gru_floor<5>(wb, T, blocks, bwd, st);
    case 6: return launch_gru_floor<6>(wb, T, blocks, bwd, st);
    case 7: return launch_gru_floor<7>(wb, T, blocks, bwd, st);
    case 8: return launch_gru_floor<8>(wb, T, blocks, bwd, st);
    case 9: return launch_gru_floor<9>(wb, T, blocks, bwd, st);
    case 10: return launch_gru_floor<10>(wb, T, blocks, bwd, st);
    case 11: return launch_gru_floor<11>(wb, T, blocks, bwd, st);
    default: return launch_gru_floor<12>(wb, T, blocks, bwd, st);
  }
}

}  // namespace

// wt: (3H, H) bf16, W_hh transposed as the BiGRU takes it (its values do
// not change the time). B batch rows: the BiGRU's grid, 2 x ceil(B / 8)
// blocks, whose count blocks_out (host) receives.
MSTTS_EXPORT int mstts_gru_chain_floor(const void* wt, int T, int B, int H, void* blocks_out,
                                       void* stream) {
  return gru_floor(wt, T, B, H, false, blocks_out, stream);
}

// w: (H, 3H) bf16, W_hh as the BiGRU backward takes it; the same grid.
MSTTS_EXPORT int mstts_gru_bwd_chain_floor(const void* w, int T, int B, int H, void* blocks_out,
                                           void* stream) {
  return gru_floor(w, T, B, H, true, blocks_out, stream);
}
