// CBHG-head BiGRU recurrence: both directions and every batch row in one
// launch, no grid barrier.
//
// Replaces multi_speaker_tts_tpu/ops/birnn_pallas.py::_bigru_fwd_impl
// (kernel body _bigru_fwd_kernel, reached through bigru_pallas). As on the
// TPU, the input gates x . W_ih + b_ih of both directions are hoisted out by
// the caller (bf16, time-major); the kernel runs only the recurrence
//   gh = bf16(h) . W_hh + b_hh,  r = s(gx_r + gh_r),  z = s(gx_z + gh_z),
//   n = tanh(gx_n + r * gh_n),   h' = (1 - z) * n + z * h
// (torch gate order r, z, n; b_hn inside the reset product), with an f32
// carry and bf16 outputs, the forward direction walking t and the backward
// one T-1-t, both stored in natural time.
//
// Design: unlike the LSTMs (lstm_persistent.cuh), one direction's W_hh
// (128 x 384 bf16 = 96 KB at production width) fits one block's shared
// memory and batch rows never interact, so each (direction, row) is one
// independent block that loops over all T steps with __syncthreads only.
// Thread j owns gate column j: it walks the H rows of W_hh in shared memory
// (a warp reads 64 contiguous bytes per row, conflict-free) against h
// broadcast from shared memory, with four independent accumulators; the
// next step's input gate is prefetched from device memory during the
// product. The batch is not padded to the TPU's 8 rows.
//
// Bound on an H100: T dependent steps of one 128-deep dot product plus two
// block barriers each; the bytes (gates, 2 x 96 KB of weights, outputs) and
// FLOPs are tiny, and only 2 * B of the 132 SMs work.
//
// ghf / hpf / ghb / hpb non-null selects the residual mode of
// _bigru_fwd_impl(save_residuals=True): per direction gh = bf16(h).W_hh +
// b_hh (T, B, 3H) and h_{t-1} (T, B, H), bf16, in natural time, for the
// reverse kernel (bigru_bwd.cu).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
bigru_kernel(const __nv_bfloat16* __restrict__ gxf, const __nv_bfloat16* __restrict__ gxb,
             const __nv_bfloat16* __restrict__ whf, const __nv_bfloat16* __restrict__ whb,
             const float* __restrict__ bhf, const float* __restrict__ bhb,
             __nv_bfloat16* __restrict__ ysf, __nv_bfloat16* __restrict__ ysb,
             __nv_bfloat16* __restrict__ ghf, __nv_bfloat16* __restrict__ hpf,
             __nv_bfloat16* __restrict__ ghb, __nv_bfloat16* __restrict__ hpb,
             int T, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H3 = 3 * H;
  const int dir = blockIdx.x / B, b = blockIdx.x % B;
  const int j = threadIdx.x;  // gate column: [0, H) r, [H, 2H) z, [2H, 3H) n
  const __nv_bfloat16* gx = dir == 0 ? gxf : gxb;
  const __nv_bfloat16* w = dir == 0 ? whf : whb;
  __nv_bfloat16* ys = dir == 0 ? ysf : ysb;
  __nv_bfloat16* gh_res = dir == 0 ? ghf : ghb;  // null outside the residual mode
  __nv_bfloat16* hp_res = dir == 0 ? hpf : hpb;

  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [H][3H]
  float* hb_s = reinterpret_cast<float*>(w_s + (size_t)H * H3);     // [H] bf16(h), as f32
  float* h_s = hb_s + H;                                             // [H] f32 carry
  float* g_s = h_s + H;                                              // [2H] r and z

  for (int i = j; i < H * H3 / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(w_s)[i] = __ldg(reinterpret_cast<const uint4*>(w) + i);
  if (j < H) {
    hb_s[j] = 0.0f;
    h_s[j] = 0.0f;
  }
  const float bias = (dir == 0 ? bhf : bhb)[j];
  __syncthreads();

  const int t_first = dir == 0 ? 0 : T - 1;
  __nv_bfloat16 gx_next = gx[((size_t)t_first * B + b) * H3 + j];
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    const float gxv = __bfloat162float(gx_next);
    if (s + 1 < T) {
      const int tn = dir == 0 ? t + 1 : t - 1;
      gx_next = gx[((size_t)tn * B + b) * H3 + j];
    }
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
    const __nv_bfloat16* wc = w_s + j;
#pragma unroll 4
    for (int k = 0; k < H; k += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(hb_s + k);
      a0 = fmaf(hv.x, __bfloat162float(wc[(size_t)k * H3]), a0);
      a1 = fmaf(hv.y, __bfloat162float(wc[(size_t)(k + 1) * H3]), a1);
      a2 = fmaf(hv.z, __bfloat162float(wc[(size_t)(k + 2) * H3]), a2);
      a3 = fmaf(hv.w, __bfloat162float(wc[(size_t)(k + 3) * H3]), a3);
    }
    const float gh = (a0 + a1) + (a2 + a3) + bias;
    if (gh_res != nullptr) gh_res[((size_t)t * B + b) * H3 + j] = __float2bfloat16(gh);
    if (j < 2 * H) g_s[j] = mstts_sigmoid(gxv + gh);
    __syncthreads();
    if (j >= 2 * H) {
      const int u = j - 2 * H;
      const float r = g_s[u], z = g_s[H + u];
      const float n = tanhf(gxv + r * gh);
      const float h_prev = h_s[u];
      const float h = (1.0f - z) * n + z * h_prev;
      if (hp_res != nullptr) hp_res[((size_t)t * B + b) * H + u] = __float2bfloat16(h_prev);
      const __nv_bfloat16 hb = __float2bfloat16(h);
      h_s[u] = h;
      hb_s[u] = __bfloat162float(hb);
      ys[((size_t)t * B + b) * H + u] = hb;
    }
    __syncthreads();
  }
}

}  // namespace

MSTTS_EXPORT int mstts_bigru_fwd(const void* gxf, const void* gxb, const void* whf,
                                 const void* whb, const void* bhf, const void* bhb,
                                 void* ysf, void* ysb, void* ghf, void* hpf, void* ghb,
                                 void* hpb, int T, int B, int H, void* stream) {
  int dev = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)H * 3 * H + sizeof(float) * 4 * (size_t)H;
  if (H % 8 != 0 || 3 * H > 1024 || T < 1 || B < 1 || smem > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  const bool any = ghf || hpf || ghb || hpb, all = ghf && hpf && ghb && hpb;
  if (any && !all) return (int)cudaErrorInvalidValue;
  MSTTS_CHECK(cudaFuncSetAttribute(bigru_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem));
  bigru_kernel<<<2 * B, 3 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(gxf), static_cast<const __nv_bfloat16*>(gxb),
      static_cast<const __nv_bfloat16*>(whf), static_cast<const __nv_bfloat16*>(whb),
      static_cast<const float*>(bhf), static_cast<const float*>(bhb),
      static_cast<__nv_bfloat16*>(ysf), static_cast<__nv_bfloat16*>(ysb),
      static_cast<__nv_bfloat16*>(ghf), static_cast<__nv_bfloat16*>(hpf),
      static_cast<__nv_bfloat16*>(ghb), static_cast<__nv_bfloat16*>(hpb), T, B, H);
  MSTTS_RETURN_LAUNCH_ERROR();
}
