// CBHG-head BiGRU backward: both directions' reverse recurrences and every
// batch row in one launch, no grid barrier.
//
// Replaces multi_speaker_tts_tpu/ops/birnn_pallas.py::_bigru_vjp_bwd
// (kernel body _bigru_bwd_kernel). From the forward's residuals per
// direction -- the hoisted input gates gx, gh = bf16(h).W_hh + b_hh and
// h_{t-1}, all bf16 in natural time (bigru.cu's residual mode) -- and the
// f32 output cotangents, it emits per direction the gate gradients
//   dGx = [dr, dz, dn],  dGh = [dr, dz, dn * r]      (T, B, 3H) bf16
// with r, z, n recomputed in f32 from the residuals, and carries
//   dh_{t-1} = dh * z + bf16(dGh) . W_hh^T
// in f32, as the TPU kernel does. The forward direction walks time in
// reverse and the backward direction natural time. dW_ih, dW_hh, db_ih,
// db_hh and dx are whole-sequence GEMMs and sums of the caller.
//
// Design (bigru.cu's, reversed): one direction's W_hh^T (384 x 128 bf16 =
// 96 KB at production width) fits one block's shared memory and batch rows
// never interact, so each (direction, row) is one block of 3H threads that
// loops over all T steps with block barriers only. A step: threads u < H
// compute unit u's derivative and store dGx, dGh; then thread j of the 3H
// sums a third of the product for unit j % H (W_hh^T stored (3H, H) so a
// warp reads consecutive units of one row); threads u < H add the three
// partial sums to dh * z.
//
// Bound on an H100: T dependent steps of a 128-deep partial product and
// two block barriers each; the bytes (residuals, cotangents and dG, ~33 MB
// at T = 132, B = 32) and FLOPs are far below it, and 2 * B of the 132 SMs
// work.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(1024)
bigru_bwd_kernel(const __nv_bfloat16* __restrict__ gxf, const __nv_bfloat16* __restrict__ ghf,
                 const __nv_bfloat16* __restrict__ hpf, const __nv_bfloat16* __restrict__ gxb,
                 const __nv_bfloat16* __restrict__ ghb, const __nv_bfloat16* __restrict__ hpb,
                 const __nv_bfloat16* __restrict__ wtf, const __nv_bfloat16* __restrict__ wtb,
                 const float* __restrict__ dyf, const float* __restrict__ dyb,
                 __nv_bfloat16* __restrict__ dgxf, __nv_bfloat16* __restrict__ dghf,
                 __nv_bfloat16* __restrict__ dgxb, __nv_bfloat16* __restrict__ dghb,
                 int T, int B, int H) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H3 = 3 * H;
  const int dir = blockIdx.x / B, b = blockIdx.x % B;
  const int j = threadIdx.x;
  const __nv_bfloat16* gx = dir == 0 ? gxf : gxb;
  const __nv_bfloat16* gh = dir == 0 ? ghf : ghb;
  const __nv_bfloat16* hp = dir == 0 ? hpf : hpb;
  const __nv_bfloat16* wt = dir == 0 ? wtf : wtb;
  const float* dy = dir == 0 ? dyf : dyb;
  __nv_bfloat16* dgx = dir == 0 ? dgxf : dgxb;
  __nv_bfloat16* dgh = dir == 0 ? dghf : dghb;

  __nv_bfloat16* wt_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [3H][H] = W_hh^T
  float* dgh_s = reinterpret_cast<float*>(wt_s + (size_t)H3 * H);      // [3H] bf16(dGh), as f32
  float* part_s = dgh_s + H3;                                          // [3][H] partial sums

  for (int i = j; i < H3 * H / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(wt_s)[i] = __ldg(reinterpret_cast<const uint4*>(wt) + i);
  __syncthreads();

  const int q = j / H, uq = j - q * H;  // this thread's third of the product
  float dh_carry = 0.0f;                // unit j's dh, threads j < H
  float z_keep = 0.0f;
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? T - 1 - s : s;
    const size_t row = (size_t)t * B + b;
    if (j < H) {
      const float dh = dh_carry + dy[row * H + j];
      const __nv_bfloat16* gxr = gx + row * H3;
      const __nv_bfloat16* ghr = gh + row * H3;
      const float ghn = __bfloat162float(ghr[2 * H + j]);
      const float r = mstts_sigmoid(__bfloat162float(gxr[j]) + __bfloat162float(ghr[j]));
      const float z = mstts_sigmoid(__bfloat162float(gxr[H + j]) + __bfloat162float(ghr[H + j]));
      const float n = tanhf(__bfloat162float(gxr[2 * H + j]) + r * ghn);
      const float h_prev = __bfloat162float(hp[row * H + j]);
      const float dz = dh * (h_prev - n) * z * (1.0f - z);
      const float dn = dh * (1.0f - z) * (1.0f - n * n);
      const float dr = dn * ghn * r * (1.0f - r);
      const __nv_bfloat16 bdr = __float2bfloat16(dr), bdz = __float2bfloat16(dz);
      const __nv_bfloat16 bdhn = __float2bfloat16(dn * r);
      __nv_bfloat16* ox = dgx + row * H3;
      __nv_bfloat16* oh = dgh + row * H3;
      ox[j] = bdr;
      ox[H + j] = bdz;
      ox[2 * H + j] = __float2bfloat16(dn);
      oh[j] = bdr;
      oh[H + j] = bdz;
      oh[2 * H + j] = bdhn;
      dgh_s[j] = __bfloat162float(bdr);
      dgh_s[H + j] = __bfloat162float(bdz);
      dgh_s[2 * H + j] = __bfloat162float(bdhn);
      dh_carry = dh;
      z_keep = z;
    }
    if (s + 1 == T) break;
    __syncthreads();
    // Partial product over gate columns [q*H, (q+1)*H) for unit uq.
    {
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      const __nv_bfloat16* wc = wt_s + (size_t)q * H * H + uq;
      const float* dg = dgh_s + q * H;
#pragma unroll 4
      for (int k = 0; k < H; k += 4) {
        a0 = fmaf(dg[k], __bfloat162float(wc[(size_t)k * H]), a0);
        a1 = fmaf(dg[k + 1], __bfloat162float(wc[(size_t)(k + 1) * H]), a1);
        a2 = fmaf(dg[k + 2], __bfloat162float(wc[(size_t)(k + 2) * H]), a2);
        a3 = fmaf(dg[k + 3], __bfloat162float(wc[(size_t)(k + 3) * H]), a3);
      }
      part_s[q * H + uq] = (a0 + a1) + (a2 + a3);
    }
    __syncthreads();
    if (j < H) dh_carry = dh_carry * z_keep + ((part_s[j] + part_s[H + j]) + part_s[2 * H + j]);
  }
}

}  // namespace

MSTTS_EXPORT int mstts_bigru_bwd(const void* gxf, const void* ghf, const void* hpf,
                                 const void* gxb, const void* ghb, const void* hpb,
                                 const void* wtf, const void* wtb, const void* dyf,
                                 const void* dyb, void* dgxf, void* dghf, void* dgxb,
                                 void* dghb, int T, int B, int H, void* stream) {
  int dev = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  const size_t smem = sizeof(__nv_bfloat16) * (size_t)3 * H * H + sizeof(float) * 6 * (size_t)H;
  if (H % 8 != 0 || 3 * H > 1024 || T < 1 || B < 1 || smem > (size_t)max_smem)
    return (int)cudaErrorInvalidValue;
  MSTTS_CHECK(cudaFuncSetAttribute(bigru_bwd_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  using bf = __nv_bfloat16;
  bigru_bwd_kernel<<<2 * B, 3 * H, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(gxf), static_cast<const bf*>(ghf), static_cast<const bf*>(hpf),
      static_cast<const bf*>(gxb), static_cast<const bf*>(ghb), static_cast<const bf*>(hpb),
      static_cast<const bf*>(wtf), static_cast<const bf*>(wtb), static_cast<const float*>(dyf),
      static_cast<const float*>(dyb), static_cast<bf*>(dgxf), static_cast<bf*>(dghf),
      static_cast<bf*>(dgxb), static_cast<bf*>(dghb), T, B, H);
  MSTTS_RETURN_LAUNCH_ERROR();
}
