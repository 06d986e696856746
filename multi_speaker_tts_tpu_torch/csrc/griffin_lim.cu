// Staged (8-leaf) Griffin-Lim at n_fft = 1024.
//
// Replaces multi_speaker_tts_tpu/ops/griffin_lim_staged.py::griffin_lim_staged
// (kernel body _gl_staged_kernel). Same fixed-point map: zero-phase start,
// per-class 128 x 128 leaf products joined to the frame by an exact 8-point
// butterfly, classes 0-4 stored (640 lanes, Hermitian pruning), bf16 leaf
// operands with f32 accumulation, bf16 target magnitudes, window-square
// OLA normalisation over the uncropped rows, mag * rsqrt(|X|^2 + 1e-12)
// projection, centred crop.
//
// Momentum mode (the TPU kernel's body_m; pre / pim non-null): the
// accelerated iteration extrapolates each fresh spectrum X against the
// previous one P before the projection, X - beta P with beta = m / (1 + m),
// and stores X as the next P. P lives in two bf16 (B, T, 640) buffers, as
// the TPU kernel keeps its previous-projection carries in the magnitudes'
// dtype: the forward launch reads P and writes X in the same pass, one
// element per thread. The plain mode is a separate instantiation of the
// forward kernel and computes exactly what it computed before.
//
// Redesign for Hopper: the TPU kernel keeps an utterance's (T, 640) complex
// spectra resident in VMEM for all iterations (~2 MB at T = 400); an SM
// has 227 KB of shared memory. Here the spectra (re, im f32), the
// synthesised frames (f32) and the bf16 magnitudes live in device memory,
// where the 50 MB L2 holds them at serving sizes (the wrapper chunks the
// batch to keep it so), and each iteration is two launches over tiles of
// 16 frames of one utterance:
//   gl_inverse: spectra -> bf16 [re | im] operands -> tensor-core leaf
//     products (WMMA 16x16x16, bf16 in, f32 out) -> inverse butterfly ->
//     synthesis window -> frames;
//   gl_forward: overlap-add of the 4 frames covering each sample (the
//     rows of the signal), OLA normalisation, analysis window, forward
//     butterfly, bf16 operands, leaf products, projection -> spectra.
// Per frame and iteration that is 32 (128 x 128) leaf products, 1.05 MFLOP
// on the tensor cores. What bounds it on an H100: by bytes and FLOPs, the
// tensor-core FLOPs (B = 4, T = 128, 60 iterations: 32.5 GFLOP, 33 us at
// 989 TFLOP/s; its inputs and outputs are under 1 MB). In practice a call
// is 120 dependent launches, each moving the spectra and frames (~15 MB at
// that size) through L2, with one 16-frame tile per block.
#include <mma.h>

#include <algorithm>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kN = 1024;      // n_fft
constexpr int kL = 128;       // leaf length
constexpr int kG = 640;       // stored lanes: 5 classes x 128
constexpr int kF = 16;        // frames per block: one MMA row tile
constexpr int kThreads = 256; // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kLdA = 2 * kL + 8;  // bf16 operand row: [re | im] + pad
constexpr int kLdP = kL + 4;      // f32 plane row + pad
constexpr int kPlane = kF * kLdP;
constexpr float kR2 = 0.70710678118654752f;
constexpr size_t kSmemA = sizeof(bf16) * 5 * kF * kLdA;
constexpr size_t kSmemInverse = kSmemA + sizeof(float) * 8 * kPlane;
constexpr size_t kSmemForward = kSmemA + sizeof(float) * 10 * kPlane;

// C (16 x 16 f32, smem) = A (16 x 16*ktiles bf16, smem) x B (16*ktiles x
// 16 bf16, global, row stride kL).
__device__ __forceinline__ void mma_tile(const bf16* A, const bf16* Bm, int ktiles, float* C) {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.0f);
  for (int kt = 0; kt < ktiles; ++kt) {
    wmma::load_matrix_sync(a, A + kt * 16, kLdA);
    wmma::load_matrix_sync(b, Bm + (size_t)kt * 16 * kL, kL);
    wmma::mma_sync(acc, a, b, acc);
  }
  wmma::store_matrix_sync(C, acc, kLdP, wmma::mem_row_major);
}

// mats: (5 classes, 4, 256, 128) bf16 = [fwd_re, fwd_im, inv_re, inv_im].
__device__ __forceinline__ const bf16* leaf(const bf16* mats, int cls, int which) {
  return mats + (size_t)(cls * 4 + which) * 2 * kL * kL;
}

__global__ void __launch_bounds__(kThreads)
gl_inverse_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const bf16* __restrict__ mats, const float* __restrict__ syn,
                  float* __restrict__ frames, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* A = reinterpret_cast<bf16*>(smem);              // [5][kF][kLdA]
  float* P = reinterpret_cast<float*>(smem + kSmemA);   // [8][kF][kLdP]
  const int b = blockIdx.y, t0 = blockIdx.x * kF;

  for (int i = threadIdx.x; i < kF * kG; i += kThreads) {
    const int f = i / kG, lane = i - f * kG;
    const int g = lane / kL, m = lane - g * kL;
    float r = 0.0f, q = 0.0f;
    if (t0 + f < T) {
      const size_t o = ((size_t)b * T + t0 + f) * kG + lane;
      r = re[o];
      q = im[o];
    }
    bf16* row = A + (size_t)(g * kF + f) * kLdA;
    row[m] = __float2bfloat16(r);
    row[kL + m] = __float2bfloat16(q);
  }
  __syncthreads();

  // Planes: 0 u0, 1/2 u1 (re/im), 3/4 u2, 5/6 u3, 7 u4 (classes 0 and 4
  // are self-conjugate: their time-domain leaf is real).
  const int warp = threadIdx.x / 32;
  for (int task = warp; task < 8 * 8; task += kWarps) {
    const int plane = task / 8, nt = task % 8;
    const int cls = (plane + 1) / 2;
    const int which = (plane == 0 || plane == 7) ? 0 : (plane - 1) % 2;
    mma_tile(A + (size_t)cls * kF * kLdA, leaf(mats, cls, 2 + which) + nt * 16, 16,
             P + plane * kPlane + nt * 16);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kF * kL; i += kThreads) {
    const int f = i / kL, m = i - f * kL;
    if (t0 + f >= T) continue;
    const float* p = P + f * kLdP + m;
    const float u0 = p[0], Ur1 = p[kPlane], Ui1 = p[2 * kPlane], Ur2 = p[3 * kPlane];
    const float Ui2 = p[4 * kPlane], Ur3 = p[5 * kPlane], Ui3 = p[6 * kPlane];
    const float u4 = p[7 * kPlane];
    const float Pp = u0 + u4, Q = u0 - u4;
    const float E0 = Pp + Ur2, E1 = Q - Ui2, E2 = Pp - Ur2, E3 = Q + Ui2;
    const float g1 = (Ur1 - Ui1) * kR2, h1 = (Ur1 + Ui1) * kR2;
    const float g3 = (Ur3 - Ui3) * kR2, h3 = (Ur3 + Ui3) * kR2;
    const float O0 = Ur1 + Ur3, O1 = g1 - h3, O2 = Ui3 - Ui1, O3 = g3 - h1;
    const float x[8] = {E0 + O0, E1 + O1, E2 + O2, E3 + O3,
                        E0 - O0, E1 - O1, E2 - O2, E3 - O3};
    float* dst = frames + ((size_t)b * T + t0 + f) * kN + m;
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[j * kL] = x[j] * syn[j * kL + m];
  }
}

template <bool kMomentum>
__global__ void __launch_bounds__(kThreads)
gl_forward_kernel(const float* __restrict__ frames, const float* __restrict__ wsum,
                  const float* __restrict__ win, const bf16* __restrict__ mats,
                  const bf16* __restrict__ mag, float* __restrict__ re,
                  float* __restrict__ im, bf16* __restrict__ pre, bf16* __restrict__ pim,
                  float beta, int T, int hop) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* A = reinterpret_cast<bf16*>(smem);              // [5][kF][kLdA]
  float* X = reinterpret_cast<float*>(smem + kSmemA);   // [10][kF][kLdP]
  const int b = blockIdx.y, t0 = blockIdx.x * kF;
  const int k = kN / hop;

  // Signal rows = OLA of the synthesised frames; frame t, sample n reads
  // row t + n / hop. Blocks j = n / 128 land in planes 0..7.
  for (int i = threadIdx.x; i < kF * kN; i += kThreads) {
    const int f = i / kN, n = i - f * kN;
    const int t = t0 + f;
    float v = 0.0f;
    if (t < T) {
      const int row = t + n / hop, col = n % hop;
      float s = 0.0f;
      for (int q = 0; q < k; ++q) {
        const int tf = row - q;
        if (tf >= 0 && tf < T) s += frames[((size_t)b * T + tf) * kN + q * hop + col];
      }
      v = s * wsum[(size_t)row * hop + col] * win[n];
    }
    X[(n / kL) * kPlane + f * kLdP + (n % kL)] = v;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kF * kL; i += kThreads) {
    const int f = i / kL, m = i - f * kL;
    float x[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) x[j] = X[j * kPlane + f * kLdP + m];
    float s[4], d[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[j] = x[j] + x[j + 4];
      d[j] = x[j] - x[j + 4];
    }
    const float u0 = s[0] + s[2], u1 = s[1] + s[3];
    const float v0 = s[0] - s[2], v1 = s[1] - s[3];
    const float p = (d[1] - d[3]) * kR2, q = (d[1] + d[3]) * kR2;
    bf16* a0 = A + (size_t)(0 * kF + f) * kLdA;
    bf16* a1 = A + (size_t)(1 * kF + f) * kLdA;
    bf16* a2 = A + (size_t)(2 * kF + f) * kLdA;
    bf16* a3 = A + (size_t)(3 * kF + f) * kLdA;
    bf16* a4 = A + (size_t)(4 * kF + f) * kLdA;
    a0[m] = __float2bfloat16(u0 + u1);
    a1[m] = __float2bfloat16(d[0] + p);
    a1[kL + m] = __float2bfloat16(-q - d[2]);
    a2[m] = __float2bfloat16(v0);
    a2[kL + m] = __float2bfloat16(-v1);
    a3[m] = __float2bfloat16(d[0] - p);
    a3[kL + m] = __float2bfloat16(-q + d[2]);
    a4[m] = __float2bfloat16(u0 - u1);
  }
  __syncthreads();

  // Spectra planes 2c (re) and 2c+1 (im); the real z_0, z_4 use only the
  // first 128 rows of [M_re; -M_im] and [M_im; M_re].
  const int warp = threadIdx.x / 32;
  for (int task = warp; task < 10 * 8; task += kWarps) {
    const int plane = task / 8, nt = task % 8;
    const int cls = plane / 2, which = plane % 2;
    const int ktiles = (cls == 0 || cls == 4) ? 8 : 16;
    mma_tile(A + (size_t)cls * kF * kLdA, leaf(mats, cls, which) + nt * 16, ktiles,
             X + plane * kPlane + nt * 16);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kF * kG; i += kThreads) {
    const int f = i / kG, lane = i - f * kG;
    if (t0 + f >= T) continue;
    const int g = lane / kL, m = lane - g * kL;
    float r = X[(2 * g) * kPlane + f * kLdP + m];
    float q = X[(2 * g + 1) * kPlane + f * kLdP + m];
    const size_t o = ((size_t)b * T + t0 + f) * kG + lane;
    if constexpr (kMomentum) {
      const float pr = __bfloat162float(pre[o]), pq = __bfloat162float(pim[o]);
      pre[o] = __float2bfloat16(r);
      pim[o] = __float2bfloat16(q);
      r -= beta * pr;
      q -= beta * pq;
    }
    const float sc = __bfloat162float(mag[o]) * rsqrtf(r * r + q * q + 1e-12f);
    re[o] = r * sc;
    im[o] = q * sc;
  }
}

// Centred crop of the OLA'd rows: out[s] = row k/2 + s / hop.
__global__ void gl_output_kernel(const float* __restrict__ frames,
                                 const float* __restrict__ wsum, float* __restrict__ out,
                                 int T, int hop) {
  const int b = blockIdx.y, k = kN / hop;
  const int n_out = (T - 1) * hop;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n_out; s += gridDim.x * blockDim.x) {
    const int row = k / 2 + s / hop, col = s % hop;
    float acc = 0.0f;
    for (int q = 0; q < k; ++q) {
      const int tf = row - q;
      if (tf >= 0 && tf < T) acc += frames[((size_t)b * T + tf) * kN + q * hop + col];
    }
    out[(size_t)b * n_out + s] = acc * wsum[(size_t)row * hop + col];
  }
}

}  // namespace

// pre / pim: null for the plain iteration, else the two zeroed bf16
// (B, T, 640) previous-projection buffers of the momentum mode.
MSTTS_EXPORT int mstts_gl_staged(const void* mag, const void* mats, const void* win,
                                 const void* syn, const void* wsum, void* re, void* im,
                                 void* frames, void* out, void* pre, void* pim, int B, int T,
                                 int hop, int n_iter, float beta, void* stream) {
  if (hop <= 0 || kN % hop || hop % kL || (kN / hop) % 2 || T < 2 || n_iter < 0 ||
      (pre == nullptr) != (pim == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool momentum = pre != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MSTTS_CHECK(cudaFuncSetAttribute(gl_inverse_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemInverse));
  MSTTS_CHECK(cudaFuncSetAttribute(gl_forward_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemForward));
  MSTTS_CHECK(cudaFuncSetAttribute(gl_forward_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)kSmemForward));
  auto* forward = momentum ? gl_forward_kernel<true> : gl_forward_kernel<false>;
  const dim3 grid((T + kF - 1) / kF, B);
  const float* re_c = static_cast<const float*>(re);
  const float* im_c = static_cast<const float*>(im);
  for (int it = 0; it < n_iter; ++it) {
    gl_inverse_kernel<<<grid, kThreads, kSmemInverse, st>>>(
        re_c, im_c, static_cast<const bf16*>(mats), static_cast<const float*>(syn),
        static_cast<float*>(frames), T);
    forward<<<grid, kThreads, kSmemForward, st>>>(
        static_cast<const float*>(frames), static_cast<const float*>(wsum),
        static_cast<const float*>(win), static_cast<const bf16*>(mats),
        static_cast<const bf16*>(mag), static_cast<float*>(re), static_cast<float*>(im),
        static_cast<bf16*>(pre), static_cast<bf16*>(pim), beta, T, hop);
    if (it == 0) MSTTS_CHECK(cudaPeekAtLastError());
  }
  gl_inverse_kernel<<<grid, kThreads, kSmemInverse, st>>>(
      re_c, im_c, static_cast<const bf16*>(mats), static_cast<const float*>(syn),
      static_cast<float*>(frames), T);
  const int n_out = (T - 1) * hop;
  const dim3 ogrid(std::min((n_out + 255) / 256, 1024), B);
  gl_output_kernel<<<ogrid, 256, 0, st>>>(static_cast<const float*>(frames),
                                          static_cast<const float*>(wsum),
                                          static_cast<float*>(out), T, hop);
  MSTTS_RETURN_LAUNCH_ERROR();
}
