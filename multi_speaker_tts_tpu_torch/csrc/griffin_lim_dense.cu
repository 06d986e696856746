// Dense Griffin-Lim for any n_fft up to 2048 with a 128-multiple hop and an
// even n_fft / hop.
//
// Replaces multi_speaker_tts_tpu/ops/griffin_lim_kernel.py::griffin_lim_pallas
// (kernel body _gl_kernel). Same fixed-point map: zero-phase start (re = mag,
// im = 0), the windowed inverse DFT of bins 0 .. n_fft/2 - 1 as one product
// against the stacked [Vr; Vi] (synthesis window and 1/N folded in), the
// Nyquist bin as a rank-1 f32 term, overlap-add over the uncropped signal
// rows normalised by the inverse window-square sum, re-framing frame t from
// rows t .. t + k - 1, the windowed forward DFT as one product against
// [Wr | Wi], the Nyquist analysis as an f32 dot product, the projection
// mag / max(sqrt(|X|^2 + 1e-12), 1e-11), n_iter + 1 inverses, and the
// centred crop of k/2 rows. The DFT matrices and the product operands are
// bf16 with f32 accumulation; magnitudes, spectra and frames are f32. The
// momentum mode (pre non-null) keeps three f32 carries, the previous
// unprojected re, im and Nyquist value, and extrapolates X - beta P before
// each projection, as the TPU kernel's body_m.
//
// Redesign for Hopper: the TPU kernel keeps an utterance's (T, Fp) spectra
// and the DFT matrices resident in VMEM across all iterations. An SM has
// 227 KB of shared memory, less than one matrix (4 MB at n_fft 1024), so
// here the spectra, frames and carries live in device memory (L2-resident
// at serving sizes: the wrapper chunks the batch to keep them so), the
// matrices are read through L2, and each iteration is two launches over
// tiles of 16 frames:
//   gld_inverse: [re | im] of 16 frames -> bf16 operand in shared memory ->
//     WMMA 16x16x16 products against [Vr; Vi] for 256 output columns a
//     block -> + Nyquist term -> frames;
//   gld_forward: overlap-add of the k frames covering each sample, times
//     the normaliser, is the re-framed tile (bf16 operand in shared memory,
//     f32 Nyquist dot product on the side) -> WMMA products against
//     [Wr | Wi] for 128 bins a block -> momentum -> projection -> spectra.
// Splitting the columns (inverse) and bins (forward) over blocks gives
// n_fft / 256 times more blocks than frame tiles alone: 128 blocks at
// B = 4, T = 128, n_fft = 1024. What bounds it on an H100: the tensor-core
// operations (about 4.2 MFLOP a frame and iteration at n_fft 1024: B = 4,
// T = 128, 60 iterations is 130 GFLOP, 0.13 ms at 989 TFLOP/s); its inputs
// and outputs are a few MB. In practice a call is 2 (n_iter + 1) dependent
// launches whose WMMA B fragments come from L2, each block reading its
// share of the matrices once a launch.
#include <mma.h>

#include <algorithm>

#include "common.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kF = 16;            // frames per block: one MMA row tile
constexpr int kThreads = 256;     // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kInvCols = 256;     // synthesis columns per inverse block
constexpr int kFwdBins = 128;     // bins per forward block
constexpr int kLdX = kFwdBins + 4;  // f32 product plane row + pad
constexpr int kMaxN = 2048;

size_t inverse_smem(int Fp) {
  return sizeof(bf16) * kF * (2 * Fp + 8) + sizeof(float) * kWarps * 256;
}

size_t forward_smem(int n_fft) {
  return sizeof(bf16) * kF * (n_fft + 8) + sizeof(float) * (2 * kF * kLdX + kF);
}

// vcat: (2 Fp, n_fft) bf16 = [Vr; Vi]; vny: (n_fft) f32 Nyquist synthesis.
__global__ void __launch_bounds__(kThreads)
gld_inverse_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const float* __restrict__ rny, const bf16* __restrict__ vcat,
                   const float* __restrict__ vny, float* __restrict__ frames, int T, int Fp,
                   int n_fft) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = 2 * Fp + 8;
  bf16* A = reinterpret_cast<bf16*>(smem);  // [kF][lda]: [re | im]
  float* scratch = reinterpret_cast<float*>(smem + sizeof(bf16) * kF * lda);
  const int b = blockIdx.z, t0 = blockIdx.x * kF, c0 = blockIdx.y * kInvCols;

  for (int i = threadIdx.x; i < kF * Fp; i += kThreads) {
    const int f = i / Fp, m = i - f * Fp;
    float r = 0.0f, q = 0.0f;
    if (t0 + f < T) {
      const size_t o = ((size_t)b * T + t0 + f) * Fp + m;
      r = re[o];
      q = im[o];
    }
    A[f * lda + m] = __float2bfloat16(r);
    A[f * lda + Fp + m] = __float2bfloat16(q);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* S = scratch + warp * 256;  // this warp's 16 x 16 tile
  const int ktiles = 2 * Fp / 16;
  for (int nt = warp; nt < kInvCols / 16; nt += kWarps) {
    const int col = c0 + nt * 16;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kt = 0; kt < ktiles; ++kt) {
      wmma::load_matrix_sync(a, A + kt * 16, lda);
      wmma::load_matrix_sync(bm, vcat + (size_t)kt * 16 * n_fft + col, n_fft);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(S, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int f = e / 16, c = e % 16, t = t0 + f;
      if (t < T)
        frames[((size_t)b * T + t) * n_fft + col + c] =
            S[e] + rny[(size_t)b * T + t] * vny[col + c];
    }
    __syncwarp();
  }
}

// wcat: (n_fft, 2 Fp) bf16 = [Wr | Wi]; wny: (n_fft) f32 Nyquist analysis;
// wsum: (rows, hop) inverse window-square normaliser. pre / pim / prny are
// the momentum carries (f32).
template <bool kMomentum>
__global__ void __launch_bounds__(kThreads)
gld_forward_kernel(const float* __restrict__ frames, const float* __restrict__ wsum,
                   const bf16* __restrict__ wcat, const float* __restrict__ wny,
                   const float* __restrict__ mag, const float* __restrict__ mag_ny,
                   float* __restrict__ re, float* __restrict__ im, float* __restrict__ rny,
                   float* __restrict__ pre, float* __restrict__ pim, float* __restrict__ prny,
                   float beta, int T, int Fp, int n_fft, int hop) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = n_fft + 8;
  bf16* A = reinterpret_cast<bf16*>(smem);  // [kF][lda]: re-framed rows
  float* X = reinterpret_cast<float*>(smem + sizeof(bf16) * kF * lda);  // [2][kF][kLdX]
  float* ny = X + 2 * kF * kLdX;  // [kF] Nyquist analysis
  const int b = blockIdx.z, t0 = blockIdx.x * kF, f0 = blockIdx.y * kFwdBins;
  const int k = n_fft / hop;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // Frame t, sample n = rows[t + n / hop][n % hop]; row r = wsum[r] x the
  // sum of the k frames covering it. Warp w builds frames w and w + 8.
  for (int f = warp; f < kF; f += kWarps) {
    const int t = t0 + f;
    float dot = 0.0f;
    for (int n = lane; n < n_fft; n += 32) {
      float v = 0.0f;
      if (t < T) {
        const int row = t + n / hop, col = n % hop;
        float s = 0.0f;
        for (int q = 0; q < k; ++q) {
          const int tf = row - q;
          if (tf >= 0 && tf < T) s += frames[((size_t)b * T + tf) * n_fft + q * hop + col];
        }
        v = s * wsum[(size_t)row * hop + col];
        dot += v * wny[n];
      }
      A[f * lda + n] = __float2bfloat16(v);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) ny[f] = dot;
  }
  __syncthreads();

  // Planes 0 (re, against Wr) and 1 (im, against Wi), 8 column tiles each.
  const int ktiles = n_fft / 16;
  for (int task = warp; task < 2 * (kFwdBins / 16); task += kWarps) {
    const int plane = task / (kFwdBins / 16), nt = task % (kFwdBins / 16);
    const bf16* Bm = wcat + plane * Fp + f0 + nt * 16;
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
    wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int kt = 0; kt < ktiles; ++kt) {
      wmma::load_matrix_sync(a, A + kt * 16, lda);
      wmma::load_matrix_sync(bm, Bm + (size_t)kt * 16 * 2 * Fp, 2 * Fp);
      wmma::mma_sync(acc, a, bm, acc);
    }
    wmma::store_matrix_sync(X + plane * kF * kLdX + nt * 16, acc, kLdX, wmma::mem_row_major);
  }
  __syncthreads();

  for (int i = threadIdx.x; i < kF * kFwdBins; i += kThreads) {
    const int f = i / kFwdBins, m = i % kFwdBins, t = t0 + f;
    if (t >= T) continue;
    const size_t o = ((size_t)b * T + t) * Fp + f0 + m;
    float r = X[f * kLdX + m], q = X[kF * kLdX + f * kLdX + m];
    if constexpr (kMomentum) {
      const float pr = pre[o], pq = pim[o];
      pre[o] = r;
      pim[o] = q;
      r -= beta * pr;
      q -= beta * pq;
    }
    const float sc = mag[o] / fmaxf(sqrtf(r * r + q * q + 1e-12f), 1e-11f);
    re[o] = r * sc;
    im[o] = q * sc;
  }
  if (blockIdx.y == 0 && threadIdx.x < kF && t0 + threadIdx.x < T) {
    const size_t o = (size_t)b * T + t0 + threadIdx.x;
    float rn = ny[threadIdx.x];
    if constexpr (kMomentum) {
      const float p = prny[o];
      prny[o] = rn;
      rn -= beta * p;
    }
    rny[o] = rn * (mag_ny[o] / fmaxf(sqrtf(rn * rn + 1e-12f), 1e-11f));
  }
}

// Centred crop of the OLA'd rows: out[s] = row k/2 + s / hop.
__global__ void gld_output_kernel(const float* __restrict__ frames,
                                  const float* __restrict__ wsum, float* __restrict__ out,
                                  int T, int n_fft, int hop) {
  const int b = blockIdx.y, k = n_fft / hop;
  const int n_out = (T - 1) * hop;
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n_out; s += gridDim.x * blockDim.x) {
    const int row = k / 2 + s / hop, col = s % hop;
    float acc = 0.0f;
    for (int q = 0; q < k; ++q) {
      const int tf = row - q;
      if (tf >= 0 && tf < T) acc += frames[((size_t)b * T + tf) * n_fft + q * hop + col];
    }
    out[(size_t)b * n_out + s] = acc * wsum[(size_t)row * hop + col];
  }
}

}  // namespace

// mag (B, T, Fp) and mag_ny (B, T) f32 targets; re / im (B, T, Fp) and
// rny (B, T) f32 spectra, initialised by the caller to (mag, 0, mag_ny);
// pre / pim / prny null for the plain iteration, else zeroed f32 carries of
// the same shapes; frames (B, T, n_fft) f32 scratch; out (B, (T-1) hop).
MSTTS_EXPORT int mstts_gl_dense(const void* mag, const void* mag_ny, const void* wcat,
                                const void* vcat, const void* wny, const void* vny,
                                const void* wsum, void* re, void* im, void* rny, void* pre,
                                void* pim, void* prny, void* frames, void* out, int B, int T,
                                int n_fft, int hop, int n_iter, float beta, void* stream) {
  if (hop <= 0 || hop % 128 || n_fft % hop || (n_fft / hop) % 2 || n_fft > kMaxN ||
      n_fft % kInvCols || T < 2 || n_iter < 0 || B < 1 || B > 65535 ||
      (pre == nullptr) != (pim == nullptr) || (pre == nullptr) != (prny == nullptr))
    return (int)cudaErrorInvalidValue;
  const int Fp = n_fft / 2;
  const bool momentum = pre != nullptr;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem_inv = inverse_smem(Fp), smem_fwd = forward_smem(n_fft);
  MSTTS_CHECK(cudaFuncSetAttribute(gld_inverse_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_inv));
  MSTTS_CHECK(cudaFuncSetAttribute(gld_forward_kernel<false>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_fwd));
  MSTTS_CHECK(cudaFuncSetAttribute(gld_forward_kernel<true>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_fwd));
  auto* forward = momentum ? gld_forward_kernel<true> : gld_forward_kernel<false>;
  const int tiles = (T + kF - 1) / kF;
  const dim3 grid_inv(tiles, n_fft / kInvCols, B), grid_fwd(tiles, Fp / kFwdBins, B);
  const float* mag_c = static_cast<const float*>(mag);
  const float* ny_c = static_cast<const float*>(mag_ny);
  const bf16* wcat_c = static_cast<const bf16*>(wcat);
  const bf16* vcat_c = static_cast<const bf16*>(vcat);
  const float* wny_c = static_cast<const float*>(wny);
  const float* vny_c = static_cast<const float*>(vny);
  const float* wsum_c = static_cast<const float*>(wsum);
  float* re_p = static_cast<float*>(re);
  float* im_p = static_cast<float*>(im);
  float* rny_p = static_cast<float*>(rny);
  float* frames_p = static_cast<float*>(frames);
  for (int it = 0; it < n_iter; ++it) {
    gld_inverse_kernel<<<grid_inv, kThreads, smem_inv, st>>>(re_p, im_p, rny_p, vcat_c, vny_c,
                                                             frames_p, T, Fp, n_fft);
    forward<<<grid_fwd, kThreads, smem_fwd, st>>>(
        frames_p, wsum_c, wcat_c, wny_c, mag_c, ny_c, re_p, im_p, rny_p,
        static_cast<float*>(pre), static_cast<float*>(pim), static_cast<float*>(prny), beta, T,
        Fp, n_fft, hop);
    if (it == 0) MSTTS_CHECK(cudaPeekAtLastError());
  }
  gld_inverse_kernel<<<grid_inv, kThreads, smem_inv, st>>>(re_p, im_p, rny_p, vcat_c, vny_c,
                                                           frames_p, T, Fp, n_fft);
  const int n_out = (T - 1) * hop;
  const dim3 ogrid(std::min((n_out + 255) / 256, 1024), B);
  gld_output_kernel<<<ogrid, 256, 0, st>>>(frames_p, wsum_c, static_cast<float*>(out), T,
                                           n_fft, hop);
  MSTTS_RETURN_LAUNCH_ERROR();
}
