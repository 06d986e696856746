// Fused mel front-end: padded waveform -> normalized log-mel.
//
// Replaces multi_speaker_tts_tpu/ops/mel_kernel.py::melspectrogram_pallas
// (kernel body _mel_kernel). Same function: frames read straight from the
// preemphasised, reflect-padded signal; windowed rDFT (window folded into
// the DFT table); |X|; mel basis; 20*log10(max(., 1e-5)) - ref; [0, 1]
// normalisation. Everything in f32 FMAs on the CUDA cores, no TF32: the
// front-end's budget is 1e-4 against the FFT path.
//
// What bounds it on an H100: the DFT is n_fft * (n_fft/2+1) * 2 FMAs per
// frame (about 1.05 MFMA at n_fft=1024), so a 129-frame enrollment clip is
// ~0.27 GFLOP against 67 TFLOP/s of f32 -- operations bound, a few us
// ideally; its input is only ~130 KB. Design: one block per (utterance,
// tile of kTile frames). The block stages its windowed frames in shared
// memory, each thread owns bins k, k+256, k+512 and walks n, reading the
// interleaved (cos, -sin) table coalesced across threads (the 4.2 MB table
// stays in L2 after the first blocks); kTile frames share every table
// read. The magnitudes stay in shared memory for the mel product, whose
// basis is stored (F, M) so threads of one frame read it coalesced.
#include "common.cuh"

namespace {

constexpr int kTile = 4;  // frames per block
constexpr int kThreads = 256;
constexpr int kMaxBinsPerThread = 3;  // F <= 3 * kThreads

__global__ void __launch_bounds__(kThreads)
mel_frontend_kernel(const float* __restrict__ y_pad,    // (B, Lp)
                    const float2* __restrict__ dft,     // (n_fft, F)
                    const float* __restrict__ basis_t,  // (F, M)
                    float* __restrict__ out,            // (B, T, M)
                    int T, int Lp, int n_fft, int hop, int F, int M,
                    float ref_db, float min_db) {
  extern __shared__ float smem[];
  float* frames = smem;                 // [kTile][n_fft]
  float* mag = smem + kTile * n_fft;    // [kTile][F]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int nf = min(kTile, T - t0);
  const float* sig = y_pad + (size_t)b * Lp;

  for (int i = threadIdx.x; i < kTile * n_fft; i += kThreads) {
    const int f = i / n_fft, n = i - f * n_fft;
    frames[i] = f < nf ? sig[(size_t)(t0 + f) * hop + n] : 0.0f;
  }
  __syncthreads();

  float re[kMaxBinsPerThread][kTile], im[kMaxBinsPerThread][kTile];
#pragma unroll
  for (int j = 0; j < kMaxBinsPerThread; ++j)
#pragma unroll
    for (int f = 0; f < kTile; ++f) re[j][f] = im[j][f] = 0.0f;

  for (int n = 0; n < n_fft; ++n) {
    float x[kTile];
#pragma unroll
    for (int f = 0; f < kTile; ++f) x[f] = frames[f * n_fft + n];
#pragma unroll
    for (int j = 0; j < kMaxBinsPerThread; ++j) {
      const int k = threadIdx.x + j * kThreads;
      if (k < F) {
        const float2 w = dft[(size_t)n * F + k];
#pragma unroll
        for (int f = 0; f < kTile; ++f) {
          re[j][f] = fmaf(x[f], w.x, re[j][f]);
          im[j][f] = fmaf(x[f], w.y, im[j][f]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxBinsPerThread; ++j) {
    const int k = threadIdx.x + j * kThreads;
    if (k < F) {
#pragma unroll
      for (int f = 0; f < kTile; ++f)
        mag[f * F + k] = sqrtf(re[j][f] * re[j][f] + im[j][f] * im[j][f]);
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < nf * M; i += kThreads) {
    const int f = i / M, m = i - f * M;
    float acc = 0.0f;
    for (int k = 0; k < F; ++k) acc = fmaf(mag[f * F + k], basis_t[(size_t)k * M + m], acc);
    const float db = 20.0f * log10f(fmaxf(acc, 1e-5f)) - ref_db;
    const float v = (db - min_db) / (-min_db);
    out[((size_t)b * T + t0 + f) * M + m] = fminf(fmaxf(v, 0.0f), 1.0f);
  }
}

}  // namespace

MSTTS_EXPORT int mstts_mel_frontend(const void* y_pad, const void* dft,
                                    const void* basis_t, void* out, int B,
                                    int T, int Lp, int n_fft, int hop, int F,
                                    int M, float ref_db, float min_db,
                                    void* stream) {
  if (F > kMaxBinsPerThread * kThreads) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kTile * (n_fft + F);
  if (smem > 48 * 1024) {
    MSTTS_CHECK(cudaFuncSetAttribute(mel_frontend_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem));
  }
  const dim3 grid((T + kTile - 1) / kTile, B);
  mel_frontend_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)y_pad, (const float2*)dft, (const float*)basis_t,
      (float*)out, T, Lp, n_fft, hop, F, M, ref_db, min_db);
  MSTTS_RETURN_LAUNCH_ERROR();
}
