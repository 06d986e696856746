// Fused mel front-end: padded waveform -> normalized log-mel, one block a
// frame: an in-block FFT for an n_fft that is a power of two, a direct DFT
// (mel_dft_kernel, below) for any other.
//
// Replaces multi_speaker_tts_tpu/ops/mel_kernel.py::melspectrogram_pallas
// (kernel body _mel_kernel). Same function: frames read straight from the
// preemphasised, reflect-padded signal; Hann window; |rDFT|; mel basis;
// 20*log10(max(., 1e-5)) - ref; [0, 1] normalisation. Everything in f32 on
// the CUDA cores, no TF32: the front-end's budget is 1e-4 against its
// plain version, the f32 DFT matmul.
//
// What bounds it on an H100: not the work. A frame's real FFT is ~5 N log2 N
// operations (51 K at n_fft = 1024), its basis product ~2K, so a 133-frame
// enrollment clip needs ~7 MFLOP and ~190 KB of signal, basis and mels:
// ~0.1 us either way. What is left is latency: the frame's load from
// memory, the FFT's log2(n_fft / 2) dependent stages, each ending in a
// block barrier, and the launch.
//
// Design: the TPU kernel's DFT matmul (2.1 M FMAs a frame against a 4.2 MB
// table, which Hopper has to stream from L2 for every frame) becomes an
// FFT; one block per (utterance, frame), so 133 blocks at the serving shape.
// - The block loads its frame in 16-byte loads where the frame is aligned,
//   multiplies it by the window and packs the N real points as N/2 complex
//   points z[j] = x[2j] + i x[2j+1], stored in bit-reversed order.
// - An N/2-point complex radix-2 FFT (decimation in time) runs in place in
//   shared memory, N/4 butterflies a stage over the block's threads. The
//   twiddles exp(-2 pi i k / N), k < N/2 (4 KB at N = 1024, computed in f64
//   by the wrapper), are copied to shared memory once; stage s reads every
//   (N / 2^(s + 1))-th of them.
// - Both arrays are padded by one element every 16, so that the stages'
//   power-of-two strides do not pile onto a few banks.
// - The split into the N/2 + 1 bins of the real transform, X[k] = E[k] +
//   W^k O[k] from Z[k] and conj(Z[N/2 - k]), and their magnitudes into
//   shared memory.
// - A thread per mel band sums its band's nonzero bins [lo, hi) of the basis
//   (packed by the wrapper, only exact zeros skipped) in a fixed order, then
//   the log, the normalisation and a coalesced store.
// One launch a call, no atomics: two launches on one input are bit-equal.
//
// Shapes: any n_fft that hop divides (the wrapper's mel_shape_reason refuses
// anything else before launch; it picks the route): a power of two from 4
// up takes the FFT route, any other n_fft the DFT route. Where a route's
// frame, table and bins outgrow a block's shared memory (the FFT past
// n_fft 16384 on an H100, the DFT past 16603), its global-memory
// mode (kGlobal) keeps them in device memory and L2 instead: the FFT's
// points and bins in a scratch the wrapper allocates (a block's own rows;
// __syncthreads orders a block's global writes as it does its shared
// ones), its twiddles read where they lie; the DFT's table and frame read
// where they lie, its bins in the scratch. Same arithmetic, same order.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// One padding element every 16: float2 index p at p + p / 16.
__device__ __forceinline__ int padded(int p) { return p + (p >> 4); }

// The frame's mel bands from its bin magnitudes in shared memory: a thread
// per band sums the band's nonzero bins [lo, hi) in a fixed order, then the
// log, the normalisation and a coalesced store of frame blockIdx.x.
__device__ __forceinline__ void band_tail(const float* mag, const int* __restrict__ bands,
                                          const float* __restrict__ weights,
                                          float* __restrict__ out, int M, float ref_db,
                                          float min_db) {
  float* o = out + (size_t)blockIdx.x * M;  // frame (b, t) of (B, T, M)
  for (int m = threadIdx.x; m < M; m += kThreads) {
    const int lo = __ldg(bands + 3 * m), hi = __ldg(bands + 3 * m + 1);
    const float* wm = weights + __ldg(bands + 3 * m + 2);
    float acc = 0.0f;
    for (int k = lo; k < hi; ++k) acc = fmaf(mag[k], __ldg(wm + (k - lo)), acc);
    const float db = 20.0f * log10f(fmaxf(acc, 1e-5f)) - ref_db;
    o[m] = fminf(fmaxf((db - min_db) / (-min_db), 0.0f), 1.0f);
  }
}

template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
mel_fft_kernel(const float* __restrict__ y_pad,    // (B, Lp)
               const float* __restrict__ window,   // (n_fft)
               const float2* __restrict__ tw,      // (n_fft / 2): exp(-2 pi i k / n_fft)
               const int* __restrict__ bands,      // (M, 3): lo, hi, offset into weights
               const float* __restrict__ weights,  // the bands' basis values, packed
               float* __restrict__ out,            // (B, T, M)
               float* scratch,  // kGlobal: (B T) x [padded(NH) float2 | NH + 1 floats, to 4]
               int T, int Lp, int log2n, int hop, int M, float ref_db, float min_db) {
  extern __shared__ __align__(16) float2 smem2[];
  const int LH = log2n - 1, NH = 1 << LH;  // NH = n_fft / 2 complex points
  float2* z;                                  // [padded(NH)]
  float2* tws = nullptr;                      // [padded(NH)] (shared memory only)
  float* mag;                                 // [NH + 1]
  if constexpr (kGlobal) {
    z = reinterpret_cast<float2*>(
        scratch + (size_t)blockIdx.x * (2 * padded(NH) + mstts_round_up(NH + 1, 4)));
    mag = reinterpret_cast<float*>(z + padded(NH));
  } else {
    z = smem2;
    tws = z + padded(NH);
    mag = reinterpret_cast<float*>(tws + padded(NH));
  }
  // Twiddle k < NH.
  auto twiddle = [&](int k) { return kGlobal ? __ldg(tw + k) : tws[padded(k)]; };
  const int b = blockIdx.x / T, t = blockIdx.x - b * T;
  const float* x = y_pad + (size_t)b * Lp + (size_t)t * hop;

  if constexpr (!kGlobal)
    for (int k = threadIdx.x; k < NH; k += kThreads) tws[padded(k)] = __ldg(tw + k);
  // The windowed frame as NH complex points, z[j] at bit-reversed position.
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(x);
    const float4* w4 = reinterpret_cast<const float4*>(window);
    for (int i = threadIdx.x; i < NH / 2; i += kThreads) {
      const float4 v = __ldg(x4 + i), w = __ldg(w4 + i);
      z[padded(__brev(2 * i) >> (32 - LH))] = make_float2(v.x * w.x, v.y * w.y);
      z[padded(__brev(2 * i + 1) >> (32 - LH))] = make_float2(v.z * w.z, v.w * w.w);
    }
  } else {
    for (int j = threadIdx.x; j < NH; j += kThreads)
      z[padded(__brev(j) >> (32 - LH))] =
          make_float2(__ldg(x + 2 * j) * __ldg(window + 2 * j),
                      __ldg(x + 2 * j + 1) * __ldg(window + 2 * j + 1));
  }
  __syncthreads();

  // Radix-2 stages: butterflies of span 2h, twiddle W_{2h}^j = tw[j N / 2h].
  for (int s = 0; s < LH; ++s) {
    const int h = 1 << s;
    for (int i = threadIdx.x; i < NH / 2; i += kThreads) {
      const int j = i & (h - 1), a = ((i >> s) << (s + 1)) + j;
      const int pa = padded(a), pb = padded(a + h);
      const float2 w = twiddle(j << (LH - s));
      const float2 u = z[pa], v = z[pb];
      const float2 vw = make_float2(v.x * w.x - v.y * w.y, v.x * w.y + v.y * w.x);
      z[pa] = make_float2(u.x + vw.x, u.y + vw.y);
      z[pb] = make_float2(u.x - vw.x, u.y - vw.y);
    }
    __syncthreads();
  }

  // The real transform's bins: X[k] = E + W^k O, E = (Z[k] + conj Z[NH - k]) / 2,
  // O = (Z[k] - conj Z[NH - k]) / 2i; X[0] and X[NH] from Z[0] alone.
  for (int k = threadIdx.x; k <= NH; k += kThreads) {
    float re, im;
    if (k == 0 || k == NH) {
      const float2 z0 = z[0];
      re = k == 0 ? z0.x + z0.y : z0.x - z0.y;
      im = 0.0f;
    } else {
      const float2 a = z[padded(k)], c = z[padded(NH - k)], w = twiddle(k);
      const float er = 0.5f * (a.x + c.x), ei = 0.5f * (a.y - c.y);
      const float orr = 0.5f * (a.y + c.y), oi = -0.5f * (a.x - c.x);
      re = er + (orr * w.x - oi * w.y);
      im = ei + (orr * w.y + oi * w.x);
    }
    mag[k] = sqrtf(re * re + im * im);
  }
  __syncthreads();

  band_tail(mag, bands, weights, out, M, ref_db, min_db);
}


// The route for an n_fft that is not a power of two: a direct real DFT, one
// block a frame. The windowed frame and the table W[m] = (cos, -sin)(2 pi m /
// N), m < N (computed in f64 by the wrapper; 6.4 KB at N = 800, 32 KB at
// 4096), sit in shared memory; a thread a bin k <= N/2 sums x[n] W[(n k) mod
// N] over n in f32 FMAs, its table index stepped by k and wrapped exactly in
// integers (no phase accumulated across n). 2 N (N/2 + 1) FMAs a frame,
// 0.64 M at N = 800: shared-memory traffic and latency bound it, not the
// arithmetic. The bands' tail is the FFT route's.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
mel_dft_kernel(const float* __restrict__ y_pad,    // (B, Lp)
               const float* __restrict__ window,   // (n_fft)
               const float2* __restrict__ table,   // (n_fft): (cos, -sin)(2 pi m / n_fft)
               const int* __restrict__ bands,      // (M, 3): lo, hi, offset into weights
               const float* __restrict__ weights,  // the bands' basis values, packed
               float* __restrict__ out,            // (B, T, M)
               float* scratch,                     // kGlobal: (B T) x (n_fft / 2 + 1) floats
               int T, int Lp, int n_fft, int hop, int M, float ref_db, float min_db) {
  extern __shared__ __align__(16) float2 smem2[];
  const int N = n_fft, F = n_fft / 2 + 1;
  float2* tab = smem2;                               // [N] (shared memory only)
  float* xw = reinterpret_cast<float*>(tab + N);     // [N] (shared memory only)
  float* mag = kGlobal ? scratch + (size_t)blockIdx.x * F : xw + N;  // [F]
  const int b = blockIdx.x / T, t = blockIdx.x - b * T;
  const float* x = y_pad + (size_t)b * Lp + (size_t)t * hop;

  if constexpr (!kGlobal) {
    for (int m = threadIdx.x; m < N; m += kThreads) {
      tab[m] = __ldg(table + m);
      xw[m] = __ldg(x + m) * __ldg(window + m);
    }
    __syncthreads();
  }

  for (int k = threadIdx.x; k < F; k += kThreads) {
    float re = 0.0f, im = 0.0f;
    int idx = 0;  // (n k) mod N
    for (int n = 0; n < N; ++n) {
      const float v = kGlobal ? __ldg(x + n) * __ldg(window + n) : xw[n];
      const float2 w = kGlobal ? __ldg(table + idx) : tab[idx];
      re = fmaf(v, w.x, re);
      im = fmaf(v, w.y, im);
      idx += k;
      if (idx >= N) idx -= N;
    }
    mag[k] = sqrtf(re * re + im * im);
  }
  __syncthreads();

  band_tail(mag, bands, weights, out, M, ref_db, min_db);
}

// Shared memory of a route's block (0: FFT, 1: DFT) at n_fft: the
// wrapper's mel_kernel.smem_bytes. Past the card's opt-in bytes the wrapper
// asks for the global-memory mode.
size_t mel_smem_bytes(int dft, int n_fft) {
  if (dft)
    return (sizeof(float2) + sizeof(float)) * (size_t)n_fft + sizeof(float) * (n_fft / 2 + 1);
  const int nh = n_fft / 2, padded_nh = nh + nh / 16;
  return 2 * sizeof(float2) * (size_t)padded_nh + sizeof(float) * (nh + 1);
}

template <typename Kernel>
int launch(Kernel kernel, bool global_mode, size_t smem, int blocks, cudaStream_t stream,
                  const void* y_pad, const void* window, const void* table, const void* bands,
                  const void* weights, void* out, void* scratch, int T, int Lp, int n, int hop,
                  int M, float ref_db, float min_db) {
  if (global_mode) {
    if (scratch == nullptr) return (int)cudaErrorInvalidValue;
    smem = 0;
  } else {
    int dev = 0, max_smem = 0;
    MSTTS_CHECK(cudaGetDevice(&dev));
    MSTTS_CHECK(
        cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
    if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024)
      MSTTS_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem));
  }
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(y_pad), static_cast<const float*>(window),
      static_cast<const float2*>(table), static_cast<const int*>(bands),
      static_cast<const float*>(weights), static_cast<float*>(out),
      static_cast<float*>(scratch), T, Lp, n, hop, M, ref_db, min_db);
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace

// global_mode: 1 runs the route's global-memory mode on `scratch` (see the
// header), 0 the shared-memory one (scratch unused).
MSTTS_EXPORT int mstts_mel_frontend(const void* y_pad, const void* window, const void* tw,
                                    const void* bands, const void* weights, void* out,
                                    void* scratch, int global_mode, int B, int T, int Lp,
                                    int n_fft, int hop, int M, float ref_db, float min_db,
                                    void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n_fft) ++log2n;
  if ((1 << log2n) != n_fft || n_fft < 4 || hop < 1 || n_fft % hop || B < 1 || T < 1 ||
      M < 1 || Lp < (T - 1) * hop + n_fft)
    return (int)cudaErrorInvalidValue;
  return global_mode
             ? launch(mel_fft_kernel<true>, true, 0, B * T, static_cast<cudaStream_t>(stream),
                      y_pad, window, tw, bands, weights, out, scratch, T, Lp, log2n, hop, M,
                      ref_db, min_db)
             : launch(mel_fft_kernel<false>, false, mel_smem_bytes(0, n_fft), B * T,
                      static_cast<cudaStream_t>(stream), y_pad, window, tw, bands, weights, out,
                      scratch, T, Lp, log2n, hop, M, ref_db, min_db);
}

MSTTS_EXPORT int mstts_mel_dft(const void* y_pad, const void* window, const void* table,
                               const void* bands, const void* weights, void* out, void* scratch,
                               int global_mode, int B, int T, int Lp, int n_fft, int hop, int M,
                               float ref_db, float min_db, void* stream) {
  if (n_fft < 1 || hop < 1 || n_fft % hop || B < 1 || T < 1 || M < 1 ||
      Lp < (T - 1) * hop + n_fft)
    return (int)cudaErrorInvalidValue;
  return global_mode
             ? launch(mel_dft_kernel<true>, true, 0, B * T, static_cast<cudaStream_t>(stream),
                      y_pad, window, table, bands, weights, out, scratch, T, Lp, n_fft, hop, M,
                      ref_db, min_db)
             : launch(mel_dft_kernel<false>, false, mel_smem_bytes(1, n_fft), B * T,
                      static_cast<cudaStream_t>(stream), y_pad, window, table, bands, weights,
                      out, scratch, T, Lp, n_fft, hop, M, ref_db, min_db);
}
