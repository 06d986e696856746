// HiFi-GAN's multi-receptive-field fusion (the MRF of models/hifigan.py):
// every ResBlock1 dilation step as two launches of one channels-last
// implicit-GEMM 1-D convolution, with the step's bias, LeakyReLU, rounding,
// residual and MRF mean in the kernel's epilogue.
//
// Replaces no TPU kernel: the JAX package has no vocoder network. It was
// added because around cuDNN's convolutions the generator ran about ten
// eager passes over each (B, C, L) tensor a dilation step (bias adds, casts
// both ways, LeakyReLU, residual adds, cuDNN's NCHW <-> NHWC transposes):
// 75-85% of the vocoder's device time was that memory traffic, not the
// convolutions' arithmetic.
//
// One launch: out[b, l, n] = bias[n] + sum_t sum_c W[t][n][c] a[b, l + t d -
// (k - 1) d / 2, c] over (B, L, C) rows, zero outside [0, L). The epilogue,
// on the f32 accumulator v = sum + bias:
//   conv 1 (no residual):  act = bf16(lrelu(v, slope))
//   conv 2:                v = xin + v; v = sum_in + v (a running MRF sum);
//                          v = v / div (the mean); xout = v (f32);
//                          act = bf16(lrelu(v, slope))
// each part present where its pointer is (div 1 leaves v as it is). So the
// residual stream and the MRF sum stay f32, every convolution's operand is
// rounded to bf16 once, and nothing runs between two convolutions.
// Two pointwise passes sit at the MRF's edges: mstts_mrf_in turns the
// transposed convolution's bf16 output into the stage's f32 input (its bias
// added in f32), and mstts_mrf_act writes an f32 input's bf16 activation,
// read by all three ResBlock1s (or by the next transposed convolution).
//
// What bounds it on an H100 (V1's widths): a dilation step moves about 16
// bytes an element of (B, L, C) and does 4 C k operations an element (two
// convolutions of 2 C k), so at C 32 and 64 (stages 3 and 2) the bytes bound
// it, at C 128 and 256 (stages 1 and 0) the tensor cores.
// - Bytes: activations stay channels-last between the convolutions, so a
//   block reads one contiguous slab of (TM + (k - 1) d) rows x C bf16 once
//   (16-byte cp.async, zero-filled off the row's ends) and walks the k taps
//   over it in shared memory: a tap is the same slab shifted by d rows. The
//   halo re-read is (k - 1) d / TM: TM is 512 rows at C 32, 256 at C 64.
//   The epilogue issues a row's residual loads before its stores.
// - Arithmetic: mma.sync m16n8k16 (bf16 in, f32 sums), eight warps a block
//   with output tiles of 64 x 32, 32 x 64 or 64 x 64, A fragments by
//   ldmatrix from the slab at any row shift, the weights (k, C_out, C_in)
//   streamed through a three-deep cp.async ring of 64-channel chunks (32 at
//   C 32) that also carries the slab's pieces of those channels, so a
//   block's loads overlap its products. At C 256 a block covers all 256
//   output channels, so the slab is read once. wgmma with A from registers
//   (ldmatrix from the shifted slab: its shared-memory descriptors want an
//   A tile on a swizzle-atom boundary, which a slab shifted by t d rows is
//   not) and B by descriptor gave the same bits but, waiting for each
//   step's products before the next, ran 1.3-1.5x slower than this
//   mainloop at C 128 and 256 on an H100; it needs warp-specialised
//   producers to pay, and is left for a later change.
// Deterministic: one block owns each output element, no split over the
// taps or the channels, no atomics; two launches on one input are
// bit-equal.
#include "common.cuh"

namespace {

// The tile of a width: warps along L x warps along C, rows and columns of a
// warp's tile, input channels a pipeline step, depth of the weight ring,
// blocks an SM the build asks for.
template <int C_, int WarpsM, int WarpsN, int WarpRows, int WarpCols, int Chunk, int Stages,
          int MinBlocks>
struct Tile {
  static constexpr int C = C_;
  static constexpr int kThreads = WarpsM * WarpsN * 32;
  static constexpr int KC = Chunk;
  static constexpr int kStages = Stages;
  static constexpr int WTM = WarpRows;
  static constexpr int WTN = WarpCols;
  static constexpr int WN = WarpsN;
  static constexpr int TM = WarpsM * WarpRows;
  static constexpr int TN = WarpsN * WTN;
  static constexpr int MT = WTM / 16;
  static constexpr int NT = WTN / 8;
  static constexpr int SA = C + 8;   // slab row stride: an odd multiple of 16 bytes
  static constexpr int SB = KC + 8;  // weight chunk row stride
  static constexpr int kMinBlocks = MinBlocks;
  static_assert(C % KC == 0 && KC % 16 == 0 && C % TN == 0, "whole chunks and tiles");
};

// Chosen by timing the MRF's 18 launches at the 400-frame bucket, B 32, on
// an H100 among 5 tiles a width. ops/hifigan_mrf.py reads its TILES from
// these lines: keep one `using` a line.
using Tile32 = Tile<32, 8, 1, 64, 32, 32, 3, 2>;
using Tile64 = Tile<64, 4, 2, 64, 32, 64, 3, 2>;
using Tile128 = Tile<128, 4, 2, 32, 64, 64, 3, 2>;
using Tile256 = Tile<256, 2, 4, 64, 64, 64, 3, 1>;

struct ConvArgs {
  const __nv_bfloat16* a;  // (B, L, C) activation
  const __nv_bfloat16* w;  // (k, C, C): tap, output channel, input channel
  const float* bias;       // (C)
  const float* xin;        // (B, L, C) residual, or null
  const float* sum;        // (B, L, C) running MRF sum, or null (may be xout)
  float* xout;             // (B, L, C), or null (may be xin or sum)
  __nv_bfloat16* act;      // (B, L, C), or null
  int L, k, d;
  float slope, div;
};

template <class T>
int smem_bytes(int halo) {
  return 2 * ((T::TM + halo) * T::SA + T::kStages * T::TN * T::SB);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float lrelu(float v, float slope) { return v > 0.f ? v : v * slope; }

template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks) mrf_conv_kernel(const ConvArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* slab = reinterpret_cast<__nv_bfloat16*>(smem);
  const int halo = (p.k - 1) * p.d;
  const int rows = T::TM + halo;
  __nv_bfloat16* ring = slab + rows * T::SA;
  const int m0 = blockIdx.x * T::TM, n0 = blockIdx.y * T::TN;
  const size_t base = static_cast<size_t>(blockIdx.z) * p.L;  // the row's first position
  const int first = m0 - halo / 2;                            // slab row 0's position
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::WN, wn = warp % T::WN;
  const int steps = (T::C / T::KC) * p.k;  // (chunk, tap), taps inner

  // Step s's loads as one cp.async group: the weights of (chunk c, tap t)
  // into ring slot s % T::kStages and, at a chunk's first tap, the slab's
  // 32 channels of that chunk. Past the last step an empty group keeps the
  // count of groups uniform.
  auto issue = [&](int s) {
    if (s < steps) {
      const int c = s / p.k, t = s - c * p.k;
      if (t == 0) {
        for (int i = tid; i < rows * (T::KC / 8); i += T::kThreads) {
          const int r = i / (T::KC / 8), q = i % (T::KC / 8);
          const int pos = first + r;
          __nv_bfloat16* dst = slab + r * T::SA + c * T::KC + q * 8;
          if (pos >= 0 && pos < p.L)
            mstts_cp_async16(dst, p.a + (base + pos) * T::C + c * T::KC + q * 8);
          else
            *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
      __nv_bfloat16* slot = ring + (s % T::kStages) * T::TN * T::SB;
      for (int i = tid; i < T::TN * (T::KC / 8); i += T::kThreads) {
        const int n = i / (T::KC / 8), q = i % (T::KC / 8);
        mstts_cp_async16(slot + n * T::SB + q * 8,
                         p.w + (static_cast<size_t>(t) * T::C + n0 + n) * T::C + c * T::KC +
                             q * 8);
      }
    }
    cp_async_commit();
  };

  float acc[T::MT][T::NT][4];
#pragma unroll
  for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::NT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  for (int s = 0; s < T::kStages - 1; ++s) issue(s);
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<T::kStages - 2>();  // step s's group is in
    __syncthreads();               // for every thread; slot (s - 1) % T::kStages is free
    issue(s + T::kStages - 1);
    const int c = s / p.k, t = s - c * p.k;
    const __nv_bfloat16* slot = ring + (s % T::kStages) * T::TN * T::SB;
    // ldmatrix rows: A row (lane % 16) of a 16-row tile, shifted by the
    // tap, column (lane / 16) * 8; B (n-major) row (lane % 8) + (lane / 16)
    // * 8 of a 16-column pair, column (lane / 8 % 2) * 8.
    const __nv_bfloat16* a_row =
        slab + (wm * T::WTM + (lane & 15) + t * p.d) * T::SA + c * T::KC + (lane >> 4) * 8;
    const __nv_bfloat16* b_row =
        slot + (wn * T::WTN + (lane & 7) + (lane >> 4) * 8) * T::SB + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < T::KC; kk += 16) {
      uint32_t af[T::MT][4], bf[T::NT / 2][4];
#pragma unroll
      for (int mi = 0; mi < T::MT; ++mi) mstts_ldmatrix_x4(af[mi], a_row + mi * 16 * T::SA + kk);
#pragma unroll
      for (int nj = 0; nj < T::NT / 2; ++nj)
        mstts_ldmatrix_x4(bf[nj], b_row + nj * 16 * T::SB + kk);
#pragma unroll
      for (int mi = 0; mi < T::MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::NT; ++ni)
          mstts_mma_bf16(acc[mi][ni], af[mi][0], af[mi][1], af[mi][2], af[mi][3],
                         bf[ni / 2][(ni & 1) * 2], bf[ni / 2][(ni & 1) * 2 + 1]);
    }
  }

  // Epilogue from the accumulators: lane (g, tq) holds columns 2 tq, 2 tq + 1
  // of rows g and g + 8 of each 16 x 8 tile. Each element is read (xin,
  // sum) and written by this thread alone, so in-place buffers are safe; a
  // row's residual and sum loads are all issued before its stores, since a
  // load cannot pass a store that may alias it.
  const int g = lane >> 2, tq = lane & 3;
  float2 bias[T::NT];
#pragma unroll
  for (int ni = 0; ni < T::NT; ++ni)
    bias[ni] = *reinterpret_cast<const float2*>(p.bias + n0 + wn * T::WTN + ni * 8 + 2 * tq);
#pragma unroll
  for (int mi = 0; mi < T::MT; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pos = m0 + wm * T::WTM + mi * 16 + g + h * 8;
      if (pos >= p.L) continue;
      const size_t row = (base + pos) * T::C + n0 + wn * T::WTN + 2 * tq;
      float2 xr[T::NT], sr[T::NT];
#pragma unroll
      for (int ni = 0; ni < T::NT; ++ni) {
        xr[ni] = p.xin ? *reinterpret_cast<const float2*>(p.xin + row + ni * 8)
                       : make_float2(0.f, 0.f);
        sr[ni] = p.sum ? *reinterpret_cast<const float2*>(p.sum + row + ni * 8)
                       : make_float2(0.f, 0.f);
      }
#pragma unroll
      for (int ni = 0; ni < T::NT; ++ni) {
        float v0 = acc[mi][ni][2 * h] + bias[ni].x, v1 = acc[mi][ni][2 * h + 1] + bias[ni].y;
        if (p.xin) {
          v0 = xr[ni].x + v0;
          v1 = xr[ni].y + v1;
        }
        if (p.sum) {
          v0 = sr[ni].x + v0;
          v1 = sr[ni].y + v1;
        }
        if (p.div != 1.f) {
          v0 = v0 / p.div;
          v1 = v1 / p.div;
        }
        if (p.xout) *reinterpret_cast<float2*>(p.xout + row + ni * 8) = make_float2(v0, v1);
        if (p.act)
          *reinterpret_cast<__nv_bfloat162*>(p.act + row + ni * 8) =
              __floats2bfloat162_rn(lrelu(v0, p.slope), lrelu(v1, p.slope));
      }
    }
  }
}

// Eight consecutive elements of a bf16 or f32 tensor as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* src, long long i, float* v) {
  const uint4 raw = reinterpret_cast<const uint4*>(src)[i];
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* src, long long i, float* v) {
  const float4 lo = reinterpret_cast<const float4*>(src)[2 * i];
  const float4 hi = reinterpret_cast<const float4*>(src)[2 * i + 1];
  v[0] = lo.x, v[1] = lo.y, v[2] = lo.z, v[3] = lo.w;
  v[4] = hi.x, v[5] = hi.y, v[6] = hi.z, v[7] = hi.w;
}

// The pointwise passes at the MRF's edges, over a channels-last tensor of
// n8 groups of 8 elements (C a multiple of 8), 8 elements a thread:
// v = f32(src) (+ bias[c]); x0 = v where given; a0 = bf16(lrelu(v, slope))
// where given. mstts_mrf_in: the transposed convolution's bf16 output ->
// the stage's f32 input (its bias added in f32). mstts_mrf_act: an f32
// input -> the bf16 activation that the convolutions reading it take.
template <class In>
__global__ void mrf_pointwise_kernel(const In* __restrict__ src, const float* __restrict__ bias,
                                     float* __restrict__ x0, __nv_bfloat16* __restrict__ a0,
                                     long long n8, int C, float slope) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n8;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float v[8];
    load8(src, i, v);
    if (bias) {
      const int c0 = static_cast<int>((i * 8) % C);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += bias[c0 + j];
    }
    if (x0) {
      float4* xo = reinterpret_cast<float4*>(x0 + i * 8);
      xo[0] = make_float4(v[0], v[1], v[2], v[3]);
      xo[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    if (a0) {
      uint4 out;
      __nv_bfloat162* oh = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        oh[j] = __floats2bfloat162_rn(lrelu(v[2 * j], slope), lrelu(v[2 * j + 1], slope));
      reinterpret_cast<uint4*>(a0)[i] = out;
    }
  }
}

template <class In>
int pointwise(const In* src, const float* bias, float* x0, __nv_bfloat16* a0, long long n, int C,
              float slope, void* stream) {
  const long long n8 = n / 8;
  constexpr int kThreads = 256;
  const int blocks = static_cast<int>(n8 / kThreads + 1 < 132 * 16 ? n8 / kThreads + 1 : 132 * 16);
  mrf_pointwise_kernel<In><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      src, bias, x0, a0, n8, C, slope);
  MSTTS_RETURN_LAUNCH_ERROR();
}

template <class T>
int launch(const ConvArgs& p, int B, cudaStream_t stream) {
  const int smem = smem_bytes<T>((p.k - 1) * p.d);
  MSTTS_CHECK(cudaFuncSetAttribute(mrf_conv_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  const dim3 grid((p.L + T::TM - 1) / T::TM, T::C / T::TN, B);
  mrf_conv_kernel<T><<<grid, T::kThreads, smem, stream>>>(p);
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace

MSTTS_EXPORT int mstts_mrf_conv(const void* a, const void* w, const void* bias, const void* xin,
                                const void* sum, void* xout, void* act, int B, int L, int C,
                                int k, int d, float slope, float div, void* stream) {
  const ConvArgs p{static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w),
                   static_cast<const float*>(bias), static_cast<const float*>(xin),
                   static_cast<const float*>(sum), static_cast<float*>(xout),
                   static_cast<__nv_bfloat16*>(act), L, k, d, slope, div};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 32: return launch<Tile32>(p, B, s);
    case 64: return launch<Tile64>(p, B, s);
    case 128: return launch<Tile128>(p, B, s);
    case 256: return launch<Tile256>(p, B, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

MSTTS_EXPORT int mstts_mrf_in(const void* y, const void* bias, void* x0, long long n, int C,
                              void* stream) {
  return pointwise(static_cast<const __nv_bfloat16*>(y), static_cast<const float*>(bias),
                   static_cast<float*>(x0), nullptr, n, C, 0.f, stream);
}

MSTTS_EXPORT int mstts_mrf_act(const void* x, void* a0, long long n, float slope, void* stream) {
  return pointwise(static_cast<const float*>(x), nullptr, nullptr,
                   static_cast<__nv_bfloat16*>(a0), n, 8, slope, stream);
}
