// One location-sensitive attention step and its context, fused.
//
// Replaces tools/attention_probe.py::make_pallas_loop (kernel body
// _fused_attn_kernel), the probe's fused decoder attention step. For each
// batch row b (everything f32):
//   q      = h0[b] @ wq                                          (A)
//   loc[s] = sum_k wp[b, s+k] * ck[k,0,:] + cp[b, s+k] * ck[k,1,:]  (C)
//   e[s]   = sum_a v[a] * tanh(q[a] + keys[b,s,a] + (loc[s] @ wloc)[a])
//            + maskadd[b, s]
//   w      = softmax(e),  cum = cp[b, half : half+S] + w
//   ctx    = sum_s w[s] * memory[b, s, :]                        (D)
// with wp / cp the previous weights and cumulative weights padded with
// half = (K-1)/2 zeros in front and K-1-half behind, as the TPU kernel takes
// them. The three products run here, as f32 FMAs on the CUDA cores.
//
// What bounds it on an H100: at the probe's shapes (B 96, S 100, A 128,
// D 512, H 1024, K 31, C 32) a step moves 25.9 MB once (memory 19.7 MB,
// keys 4.9 MB) for ~157 MFLOP: 7.7 us by bytes. In a loop of steps the keys
// and memory (24.6 MB) stay in the 50 MB L2.
//
// Design: one block of kThreads per R batch rows (R = 1, 2 or 4). The
// block stages h0's rows, the padded wp / cp rows, the conv kernel (taps of
// wp and cp interleaved), wloc and v in shared memory.
// - q: thread (col, p) owns four neighbouring attention units (a float4 of
//   a wq row) over the slice h = p, p + P, ... of H; the slices' partial
//   sums meet in shared memory. Every block reads all of wq (512 KB at the
//   probe's shapes) through L2 for its R rows: at R = 1 that is 50 MB of L2
//   traffic a step, so the loop keeps eight 16-byte loads in flight a
//   thread.
// - Energies, as the decode kernel's attention phase (decode.cu): a warp
//   takes kPos positions at a time; lane c computes location channel c
//   (C <= 32) for all of them with the taps of wp and cp in two separate
//   chains, the channels go through a per-warp shared buffer, then each
//   lane owns float4 groups of attention units: the location projection,
//   q + keys + loc, tanhf, v and a warp sum per position.
// - Softmax: a warp per row (max, expf, sum, divide, as jax.nn.softmax).
// - Context: float4 columns of the memory rows, the positions split over
//   thread groups whose partial sums meet in shared memory.
// tanhf / expf throughout, never the approximate intrinsics.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kPos = 4;          // positions a warp takes at a time
constexpr int kMaxChannels = 32;  // C <= 32: one lane per location channel
constexpr int kMaxA = 512;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float4 fma4(float x, float4 w, float4 acc) {
  acc.x = fmaf(x, w.x, acc.x);
  acc.y = fmaf(x, w.y, acc.y);
  acc.z = fmaf(x, w.z, acc.z);
  acc.w = fmaf(x, w.w, acc.w);
  return acc;
}

struct Args {
  const float* h0;       // (B, H)
  const float* wp;       // (B, S + K - 1)
  const float* cp;       // (B, S + K - 1)
  const float* keys;     // (B, S, A)
  const float* memory;   // (B, S, D)
  const float* maskadd;  // (B, S)
  const float* wq;       // (H, A)
  const float* ck;       // (K, 2, C)
  const float* wloc;     // (C, A)
  const float* v;        // (A)
  float* w_out;          // (B, S)
  float* cum_out;        // (B, S)
  float* ctx_out;        // (B, D)
  int B, S, A, D, H, K, C;
};

// Shared memory of one block, in floats. The float4 arrays come first.
__host__ __device__ inline size_t smem_floats(int R, int S, int A, int H, int K, int C) {
  return (size_t)R * 4 * kThreads + (size_t)C * A + A + (size_t)R * A + (size_t)kWarps * C * 4 +
         2 * (size_t)K * C + (size_t)R * H + 2 * (size_t)R * (S + K - 1) + (size_t)R * S;
}

template <int R>
__global__ void __launch_bounds__(kThreads) attention_step_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int S = a.S, A = a.A, D = a.D, H = a.H, K = a.K, C = a.C;
  const int Sp = S + K - 1, half = (K - 1) / 2, A4 = A / 4;
  float* part_s = smem;                                              // [R * 4 * kThreads]
  float4* wloc4 = reinterpret_cast<float4*>(part_s + R * 4 * kThreads);  // [C][A / 4]
  float4* v4 = wloc4 + C * A4;                                       // [A / 4]
  float4* q4 = v4 + A4;                                              // [R][A / 4]
  float4* loc4_all = q4 + R * A4;                                    // [kWarps][C]
  float2* ck_s = reinterpret_cast<float2*>(loc4_all + kWarps * C);   // [K][C] (w tap, cum tap)
  float* h_s = reinterpret_cast<float*>(ck_s + K * C);               // [R][H]
  float* wp_s = h_s + (size_t)R * H;                                 // [R][Sp]
  float* cp_s = wp_s + (size_t)R * Sp;                               // [R][Sp]
  float* e_s = cp_s + (size_t)R * Sp;                                // [R][S] energies, weights

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = blockIdx.x * R;
  const int rows = min(R, a.B - b0);

  for (int i = tid; i < R * H; i += kThreads)
    h_s[i] = i < rows * H ? __ldg(a.h0 + (size_t)b0 * H + i) : 0.0f;
  for (int i = tid; i < R * Sp; i += kThreads) {
    const bool in = i < rows * Sp;
    wp_s[i] = in ? __ldg(a.wp + (size_t)b0 * Sp + i) : 0.0f;
    cp_s[i] = in ? __ldg(a.cp + (size_t)b0 * Sp + i) : 0.0f;
  }
  for (int i = tid; i < K * C; i += kThreads) {
    const int k = i / C, c = i - k * C;
    ck_s[i] = make_float2(__ldg(a.ck + (2 * k) * C + c), __ldg(a.ck + (2 * k + 1) * C + c));
  }
  for (int i = tid; i < C * A4; i += kThreads)
    wloc4[i] = __ldg(reinterpret_cast<const float4*>(a.wloc) + i);
  for (int i = tid; i < A4; i += kThreads) v4[i] = __ldg(reinterpret_cast<const float4*>(a.v) + i);
  __syncthreads();

  // q = h0 @ wq: thread (col, p) owns units 4col..4col+3 over h = p, p + P, ...
  {
    const int P = max(1, kThreads / A4);
    const float4* wq4 = reinterpret_cast<const float4*>(a.wq);
    for (int i = tid; i < A4 * P; i += kThreads) {
      const int col = i % A4, p = i / A4;
      float4 acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int h = p; h < H; h += P) {
        const float4 wv = __ldg(wq4 + (size_t)h * A4 + col);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fma4(h_s[r * H + h], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        reinterpret_cast<float4*>(part_s)[(p * R + r) * A4 + col] = acc[r];
    }
    __syncthreads();
    for (int i = tid; i < R * A4; i += kThreads) {
      float4 s = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int p = 0; p < P; ++p) {
        const float4 x = reinterpret_cast<const float4*>(part_s)[p * R * A4 + i];
        s.x += x.x;
        s.y += x.y;
        s.z += x.z;
        s.w += x.w;
      }
      q4[i] = s;
    }
    __syncthreads();
  }

  // Energies: warp-wide groups of kPos (row, position) items, item = r * S + s.
  {
    float4* loc4 = loc4_all + warp * C;
    const int n = rows * S;
    const float4* keys4 = reinterpret_cast<const float4*>(a.keys) + (size_t)b0 * S * A4;
    for (int base = warp; base < n; base += kWarps * kPos) {
      int it[kPos];  // items past the end repeat the last one and are dropped
#pragma unroll
      for (int p = 0; p < kPos; ++p) it[p] = min(base + kWarps * p, n - 1);
      if (lane < C) {
        float aw[kPos], ac[kPos];
#pragma unroll
        for (int p = 0; p < kPos; ++p) aw[p] = ac[p] = 0.0f;
        for (int k = 0; k < K; ++k) {
          const float2 kk = ck_s[k * C + lane];
#pragma unroll
          for (int p = 0; p < kPos; ++p) {
            const int r = it[p] / S, o = r * Sp + (it[p] - r * S) + k;
            aw[p] = fmaf(wp_s[o], kk.x, aw[p]);
            ac[p] = fmaf(cp_s[o], kk.y, ac[p]);
          }
        }
        loc4[lane] = make_float4(aw[0] + ac[0], aw[1] + ac[1], aw[2] + ac[2], aw[3] + ac[3]);
      }
      __syncwarp();
      float part[kPos];
#pragma unroll
      for (int p = 0; p < kPos; ++p) part[p] = 0.0f;
      for (int u = lane; u < A4; u += 32) {
        float4 kv[kPos], la[kPos];
#pragma unroll
        for (int p = 0; p < kPos; ++p) {
          kv[p] = __ldg(keys4 + (size_t)it[p] * A4 + u);
          la[p] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
#pragma unroll 4
        for (int c = 0; c < C; ++c) {
          const float4 l4 = loc4[c];
          const float l[kPos] = {l4.x, l4.y, l4.z, l4.w};
          const float4 wl = wloc4[c * A4 + u];
#pragma unroll
          for (int p = 0; p < kPos; ++p) la[p] = fma4(l[p], wl, la[p]);
        }
        const float4 vv = v4[u];
#pragma unroll
        for (int p = 0; p < kPos; ++p) {
          const float4 qq = q4[(it[p] / S) * A4 + u];
          part[p] = fmaf(tanhf(qq.x + kv[p].x + la[p].x), vv.x, part[p]);
          part[p] = fmaf(tanhf(qq.y + kv[p].y + la[p].y), vv.y, part[p]);
          part[p] = fmaf(tanhf(qq.z + kv[p].z + la[p].z), vv.z, part[p]);
          part[p] = fmaf(tanhf(qq.w + kv[p].w + la[p].w), vv.w, part[p]);
        }
      }
#pragma unroll
      for (int p = 0; p < kPos; ++p) {
        const float e = warp_sum(part[p]);
        if (lane == 0 && base + kWarps * p < n)
          e_s[it[p]] = e + __ldg(a.maskadd + (size_t)b0 * S + it[p]);
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // Softmax, weights and cumulative weights: a warp per row.
  if (warp < rows) {
    const int r = warp;
    const size_t o = (size_t)(b0 + r) * S;
    float m = -INFINITY;
    for (int s = lane; s < S; s += 32) m = fmaxf(m, e_s[r * S + s]);
    m = warp_max(m);
    float sum = 0.0f;
    for (int s = lane; s < S; s += 32) {
      const float x = expf(e_s[r * S + s] - m);
      e_s[r * S + s] = x;
      sum += x;
    }
    sum = warp_sum(sum);
    for (int s = lane; s < S; s += 32) {
      const float x = e_s[r * S + s] / sum;
      e_s[r * S + s] = x;
      a.w_out[o + s] = x;
      a.cum_out[o + s] = cp_s[r * Sp + half + s] + x;
    }
  }
  __syncthreads();

  // Context: thread (col, p) sums float4 column col over s = p, p + P, ...
  {
    const int cols = D / 4;
    const int P = max(1, kThreads / cols);
    for (int i = tid; i < cols * P; i += kThreads) {
      const int col = i % cols, p = i / cols;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (r < rows) {
          const float4* mem =
              reinterpret_cast<const float4*>(a.memory + (size_t)(b0 + r) * S * D) + col;
#pragma unroll 8
          for (int s = p; s < S; s += P) acc = fma4(e_s[r * S + s], __ldg(mem + (size_t)s * cols), acc);
        }
        if (P == 1) {
          if (r < rows) reinterpret_cast<float4*>(a.ctx_out + (size_t)(b0 + r) * D)[col] = acc;
        } else {
          reinterpret_cast<float4*>(part_s)[(p * R + r) * cols + col] = acc;
        }
      }
    }
    if (P > 1) {
      __syncthreads();
      for (int i = tid; i < rows * D; i += kThreads) {
        float s = 0.0f;
        for (int p = 0; p < P; ++p) s += part_s[p * R * D + i];
        a.ctx_out[(size_t)b0 * D + i] = s;
      }
    }
  }
}

template <int R>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(R, a.S, a.A, a.H, a.K, a.C);
  if (smem > 48 * 1024) {
    MSTTS_CHECK(cudaFuncSetAttribute(attention_step_kernel<R>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  }
  const int blocks = (a.B + R - 1) / R;
  attention_step_kernel<R><<<blocks, kThreads, smem, stream>>>(a);
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace

// Pointers as (h0, wp, cp, keys, memory, maskadd, wq, ck, wloc, v, w_out,
// cum_out, ctx_out); dims as (B, S, A, D, H, K, C, R). The wrapper checks
// the widths (ops/attention_step_kernel.py::shape_reason); this is the
// last guard, and a block over the card's shared memory fails in launch().
MSTTS_EXPORT int mstts_attention_step(void* const* ptrs, const int* dims, void* stream) {
  Args a;
  a.h0 = (const float*)ptrs[0];
  a.wp = (const float*)ptrs[1];
  a.cp = (const float*)ptrs[2];
  a.keys = (const float*)ptrs[3];
  a.memory = (const float*)ptrs[4];
  a.maskadd = (const float*)ptrs[5];
  a.wq = (const float*)ptrs[6];
  a.ck = (const float*)ptrs[7];
  a.wloc = (const float*)ptrs[8];
  a.v = (const float*)ptrs[9];
  a.w_out = (float*)ptrs[10];
  a.cum_out = (float*)ptrs[11];
  a.ctx_out = (float*)ptrs[12];
  a.B = dims[0];
  a.S = dims[1];
  a.A = dims[2];
  a.D = dims[3];
  a.H = dims[4];
  a.K = dims[5];
  a.C = dims[6];
  const int R = dims[7];
  if (a.B < 1 || a.S < 1 || a.A % 32 || a.A > kMaxA || a.D % 32 ||
      a.C < 1 || a.C > kMaxChannels || a.K < 1 || a.H < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (R) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
