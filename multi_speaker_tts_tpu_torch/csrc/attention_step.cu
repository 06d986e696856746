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
// them. The products run here as f32 FMAs on the CUDA cores.
//
// What bounds it on an H100: at the probe's shapes (B 96, S 100, A 128,
// D 512, H 1024, K 31, C 32) a step moves 25.9 MB once (memory 19.7 MB,
// keys 4.9 MB) for ~157 MFLOP: 7.7 us by bytes. This design moves ~36 MB
// through L2 (every cluster reads all of wq, every block its rows of h0 and
// wloc) and runs as a chain of dependent phases on each SM: q's loads (about
// 10 MB across the SMs at once), the conv and the energies on the CUDA cores
// (the energies' shared-memory reads of wloc and loc), the context, and
// three cluster barriers (tools/attention_stamps.py prints each phase's time
// on the card; PERF.md, PR 10).
//
// Design: a thread-block cluster of kCluster blocks (one an SM) takes R
// batch rows (R from the host: the fewest rows a cluster that keep the
// clusters within what the card holds at once, at most kMaxRows); block j
// of the cluster owns the positions s0 .. s1 of the rows (S split in
// kCluster runs) and, for q, attention units j A / kCluster ..
// (j + 1) A / kCluster.
// - q: wq is read through L2 once a cluster, not once a row: a block reads
//   its column slice of wq and forms those q columns for all R rows; the
//   slices meet through distributed shared memory (cluster barrier 1, its
//   arrival before the conv and its wait after).
// - As soon as its q loads are in, one thread has the TMA unit copy wloc,
//   v, the block's keys (one bulk copy a row: its positions are contiguous)
//   and its memory (one bulk copy a chunk of positions of a row, through a
//   ring of slots the host sizes; where the ring holds every chunk, all of
//   them) into shared memory, on mbarriers. They share the SM's port to L2
//   with q's loads, which the step waits on first; they land during q's
//   reduction, the conv and the energies.
// - Location conv (lanes over (row, position) items, eight channels a warp
//   task, both taps in one chain a channel), then the energies: a warp
//   takes a run of up to 4 items (one tile; more spill registers), lanes
//   own float4 groups of attention units: the location projection against
//   wloc in shared memory, tanh, v and a warp sum an item.
// - Softmax over a row's positions across the cluster: each block takes the
//   max m_j and sum l_j of exp(e - m_j) over its positions and the
//   unnormalised context partial sum_s exp(e[s] - m_j) memory[s, :] over
//   them, as the memory chunks arrive (every chunk one sequential chain of
//   FMAs, so the sum order does not depend on the ring; where a chunk is a
//   row's whole run, several rows at once). Cluster barrier 2; every block
//   reads the kCluster (m_j, l_j) of a row, forms m = max m_j and
//   L = sum_j l_j exp(m_j - m), writes w = exp(e - m) / L and cum for its
//   positions, and sums the context of its D / kCluster columns over the
//   kCluster partials, scaled by exp(m_j - m) / L. Cluster barrier 3 keeps
//   every block's shared memory alive until the others have read it.
// Every sum runs in a fixed order: a repeat is bit-equal, and a row's
// outputs do not depend on R, the ring or which cluster takes it.
// expf for the softmax; the energies' tanh from ex2 / rcp (fast_tanh).
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;
constexpr int kMaxChannels = 32;
constexpr int kMaxA = 512;
constexpr int kMaxS = 256;
constexpr int kMaxSlots = 15;
constexpr int kTile = 4;  // items a warp tile of the energies (8 spills)
constexpr int kSmemLimit = 232448;

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

// tanh from the ex2 and rcp approximations (as the BiGRU kernels' cell):
// about 1e-7 absolute error, where tanhf is a long branchy sequence and the
// energies take 128 of them an item.
__device__ __forceinline__ float fast_tanh(float x) {
  return 2.0f * __fdividef(1.0f, 1.0f + __expf(-2.0f * x)) - 1.0f;
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
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
  int R;      // batch rows a cluster
  int chunk;  // positions a memory chunk
  int slots;  // memory ring slots
};

__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~size_t(127); }

// Byte offsets of a block's shared-memory regions, in order (each aligned
// to 128 bytes). ops/attention_step_kernel.py::smem_bytes mirrors the sizes.
struct Layout {
  int Sc, cols4, cols4p, Cp;
  size_t keys;   // [R][Sc][A] keys, then [R][D] context partials
  size_t ring;   // [slots][chunk][D] memory chunks
  size_t wloc;   // [Cp][A], rows past C zero
  size_t ck;     // [K][Cp] float2 (w tap, cum tap), channels past C zero
  size_t v;      // [A]
  size_t q;      // [R][A]
  size_t qpart;  // [R][A / kCluster] this block's q columns
  size_t qred;   // [kWarps][R][cols4p] float4 q partials, then [R][Sc][Cp] loc
  size_t win;    // [2][R][Sc + K - 1] wp, cp windows
  size_t e;      // [R][Sc] energies
  size_t p;      // [R][Sc] exp(e - m_j)
  size_t stats;  // [R] float2 (m_j, l_j)
  size_t bars;   // [1 + slots] mbarriers: keys, then one a ring slot
  size_t total;
};

__host__ __device__ inline Layout make_layout(int S, int A, int D, int K, int C, int R,
                                              int chunk, int slots) {
  Layout L;
  L.Sc = (S + kCluster - 1) / kCluster;
  L.cols4 = A / (4 * kCluster);
  L.cols4p = 1;
  while (L.cols4p < L.cols4) L.cols4p <<= 1;
  L.Cp = (C + 7) / 8 * 8;
  const size_t f = sizeof(float);
  const size_t keys = (size_t)R * L.Sc * A > (size_t)R * D ? (size_t)R * L.Sc * A : (size_t)R * D;
  const size_t qred = (size_t)kWarps * R * L.cols4p * 4;
  const size_t loc = (size_t)R * L.Sc * L.Cp;
  size_t off = 0;
  L.keys = off;  off = align128(off + f * keys);
  L.ring = off;  off = align128(off + f * (size_t)slots * chunk * D);
  L.wloc = off;  off = align128(off + f * (size_t)L.Cp * A);
  L.ck = off;    off = align128(off + 2 * f * (size_t)K * L.Cp);
  L.v = off;     off = align128(off + f * A);
  L.q = off;     off = align128(off + f * (size_t)R * A);
  L.qpart = off; off = align128(off + f * (size_t)R * (A / kCluster));
  L.qred = off;  off = align128(off + f * (qred > loc ? qred : loc));
  L.win = off;   off = align128(off + 2 * f * (size_t)R * (L.Sc + K - 1));
  L.e = off;     off = align128(off + f * (size_t)R * L.Sc);
  L.p = off;     off = align128(off + f * (size_t)R * L.Sc);
  L.stats = off; off = align128(off + 2 * f * R);
  L.bars = off;  off = align128(off + sizeof(uint64_t) * (1 + (size_t)slots));
  L.total = off;
  return L;
}

// The energies of ``T`` consecutive items (item = r * ns + position) of
// this block: lanes own float4 groups u of the attention units.
template <int T>
__device__ __forceinline__ void energy_tile(int it0, int ns, int A4, int Cp4,
                                            const float4* __restrict__ keys4, int kstride4,
                                            const float4* __restrict__ q4,
                                            const float4* __restrict__ wloc4,
                                            const float4* __restrict__ loc4,
                                            const float4* __restrict__ v4, float* e_s, int lane) {
  float part[T];
#pragma unroll
  for (int t = 0; t < T; ++t) part[t] = 0.0f;
  for (int u = lane; u < A4; u += 32) {
    float4 la[T];
#pragma unroll
    for (int t = 0; t < T; ++t) la[t] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 2
    for (int c4 = 0; c4 < Cp4; ++c4) {
      const float4 w0 = wloc4[(4 * c4 + 0) * A4 + u];
      const float4 w1 = wloc4[(4 * c4 + 1) * A4 + u];
      const float4 w2 = wloc4[(4 * c4 + 2) * A4 + u];
      const float4 w3 = wloc4[(4 * c4 + 3) * A4 + u];
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const float4 l = loc4[(it0 + t) * Cp4 + c4];
        la[t] = fma4(l.w, w3, fma4(l.z, w2, fma4(l.y, w1, fma4(l.x, w0, la[t]))));
      }
    }
    const float4 vv = v4[u];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = (it0 + t) / ns;
      const float4 qq = q4[r * A4 + u];
      const float4 kv = keys4[(size_t)r * kstride4 + (it0 + t - r * ns) * A4 + u];
      part[t] = fmaf(fast_tanh(qq.x + kv.x + la[t].x), vv.x, part[t]);
      part[t] = fmaf(fast_tanh(qq.y + kv.y + la[t].y), vv.y, part[t]);
      part[t] = fmaf(fast_tanh(qq.z + kv.z + la[t].z), vv.z, part[t]);
      part[t] = fmaf(fast_tanh(qq.w + kv.w + la[t].w), vv.w, part[t]);
    }
  }
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const float e = warp_sum(part[t]);
    if (lane == 0) e_s[it0 + t] = e;
  }
}

template <int T>
__device__ __forceinline__ void energy_tile_dispatch(int n, int it0, int ns, int A4, int Cp4,
                                                     const float4* keys4, int kstride4,
                                                     const float4* q4,
                                                     const float4* wloc4, const float4* loc4,
                                                     const float4* v4, float* e_s, int lane) {
  if constexpr (T > 1) {
    if (n < T) {
      energy_tile_dispatch<T - 1>(n, it0, ns, A4, Cp4, keys4, kstride4, q4, wloc4, loc4, v4, e_s,
                                  lane);
      return;
    }
  }
  energy_tile<T>(it0, ns, A4, Cp4, keys4, kstride4, q4, wloc4, loc4, v4, e_s, lane);
}

// The location conv of the block's items: loc[item][c] = sum_k wp[s+k]
// ck[k,0,c] + cp[s+k] ck[k,1,c], one chain a channel. Warp task (32 items,
// 8 channels), lane = item.
__device__ __forceinline__ void location_conv(int K, int n_items, int ns, int W, int Cp,
                                              const float* __restrict__ wp_s,
                                              const float* __restrict__ cp_s,
                                              const float2* __restrict__ ck_s,
                                              float* __restrict__ loc_s, int warp, int lane) {
  const int groups = Cp / 8, tasks = (n_items + 31) / 32 * groups;
  for (int task = warp; task < tasks; task += kWarps) {
    const int item = (task / groups) * 32 + lane, c0 = (task % groups) * 8;
    if (item >= n_items) continue;
    const int r = item / ns, sl = item - r * ns;
    const float* wpr = wp_s + r * W + sl;
    const float* cpr = cp_s + r * W + sl;
    const float4* kk = reinterpret_cast<const float4*>(ck_s + c0);
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.0f;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float x = wpr[k], y = cpr[k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 t = kk[k * (Cp / 2) + j];
        acc[2 * j] = fmaf(y, t.y, fmaf(x, t.x, acc[2 * j]));
        acc[2 * j + 1] = fmaf(y, t.w, fmaf(x, t.z, acc[2 * j + 1]));
      }
    }
    float4* dst = reinterpret_cast<float4*>(loc_s + (size_t)item * Cp + c0);
    dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
    dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 1)
    attention_step_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int S = a.S, A = a.A, D = a.D, H = a.H, K = a.K, C = a.C, R = a.R;
  const Layout L = make_layout(S, A, D, K, C, R, a.chunk, a.slots);
  const int A4 = A / 4, D4 = D / 4, Cp4 = L.Cp / 4, W = L.Sc + K - 1;
  const int Sp = S + K - 1, half = (K - 1) / 2;
  const int rstride = max(L.Sc * A, D);  // floats a row of the keys region
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b0 = (int)(blockIdx.x / kCluster) * R;
  const int rows = min(R, a.B - b0);
  const int s0 = min(S, rank * L.Sc), ns = min(S, s0 + L.Sc) - s0;
  const int nblk = (ns + a.chunk - 1) / a.chunk;
  const int nchunks = rows * nblk;

  float* keys_s = reinterpret_cast<float*>(smem + L.keys);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float4* wloc4 = reinterpret_cast<float4*>(smem + L.wloc);
  float2* ck_s = reinterpret_cast<float2*>(smem + L.ck);
  float* v_s = reinterpret_cast<float*>(smem + L.v);
  float4* q4 = reinterpret_cast<float4*>(smem + L.q);
  float4* qpart4 = reinterpret_cast<float4*>(smem + L.qpart);
  float4* qred4 = reinterpret_cast<float4*>(smem + L.qred);
  float* loc_s = reinterpret_cast<float*>(smem + L.qred);
  float* wp_s = reinterpret_cast<float*>(smem + L.win);
  float* cp_s = wp_s + (size_t)R * W;
  float* e_s = reinterpret_cast<float*>(smem + L.e);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float2* stats = reinterpret_cast<float2*>(smem + L.stats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L.bars);

  // Chunk c of the block's memory: row c / nblk, positions
  // s0 + (c % nblk) chunk .. (+ chunk), into ring slot c % slots.
  auto issue_chunk = [&](int c) {
    const int r = c / nblk, sa = (c % nblk) * a.chunk, n = min(ns - sa, a.chunk);
    uint64_t* bar = bars + 1 + c % a.slots;
    mstts_mbar_expect(bar, (uint32_t)(n * D * sizeof(float)));
    mstts_bulk_load(ring + (size_t)(c % a.slots) * a.chunk * D,
                    a.memory + ((size_t)(b0 + r) * S + s0 + sa) * D,
                    (uint32_t)(n * D * sizeof(float)), bar);
  };

  if (tid == 0) {
    for (int i = 0; i <= a.slots; ++i) mstts_mbar_init(bars + i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mstts_fence_proxy_async();
  }

  // Plain loads beside the copies: the padding rows of wloc, the conv taps
  // and the wp / cp windows (all issued before any is waited on).
  for (int i = C * A4 + tid; i < L.Cp * A4; i += kThreads)
    wloc4[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int i = tid; i < K * L.Cp; i += kThreads) {
    const int k = i / L.Cp, c = i - k * L.Cp;
    ck_s[i] = c < C ? make_float2(__ldg(a.ck + (2 * k) * C + c), __ldg(a.ck + (2 * k + 1) * C + c))
                    : make_float2(0.0f, 0.0f);
  }
  if (ns > 0) {
#pragma unroll 4
    for (int i = tid; i < rows * (ns + K - 1); i += kThreads) {
      const int r = i / (ns + K - 1), j = i - r * (ns + K - 1);
      wp_s[r * W + j] = __ldg(a.wp + (size_t)(b0 + r) * Sp + s0 + j);
      cp_s[r * W + j] = __ldg(a.cp + (size_t)(b0 + r) * Sp + s0 + j);
    }
  }

  // q, this block's columns: thread (col, p) owns float4 column col of the
  // slice over h = 4 p + j + 4 P i (j < 4); lanes of a column meet by
  // shuffles, the warps in shared memory, in a fixed order.
  {
    const int P = kThreads / L.cols4p;
    const int col = tid % L.cols4p, p = tid / L.cols4p;
    float4 acc[kMaxRows];
#pragma unroll
    for (int r = 0; r < kMaxRows; ++r) acc[r] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (col < L.cols4) {
      const float4* wq4 = reinterpret_cast<const float4*>(a.wq) + rank * L.cols4 + col;
      const float* h0 = a.h0 + (size_t)b0 * H;
      for (int h4 = 4 * p; h4 < H; h4 += 4 * P) {
        float4 wv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wv[j] = h4 + j < H ? __ldg(wq4 + (size_t)(h4 + j) * A4) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 0; r < kMaxRows; ++r) {
          if (r < rows) {
            float4 hv;  // h0[r, h4 .. h4 + 3]: one 16-byte load where the rows allow it
            if (H % 4 == 0) {
              hv = __ldg(reinterpret_cast<const float4*>(h0 + (size_t)r * H + h4));
            } else {
              const float* hr = h0 + (size_t)r * H + h4;
              hv = make_float4(__ldg(hr), h4 + 1 < H ? __ldg(hr + 1) : 0.0f,
                               h4 + 2 < H ? __ldg(hr + 2) : 0.0f, h4 + 3 < H ? __ldg(hr + 3) : 0.0f);
            }
            acc[r] = fma4(hv.w, wv[3], fma4(hv.z, wv[2], fma4(hv.y, wv[1], fma4(hv.x, wv[0], acc[r]))));
          }
        }
      }
    }
    // The copies, in the order the step needs them: wloc and v, the keys (one
    // a row, on bars[0]), then the memory chunks the ring holds. They share
    // the SM's port to L2 with q's loads, which the step waits on first: one
    // thread issues them once its own q loads are in (the others' are in
    // flight), and they land during q's reduction, the conv and the energies.
    if (tid == 0) {
      mstts_mbar_expect(bars, (uint32_t)((C * A + A + rows * ns * A) * sizeof(float)));
      mstts_bulk_load(wloc4, a.wloc, (uint32_t)(C * A * sizeof(float)), bars);
      mstts_bulk_load(v_s, a.v, (uint32_t)(A * sizeof(float)), bars);
      for (int r = 0; r < rows && ns > 0; ++r)
        mstts_bulk_load(keys_s + (size_t)r * rstride, a.keys + ((size_t)(b0 + r) * S + s0) * A,
                        (uint32_t)(ns * A * sizeof(float)), bars);
      for (int c = 0; c < min(nchunks, a.slots); ++c) issue_chunk(c);
    }
    for (int off = 16; off >= L.cols4p; off >>= 1) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r) {
        acc[r].x += __shfl_xor_sync(0xffffffffu, acc[r].x, off);
        acc[r].y += __shfl_xor_sync(0xffffffffu, acc[r].y, off);
        acc[r].z += __shfl_xor_sync(0xffffffffu, acc[r].z, off);
        acc[r].w += __shfl_xor_sync(0xffffffffu, acc[r].w, off);
      }
    }
    if (lane < L.cols4p) {
#pragma unroll
      for (int r = 0; r < kMaxRows; ++r)
        if (r < rows) qred4[(warp * R + r) * L.cols4p + lane] = acc[r];
    }
    __syncthreads();
    for (int i = tid; i < rows * L.cols4; i += kThreads) {
      const int r = i / L.cols4, c = i - r * L.cols4;
      float4 s = qred4[r * L.cols4p + c];
      for (int w = 1; w < kWarps; ++w) s = add4(s, qred4[(w * R + r) * L.cols4p + c]);
      qpart4[r * L.cols4 + c] = s;
    }
    __syncthreads();  // qred is read: loc takes its place
  }
  cluster_arrive();  // 1: this block's q columns are in (waited on below)

  const int n_items = rows * ns;
  location_conv(K, n_items, ns, W, L.Cp, wp_s, cp_s, ck_s, loc_s, warp, lane);
  cluster_wait();  // 1: every block's q columns are in
  for (int i = tid; i < rows * A4; i += kThreads) {
    const int r = i / A4, u = i - r * A4, owner = u / L.cols4;
    const float4* remote = cluster.map_shared_rank(qpart4, owner);
    q4[i] = remote[r * L.cols4 + (u - owner * L.cols4)];
  }
  mstts_mbar_wait(bars, 0);  // wloc, v and the keys are in
  __syncthreads();

  // Energies: warp w takes items [w n / kWarps, (w + 1) n / kWarps) in tiles
  // of at most kTile.
  {
    const int lo = warp * n_items / kWarps, hi = (warp + 1) * n_items / kWarps;
    for (int it = lo; it < hi; it += kTile)
      energy_tile_dispatch<kTile>(min(kTile, hi - it), it, ns, A4, Cp4,
                                  reinterpret_cast<const float4*>(keys_s), rstride / 4, q4, wloc4,
                                  reinterpret_cast<const float4*>(loc_s),
                                  reinterpret_cast<const float4*>(v_s), e_s, lane);
  }
  __syncthreads();
  // The additive mask, then the block's softmax statistics: a warp a row
  // ((-inf, 0) for a block without positions).
  for (int i = tid; i < n_items; i += kThreads) {
    const int r = i / ns, sl = i - r * ns;
    e_s[i] += __ldg(a.maskadd + (size_t)(b0 + r) * S + s0 + sl);
  }
  __syncthreads();
  if (warp < rows) {
    const int r = warp;
    float m = -INFINITY;
    for (int sl = lane; sl < ns; sl += 32) m = fmaxf(m, e_s[r * ns + sl]);
    m = warp_max(m);
    float l = 0.0f;
    for (int sl = lane; sl < ns; sl += 32) {
      const float x = expf(e_s[r * ns + sl] - m);
      p_s[r * ns + sl] = x;
      l += x;
    }
    l = warp_sum(l);
    if (lane == 0) stats[r] = make_float2(m, l);
  }
  __syncthreads();

  // Context partials over this block's positions, chunk by chunk as the
  // ring delivers them, into the row's (now spent) keys row: thread d4 owns
  // float4 column d4 of a row, one FMA chain over the positions. Where a
  // chunk is a row's whole run, G groups of D / 4 threads take G rows at
  // once (G at most the ring's slots, whose refills the earlier groups
  // issue). A block without positions leaves zeros.
  {
    const int G = nblk == 1 && D4 < kThreads ? min(kThreads / D4, a.slots) : 1;
    const int g = G > 1 ? tid / D4 : 0;
    const int d4_0 = G > 1 ? tid - g * D4 : tid, d4_step = G > 1 ? D4 : kThreads;
    for (int c0 = 0; c0 < nchunks; c0 += G) {
      const int c = c0 + g;
      if (g < G && c < nchunks) {
        const int r = c / nblk, sa = (c % nblk) * a.chunk, n = min(ns - sa, a.chunk);
        float4* part4 = reinterpret_cast<float4*>(keys_s + (size_t)r * rstride);
        mstts_mbar_wait(bars + 1 + c % a.slots, (uint32_t)((c / a.slots) & 1));
        const float4* mem4 =
            reinterpret_cast<const float4*>(ring + (size_t)(c % a.slots) * a.chunk * D);
        const float* pr = p_s + r * ns + sa;
        for (int d4 = d4_0; d4 < D4; d4 += d4_step) {
          float4 acc = sa == 0 ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : part4[d4];
#pragma unroll 4
          for (int s = 0; s < n; ++s) acc = fma4(pr[s], mem4[(size_t)s * D4 + d4], acc);
          part4[d4] = acc;
        }
      }
      __syncthreads();  // the round's slots are read: refill them
      if (tid == 0) {
        for (int cc = c0; cc < min(c0 + G, nchunks); ++cc) {
          if (cc + a.slots < nchunks) {
            mstts_fence_proxy_async();
            issue_chunk(cc + a.slots);
          }
        }
      }
    }
  }
  if (nchunks == 0) {
    for (int i = tid; i < rows * D4; i += kThreads)
      reinterpret_cast<float4*>(keys_s + (size_t)(i / D4) * rstride)[i % D4] =
          make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __syncthreads();
  cluster.sync();  // 2: every block's statistics and partials are in

  // The weights of this block's positions and the context of its D /
  // kCluster columns: each thread reads the kCluster (m_j, l_j) of its row
  // (and, for the context, the kCluster partials of its column) before using
  // any, forms m = max m_j, the scales exp(m_j - m) and L in rank order.
  auto row_stats = [&](int r, float* scale, float& m, float& total) {
    float2 st[kCluster];
#pragma unroll
    for (int j = 0; j < kCluster; ++j) st[j] = cluster.map_shared_rank(stats, j)[r];
    m = -INFINITY;
#pragma unroll
    for (int j = 0; j < kCluster; ++j) m = fmaxf(m, st[j].x);
    total = 0.0f;
#pragma unroll
    for (int j = 0; j < kCluster; ++j) {
      scale[j] = expf(st[j].x - m);
      total += st[j].y * scale[j];
    }
  };
  for (int i = tid; i < n_items; i += kThreads) {
    const int r = i / ns, sl = i - r * ns;
    float scale[kCluster], m, total;
    row_stats(r, scale, m, total);
    const float x = expf(e_s[i] - m) / total;
    const size_t o = (size_t)(b0 + r) * S + s0 + sl;
    a.w_out[o] = x;
    a.cum_out[o] = cp_s[r * W + half + sl] + x;
  }
  const int dc4 = D4 / kCluster;
  for (int i = tid; i < rows * dc4; i += kThreads) {
    const int r = i / dc4, d4 = rank * dc4 + (i - r * dc4);
    float4 x[kCluster];
#pragma unroll
    for (int j = 0; j < kCluster; ++j)
      x[j] = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(keys_s, j) + (size_t)r * rstride)[d4];
    float scale[kCluster], m, total;
    row_stats(r, scale, m, total);
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int j = 0; j < kCluster; ++j) acc = fma4(scale[j], x[j], acc);
    reinterpret_cast<float4*>(a.ctx_out + (size_t)(b0 + r) * D)[d4] =
        make_float4(acc.x / total, acc.y / total, acc.z / total, acc.w / total);
  }
  cluster.sync();  // 3: no block leaves while another reads its shared memory
}

}  // namespace

// Dims as (S, A, D, K, C, R, chunk, slots) -> the shared memory a block
// needs (ops/attention_step_kernel.py::smem_bytes mirrors it; a card test
// holds the two equal).
MSTTS_EXPORT int mstts_attention_smem_bytes(const int* dims, long long* out) {
  *out = (long long)make_layout(dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6],
                                dims[7]).total;
  return 0;
}

// The most clusters of the kernel that the card holds at once, at one block
// an SM and the most shared memory a block may have.
MSTTS_EXPORT int mstts_attention_max_clusters(int* out) {
  MSTTS_CHECK(cudaFuncSetAttribute(attention_step_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * 256, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = kSmemLimit;
  MSTTS_CHECK(cudaOccupancyMaxActiveClusters(out, attention_step_kernel, &cfg));
  return 0;
}

// Pointers as (h0, wp, cp, keys, memory, maskadd, wq, ck, wloc, v, w_out,
// cum_out, ctx_out); dims as (B, S, A, D, H, K, C, R, chunk, slots). The
// wrapper checks the widths and picks R, chunk and slots
// (ops/attention_step_kernel.py::kernel_plan); this is the last guard.
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
  a.R = dims[7];
  a.chunk = dims[8];
  a.slots = dims[9];
  if (a.B < 1 || a.S < 1 || a.S > kMaxS || a.A % 32 || a.A > kMaxA || a.D % 32 || a.D < 32 ||
      a.C < 1 || a.C > kMaxChannels || a.K < 1 || a.H < 1 || a.R < 1 || a.R > kMaxRows ||
      a.chunk < 1 || a.slots < 1 || a.slots > kMaxSlots)
    return (int)cudaErrorInvalidValue;
  const size_t smem = make_layout(a.S, a.A, a.D, a.K, a.C, a.R, a.chunk, a.slots).total;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  static bool opted_in = false;  // to the card's most shared memory a block
  if (!opted_in) {
    MSTTS_CHECK(cudaFuncSetAttribute(attention_step_kernel,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit));
    opted_in = true;
  }
  const int clusters = (a.B + a.R - 1) / a.R;
  attention_step_kernel<<<clusters * kCluster, kThreads, smem, (cudaStream_t)stream>>>(a);
  MSTTS_RETURN_LAUNCH_ERROR();
}
