// CBHG-head BiGRU backward on tensor cores: both directions' reverse
// recurrences and every batch row in one launch, no grid barrier.
//
// Replaces multi_speaker_tts_tpu/ops/birnn_pallas.py::_bigru_vjp_bwd
// (kernel body _bigru_bwd_kernel). From the forward's residuals per
// direction -- the hoisted input gates gx, gh = bf16(h).W_hh + b_hh and
// h_{t-1}, all bf16 in natural time (bigru.cu's residual mode) -- and the
// f32 output cotangents dy, it emits per direction the gate gradients
//   dGx = [dr, dz, dn],  dGh = [dr, dz, dn * r]      (T, B, 3H) bf16
// with r, z, n recomputed in f32 from the residuals, and carries
//   dh_{t-1} = dh * z + bf16(dGh) . W_hh^T
// in f32, as the TPU kernel does. The forward direction walks time in
// reverse and the backward direction natural time. dW_ih, dW_hh, db_ih,
// db_hh and dx are whole-sequence GEMMs and sums of the caller.
//
// What bounds it on an H100: the T dependent steps. Bytes (residuals,
// cotangents and dG, ~33 MB at T = 132, B = 32, H = 128: 0.01 ms) and
// operations are far below them. A step is one small product, bf16(dGh)
// [rows x 3H] . W_hh^T [3H x H], then the cell, and dGh has to reach every
// warp of the block before the next step's product. The product alone, with
// its barrier (barrier_floor.cu's mstts_gru_bwd_chain_floor), takes ~0.5 us
// a step at H = 128 on 8 SMs; what the SM's shared-memory pipe carries
// beside it decides the rest: every product warp reads all of bf16(dGh)
// (6 KB a step, 48 KB over the 8 warps), the cell's residual reads, and the
// copy-out of the outputs.
//
// Design (bigru.cu's, reversed; the product is bigru_step.cuh's, shared
// with the sequential floor in barrier_floor.cu):
// - One block per (direction, group of up to 8 batch rows): 2 x ceil(B / 8)
//   blocks (8 at B = 32). The step's product runs on tensor cores as
//   dh^T = W_hh . bf16(dGh)^T, mma.sync m16n8k16 with 16 hidden units as M,
//   the 8 rows as N and K = 3H (24 k-steps at H = 128, B read two k-steps
//   an ldmatrix), four accumulators a gate (k-step mod 4) added in a fixed
//   order: two launches on one input are bit-equal.
// - Product warps: H / 16, warp w owning 16 units. W_hh stays resident:
//   as A fragments in registers (96 at H = 128), above H = 128 partly in
//   shared memory. The thread that holds the accumulator of (unit u, row b)
//   runs the cell of that pair in registers with the f32 carry; its two
//   units are neighbours, so it reads its residuals and writes bf16(dGh)
//   and dn as pairs. The cell's coefficients (r, z, n and what they give
//   dz, dn, dr) do not depend on the carry; they are computed after the
//   product, so that the accumulators and they are not live at once (at
//   H = 128 the block's 12 warps leave a thread 168 registers). bf16(dGh)
//   goes to a double-buffered shared B operand (row stride an odd multiple
//   of 16 bytes: conflict-free ldmatrix and stores), dn to a second buffer;
//   one __syncthreads a step publishes both.
// - A copy warpgroup keeps the memory traffic off the product warps: one
//   thread has the TMA unit copy each step's residuals (gx, gh, h_{t-1} and
//   dy of the 8 rows, 18 KB at H = 128: four bulk copies, one an array)
//   into a ring of shared slots (four, two at H = 192) three steps ahead,
//   on the slot's mbarrier; and the warpgroup copies the previous step's
//   dGh and dGx rows from the operand buffers to global memory, every
//   16-byte load of a thread before its stores. (Copies row by row, 32 a
//   step, made the TMA unit the bottleneck; cp.async issued by the product
//   warps, or by the copy warps, cost more than the product.)
//
// Per-step dependent chain: ldmatrix of dGh, H / 64 dependent MMAs a
// gate's accumulator, the fixed-order adds, the residual reads and the
// cell, the bf16 stores and the block barrier.
//
// Shapes: those of the residual-mode forward, H % 16 == 0 and
// 16 <= H <= 192 (the wrapper's bigru_bwd_shape_reason refuses anything
// else before launch).
#include "bigru_step.cuh"

namespace {

constexpr int kRows = kGruRows;
constexpr int kSmemMax = 232448;  // bytes of shared memory a block may opt into on an H100

struct BwdArgs {
  const __nv_bfloat16* gx[2];  // (T, B, 3H) input gates
  const __nv_bfloat16* gh[2];  // (T, B, 3H) recurrent gates
  const __nv_bfloat16* hp[2];  // (T, B, H) h_{t-1}
  const __nv_bfloat16* w[2];   // (H, 3H) W_hh
  const float* dy[2];          // (T, B, H) output cotangents
  __nv_bfloat16* dgx[2];       // (T, B, 3H)
  __nv_bfloat16* dgh[2];       // (T, B, 3H)
  int T, B, groups;            // groups: row groups per direction
};

// A residual ring slot: the 8 rows of gx (3H bf16), of gh, of h_{t-1} (H
// bf16) and of dy (H f32), each array's rows contiguous as in global memory,
// so that one bulk copy an array fills it. res_off: array k's row r.
__host__ __device__ constexpr int res_row_bytes(int H) { return 18 * H; }
__host__ __device__ constexpr int res_off(int H, int k, int r) {
  return k == 0 ? 6 * H * r : k == 1 ? 48 * H + 6 * H * r : k == 2 ? 96 * H + 2 * H * r
                                                                  : 112 * H + 4 * H * r;
}

// Shared memory besides the ring: the dGh and dn buffers, double-buffered,
// W_hh's shared k-steps and the ring's mbarriers.
__host__ __device__ constexpr size_t fixed_bytes(int H) {
  return sizeof(__nv_bfloat16) * (2 * kRows * (size_t)mstts_ldmatrix_stride(3 * H) +
                                  2 * kRows * (size_t)mstts_ldmatrix_stride(H) +
                                  gru_wsmem_elems(H, true)) +
         4 * sizeof(uint64_t);
}

// Ring slots: four where they fit, else as many as do.
__host__ __device__ constexpr int ring_slots(int H) {
  const int fit = (int)((kSmemMax - fixed_bytes(H)) / ((size_t)kRows * res_row_bytes(H)));
  return fit < 4 ? fit : 4;
}

__host__ __device__ constexpr size_t bwd_smem_bytes(int H) {
  return (size_t)ring_slots(H) * kRows * res_row_bytes(H) + fixed_bytes(H);
}

__device__ __forceinline__ float2 bf16x2_to_float2(const void* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// The block: the product's KS warps (one per 16 units), then four copy warps.
__host__ __device__ constexpr int block_threads(int KS) { return 32 * (KS + 4); }

template <int KS>
__global__ void __launch_bounds__(block_threads(KS), 1) bigru_bwd_kernel(BwdArgs a) {
  constexpr int H = 16 * KS, H3 = 3 * H, NT = block_threads(KS);
  constexpr int RB = res_row_bytes(H), kSlots = ring_slots(H);
  constexpr int GS = mstts_ldmatrix_stride(H3), NS = mstts_ldmatrix_stride(H);
  static_assert(kSlots >= 2, "the residual ring needs two slots");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* ring = smem_raw;  // [kSlots][kRows][RB]
  // [2][kRows][GS]
  __nv_bfloat16* dgh_s = reinterpret_cast<__nv_bfloat16*>(ring + kSlots * kRows * RB);
  __nv_bfloat16* dn_s = dgh_s + 2 * kRows * GS;  // [2][kRows][NS]
  __nv_bfloat16* w_s = dn_s + 2 * kRows * NS;    // [3][H][gru_wsmem_stride] above H = 128
  uint64_t* ring_bar = reinterpret_cast<uint64_t*>(w_s + gru_wsmem_elems(H, true));  // [kSlots]

  const int dir = blockIdx.x / a.groups;
  const int r0 = (blockIdx.x % a.groups) * kRows;
  const int rows = min(kRows, a.B - r0);
  const int T = a.T, B = a.B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, tq = lane & 3;
  const bool copier = warp >= KS;
  const int ct = threadIdx.x - 32 * KS;  // a copy thread's index, 0..127
  // Runtime indexing of the argument arrays would copy them to the stack.
  const __nv_bfloat16* gx = dir == 0 ? a.gx[0] : a.gx[1];
  const __nv_bfloat16* gh = dir == 0 ? a.gh[0] : a.gh[1];
  const __nv_bfloat16* hp = dir == 0 ? a.hp[0] : a.hp[1];
  const __nv_bfloat16* w = dir == 0 ? a.w[0] : a.w[1];
  const float* dy = dir == 0 ? a.dy[0] : a.dy[1];
  __nv_bfloat16* dgx = dir == 0 ? a.dgx[0] : a.dgx[1];
  __nv_bfloat16* dgh = dir == 0 ? a.dgh[0] : a.dgh[1];

  // Zero the ring (rows past `rows` stay zero: a padding row computes zeros)
  // and the operand buffers; W_hh's shared k-steps.
  constexpr int kZero = kSlots * kRows * RB / 16 + 2 * kRows * (GS + NS) / 8;  // 16-byte chunks
  for (int i = threadIdx.x; i < kZero; i += NT)
    reinterpret_cast<uint4*>(smem_raw)[i] = make_uint4(0u, 0u, 0u, 0u);
  GruProduct<KS, true>::load_rows(w, w_s);
  if (threadIdx.x < kSlots) mstts_mbar_init(ring_bar + threadIdx.x);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  mstts_fence_proxy_async();  // the zeroed ring, written by the copies
  __syncthreads();

  // Copy warps: the residuals of step s (time t) into ring slot s % kSlots
  // by the TMA unit, on the slot's mbarrier (issued by one copy warp); and
  // step sp's dGh and dGx rows, complete in buffer sp % 2 since the barrier
  // that ended step sp, to global memory in 16-byte stores.
  auto stage = [&](int s) {
    if (s >= T || ct != 0) return;
    const int t = dir == 0 ? T - 1 - s : s;
    const size_t row0 = (size_t)t * B + r0;
    unsigned char* slot = ring + (s % kSlots) * kRows * RB;
    uint64_t* bar = ring_bar + s % kSlots;
    mstts_mbar_expect(bar, rows * 18 * H);
    mstts_bulk_load(slot + res_off(H, 0, 0), gx + row0 * H3, rows * 6 * H, bar);
    mstts_bulk_load(slot + res_off(H, 1, 0), gh + row0 * H3, rows * 6 * H, bar);
    mstts_bulk_load(slot + res_off(H, 2, 0), hp + row0 * H, rows * 2 * H, bar);
    mstts_bulk_load(slot + res_off(H, 3, 0), dy + row0 * H, rows * 4 * H, bar);
  };
  auto ring_wait = [&](int s) { mstts_mbar_wait(ring_bar + s % kSlots, (s / kSlots) & 1); };
  auto store_outputs = [&](int sp) {
    const int t = dir == 0 ? T - 1 - sp : sp;
    const __nv_bfloat16* hs = dgh_s + (sp & 1) * kRows * GS;
    const __nv_bfloat16* ns = dn_s + (sp & 1) * kRows * NS;
    // A row's 16-byte chunks: the 3H / 8 of dGh ([dr, dz] of them also
    // dGx's), then dGx's H / 8 of dn.
    constexpr int CH = H3 / 8, CZ = 2 * H / 8, C = CH + H / 8;
    constexpr int N = kRows * C, PER = (N + 127) / 128;  // a copy thread's chunks
    uint4 v[PER];
    int at[PER];  // the chunk's offset in a row of dGh and dGx, or -1
#pragma unroll
    for (int k = 0; k < PER; ++k) {  // every load first, then the stores
      const int i = ct + 128 * k, r = i / C, c = i - r * C;
      at[k] = -1;
      if (i < N && r < rows) {
        v[k] = *reinterpret_cast<const uint4*>(c < CH ? hs + r * GS + 8 * c
                                                      : ns + r * NS + 8 * (c - CH));
        at[k] = (r0 + r) * H3 + 8 * (c < CH ? c : c - CH + CZ);
      }
    }
    const size_t base = (size_t)t * B * H3;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      if (at[k] < 0) continue;
      const int c = (ct + 128 * k) % C;
      if (c < CH) *reinterpret_cast<uint4*>(dgh + base + at[k]) = v[k];
      if (c < CZ || c >= CH) *reinterpret_cast<uint4*>(dgx + base + at[k]) = v[k];
    }
  };

  if (copier) {
    // Steps 0 .. kSlots - 2 in flight.
    for (int s = 0; s < kSlots - 1; ++s) stage(s);
    __syncthreads();
    for (int s = 0; s < T; ++s) {
      if (s > 0) store_outputs(s - 1);
      stage(s + kSlots - 1);  // into the slot that step s - 1 read
      __syncthreads();
    }
    store_outputs(T - 1);
    return;
  }

  // Product warps. This thread's cells: units u0 = 16w + 2g and u0 + 1
  // (neighbours, see bigru_step.cuh), rows 2t and 2t + 1; element
  // e = 2 * (unit) + (row), the C fragment's order. The coefficients of step
  // s's cell depend on its residuals alone: dz = dh cz, dn = dh cn,
  // dr = dh cdr, dn r = dh cnr.
  GruProduct<KS, true> product;
  product.load_regs(w, w_s);
  const int u0 = 16 * warp + 2 * g8;
  const __nv_bfloat16* hB = dgh_s + (lane & 7) * GS + (lane >> 3) * 8;
  float dhz[4] = {};  // dh * z of the step before, f32
  __syncthreads();
  for (int s = 0; s < T; ++s) {
    const int cur = s & 1;
    // bf16(dGh_{s-1}) . W_hh^T for this thread's (unit, row) pairs.
    float rec[4] = {};
    if (s > 0) {
      float acc[3][4][4] = {};
      product.run(acc, hB + (cur ^ 1) * kRows * GS);
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int q = 0; q < 3; ++q)
          rec[e] += (acc[q][0][e] + acc[q][1][e]) + (acc[q][2][e] + acc[q][3][e]);
    }

    // The cell's coefficients from this step's slot, landed before the last
    // barrier (after the product, so that the accumulators and the
    // coefficients are not live at once).
    float cz[4], cn[4], cdr[4], cnr[4], zv[4], dyv[4];
    ring_wait(s);
    const unsigned char* slot = ring + (s % kSlots) * kRows * RB;
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // row 2t + i, units u0 and u0 + 1
      const int r = 2 * tq + i;
      const __nv_bfloat16* gxr = reinterpret_cast<const __nv_bfloat16*>(slot + res_off(H, 0, r)) + u0;
      const __nv_bfloat16* ghr = reinterpret_cast<const __nv_bfloat16*>(slot + res_off(H, 1, r)) + u0;
      const float2 xr = bf16x2_to_float2(gxr), xz = bf16x2_to_float2(gxr + H),
                   xn = bf16x2_to_float2(gxr + 2 * H), hr = bf16x2_to_float2(ghr),
                   hz = bf16x2_to_float2(ghr + H), hn = bf16x2_to_float2(ghr + 2 * H),
                   hprev = bf16x2_to_float2(slot + res_off(H, 2, r) + 2 * u0),
                   d = *reinterpret_cast<const float2*>(slot + res_off(H, 3, r) + 4 * u0);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * j + i;
        const float ghn = j ? hn.y : hn.x, h_prev = j ? hprev.y : hprev.x;
        const float r = fast_sigmoid(j ? xr.y + hr.y : xr.x + hr.x);
        const float z = fast_sigmoid(j ? xz.y + hz.y : xz.x + hz.x);
        const float n = fast_tanh((j ? xn.y : xn.x) + r * ghn);
        cz[e] = (h_prev - n) * z * (1.0f - z);
        cn[e] = (1.0f - z) * (1.0f - n * n);
        cdr[e] = cn[e] * (ghn * r * (1.0f - r));
        cnr[e] = cn[e] * r;
        zv[e] = z;
        dyv[e] = j ? d.y : d.x;
      }
    }

    // The cell, for all four elements at once and without a branch; the
    // two units of a row are stored as one pair.
    __nv_bfloat16* hs = dgh_s + cur * kRows * GS;
    __nv_bfloat16* ns = dn_s + cur * kRows * NS;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float dh[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * j + i;
        dh[j] = (dhz[e] + rec[e]) + dyv[e];
        dhz[e] = dh[j] * zv[e];
      }
      auto pair = [&](const float* c) {
        return __floats2bfloat162_rn(dh[0] * c[i], dh[1] * c[2 + i]);
      };
      __nv_bfloat162* hr = reinterpret_cast<__nv_bfloat162*>(hs + (2 * tq + i) * GS + u0);
      hr[0] = pair(cdr);
      hr[H / 2] = pair(cz);
      hr[H] = pair(cnr);
      *reinterpret_cast<__nv_bfloat162*>(ns + (2 * tq + i) * NS + u0) = pair(cn);
    }
    __syncthreads();  // dGh_s is in its buffer for every warp
  }
}

template <int KS>
int launch(const BwdArgs& a, cudaStream_t stream) {
  constexpr size_t smem = bwd_smem_bytes(16 * KS);
  int dev = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  MSTTS_CHECK(cudaFuncSetAttribute(bigru_bwd_kernel<KS>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
  bigru_bwd_kernel<KS><<<2 * a.groups, block_threads(KS), smem, stream>>>(a);
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace

// wf / wb: W_hh, (H, 3H) bf16, as the layer stores it.
MSTTS_EXPORT int mstts_bigru_bwd(const void* gxf, const void* ghf, const void* hpf,
                                 const void* gxb, const void* ghb, const void* hpb,
                                 const void* wf, const void* wb, const void* dyf,
                                 const void* dyb, void* dgxf, void* dghf, void* dgxb,
                                 void* dghb, int T, int B, int H, void* stream) {
  if (H % 16 != 0 || H < 16 || H > 192 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  BwdArgs a;
  a.gx[0] = static_cast<const bf*>(gxf);
  a.gx[1] = static_cast<const bf*>(gxb);
  a.gh[0] = static_cast<const bf*>(ghf);
  a.gh[1] = static_cast<const bf*>(ghb);
  a.hp[0] = static_cast<const bf*>(hpf);
  a.hp[1] = static_cast<const bf*>(hpb);
  a.w[0] = static_cast<const bf*>(wf);
  a.w[1] = static_cast<const bf*>(wb);
  a.dy[0] = static_cast<const float*>(dyf);
  a.dy[1] = static_cast<const float*>(dyb);
  a.dgx[0] = static_cast<bf*>(dgxf);
  a.dgx[1] = static_cast<bf*>(dgxb);
  a.dgh[0] = static_cast<bf*>(dghf);
  a.dgh[1] = static_cast<bf*>(dghb);
  a.T = T;
  a.B = B;
  a.groups = (B + kRows - 1) / kRows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (H / 16) {
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 3: return launch<3>(a, st);
    case 4: return launch<4>(a, st);
    case 5: return launch<5>(a, st);
    case 6: return launch<6>(a, st);
    case 7: return launch<7>(a, st);
    case 8: return launch<8>(a, st);
    case 9: return launch<9>(a, st);
    case 10: return launch<10>(a, st);
    case 11: return launch<11>(a, st);
    default: return launch<12>(a, st);
  }
}
