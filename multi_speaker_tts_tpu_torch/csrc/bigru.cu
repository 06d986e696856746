// CBHG-head BiGRU recurrence on tensor cores: both directions and every
// batch row in one launch, no grid barrier.
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
// What bounds it on an H100: the T dependent steps. Bytes (gates, 2 x 96 KB
// of weights, outputs) and operations are tiny (0.001 ms by bytes at the
// serving shape). Each step is one small product, bf16(h) [rows x H] .
// W_hh [H x 3H], then the cell, then h has to reach every warp of the block
// before the next step can start.
//
// Design:
// - Rows of one direction share W_hh, so one block runs one direction for a
//   group of up to 8 batch rows, and the step's product runs on tensor
//   cores as gh^T = W_hh^T . bf16(h)^T: mma.sync m16n8k16 (bf16 operands,
//   f32 sums) with 16 gate columns as M and the 8 rows as N. Grid: 2 x
//   ceil(B / 8) blocks (2 at B = 4, 8 at B = 32). Rows never interact, so
//   no grid barrier. (With the rows as M instead, a tile holds 16 rows and
//   at B <= 8 half or more of the MMAs multiply padding rows.)
// - Warp w owns hidden units [16w, 16w + 16) and, for each of them, its r,
//   z and n gate columns: three m-tiles (u, H + u, 2H + u). So one thread's
//   accumulators hold gh_r, gh_z and gh_n of the same (unit, row) pairs,
//   and the cell runs in registers with the f32 carry.
// - W_hh stays resident for all T steps: as A fragments in registers, 12
//   32-bit registers per 16 hidden inputs (96 at H = 128), loaded once from
//   the transposed weights (3H, H) that the wrapper packs; above H = 128 the
//   k-steps past the registers' share stay in shared memory and are read by
//   ldmatrix every step (bigru_step.cuh, shared with the sequential floor
//   in barrier_floor.cu).
// - A step: each warp reads h_{t-1} (bf16, double-buffered in shared
//   memory, one row per batch row) by ldmatrix as B fragments and runs three
//   gates x four accumulators (k-step mod 4), H / 64 MMAs deep each, added
//   in a fixed order: two launches on one input are bit-equal. The
//   cell adds the input gates and b_hh, writes h_t into the other h buffer
//   and the outputs, and one __syncthreads publishes h_t: one barrier a step.
// - The input gates (8 rows x 3H bf16 a step) are copied by cp.async, 16
//   bytes a thread, into a ring of four shared buffers, three steps ahead,
//   so that a copy's L2 round trip, longer than a step, stays hidden. The
//   wait for the next step's copy sits before the step's one barrier.
//
// Per-step dependent chain: ldmatrix of h, H / 64 dependent MMAs (2 at
// H = 128) and three adds, the cell (two sigmoids and a tanh from ex2 / rcp,
// see fast_sigmoid in bigru_step.cuh), a shared store and the block
// barrier. A thread's four cells run without a branch, so their chains
// overlap.
//
// Shapes: H % 16 == 0 and 16 <= H <= 192 (W_hh of one direction fits the
// registers and shared memory of one SM);
// the wrapper (ops/birnn_kernel.py) refuses anything else before launch.
//
// ghf / hpf / ghb / hpb non-null selects the residual mode of
// _bigru_fwd_impl(save_residuals=True): per direction gh = bf16(h).W_hh +
// b_hh (T, B, 3H) and h_{t-1} (T, B, H), bf16, in natural time, for the
// reverse kernel (bigru_bwd.cu). Both modes compute the same h.
#include "bigru_step.cuh"

namespace {

constexpr int kRows = kGruRows;
constexpr int kAhead = 4;  // gate buffers: steps s .. s + 3 in flight

struct GruArgs {
  const __nv_bfloat16* gx[2];  // (T, B, 3H) hoisted input gates
  const __nv_bfloat16* wt[2];  // (3H, H) W_hh transposed: row n holds its k values
  const float* bh[2];          // (3H) b_hh
  __nv_bfloat16* ys[2];        // (T, B, H)
  __nv_bfloat16* gh[2];        // (T, B, 3H) residual gh, or null
  __nv_bfloat16* hp[2];        // (T, B, H) residual h_{t-1}, or null
  int T, B, groups;            // groups: row groups per direction
};

__host__ __device__ inline int gx_stride(int H) { return mstts_round_up(3 * H, 64) + 8; }

__host__ __device__ inline size_t gru_smem_bytes(int H) {
  return sizeof(__nv_bfloat16) *
         (kRows * ((size_t)kAhead * gx_stride(H) + 2 * (size_t)mstts_ldmatrix_stride(H)) +
          gru_wsmem_elems(H));
}

template <int KS>  // H = 16 * KS hidden units, KS warps
__global__ void __launch_bounds__(32 * KS, 1) bigru_kernel(GruArgs a) {
  constexpr int H = 16 * KS, H3 = 3 * H;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int GS = gx_stride(H), HS = mstts_ldmatrix_stride(H);
  __nv_bfloat16* gx_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kAhead][kRows][GS]
  __nv_bfloat16* h_s = gx_s + kAhead * kRows * GS;                    // [2][kRows][HS]
  __nv_bfloat16* w_s = h_s + 2 * kRows * HS;  // [3H][gru_wsmem_stride] above H = 128

  const int dir = blockIdx.x / a.groups;
  const int r0 = (blockIdx.x % a.groups) * kRows;
  const int rows = min(kRows, a.B - r0);
  const int T = a.T, B = a.B;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, tq = lane & 3;
  // Runtime indexing of the argument arrays would copy them to the stack.
  const __nv_bfloat16* gx = dir == 0 ? a.gx[0] : a.gx[1];
  const __nv_bfloat16* wt = dir == 0 ? a.wt[0] : a.wt[1];
  const float* bh = dir == 0 ? a.bh[0] : a.bh[1];
  __nv_bfloat16* ys = dir == 0 ? a.ys[0] : a.ys[1];
  __nv_bfloat16* gh_res = dir == 0 ? a.gh[0] : a.gh[1];  // null outside the residual mode
  __nv_bfloat16* hp_res = dir == 0 ? a.hp[0] : a.hp[1];
  const bool residuals = gh_res != nullptr;

  // Zero the gate buffers (rows past `rows` stay zero) and both h buffers.
  for (int i = threadIdx.x; i < kRows * (kAhead * GS + 2 * HS) / 8; i += blockDim.x)
    reinterpret_cast<uint4*>(gx_s)[i] = make_uint4(0u, 0u, 0u, 0u);

  // Resident W_hh^T: gate q's m-tile is gate columns q H + 16w .. + 15
  // (this warp's units).
  GruProduct<KS> product;
  product.load(wt, w_s);
  float bias[3][2];  // b_hh of units 16w + g and 16w + g + 8
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    const int col = q * H + 16 * warp + g8;
    bias[q][0] = __ldg(bh + col);
    bias[q][1] = __ldg(bh + col + 8);
  }
  __syncthreads();

  // The input gates of step s (natural time t) into gate buffer s % kAhead,
  // as one commit group (empty past the last step, so that every step
  // commits one and the waits below count alike). A thread copies the same
  // 16-byte chunks of every step: their offsets are worked out once.
  constexpr int C = H3 / 8;                                  // 16-byte chunks a row
  constexpr int kCopies = (kRows * C + 32 * KS - 1) / (32 * KS);  // a thread's chunks
  int src_off[kCopies], dst_off[kCopies];
#pragma unroll
  for (int k = 0; k < kCopies; ++k) {
    const int i = k * 32 * KS + threadIdx.x, r = i / C, c = i - r * C;
    src_off[k] = r < rows ? r * H3 + 8 * c : -1;
    dst_off[k] = r * GS + 8 * c;
  }
  auto stage_gates = [&](int s) {
    if (s < T) {
      const int t = dir == 0 ? s : T - 1 - s;
      const __nv_bfloat16* src = gx + ((size_t)t * B + r0) * H3;
      __nv_bfloat16* dst = gx_s + (s % kAhead) * kRows * GS;
#pragma unroll
      for (int k = 0; k < kCopies; ++k)
        if (src_off[k] >= 0) mstts_cp_async16(dst + dst_off[k], src + src_off[k]);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // Steps 0 .. kAhead - 2 in flight; wait for step 0's.
  for (int s = 0; s < kAhead - 1; ++s) stage_gates(s);
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 2) : "memory");
  __syncthreads();

  // This thread's cell: units u0 = 16w + g and u0 + 8, rows 2t and 2t + 1,
  // element e = 2 * (unit half) + (row), as the C fragment holds them.
  const int u0 = 16 * warp + g8;
  float hc[4] = {};  // f32 carry
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;
    const int cur = s & 1;

    // This step's input gates (landed before the last barrier), read ahead
    // of the product so that their latency hides behind it.
    const __nv_bfloat16* gxs = gx_s + (s % kAhead) * kRows * GS;
    float gxv[4][3];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int q = 0; q < 3; ++q)
        gxv[e][q] = __bfloat162float(gxs[(2 * tq + (e & 1)) * GS + q * H + u0 + 8 * (e >> 1)]);

    // gh^T = W_hh^T . bf16(h)^T: B fragments of h_{t-1} (rows are n), four
    // accumulators a gate (k-step mod 4), added in a fixed order.
    float acc[3][4][4] = {};
    product.run(acc, h_s + cur * kRows * HS + (lane & 7) * HS + ((lane >> 3) & 1) * 8);
    stage_gates(s + kAhead - 1);  // into the buffer that step s - 1 read, during the MMAs

    // The cell, for all four (unit, row) elements at once and without a
    // branch, so that their dependent ex2 / rcp chains overlap: a padding
    // row computes from zero gates and feeds only its own column of the
    // product. Only the batch's rows are stored.
    float ghv[4][3], hprev[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        ghv[e][q] =
            ((acc[q][0][e] + acc[q][1][e]) + (acc[q][2][e] + acc[q][3][e])) + bias[q][e >> 1];
      hprev[e] = hc[e];
      const float r = fast_sigmoid(gxv[e][0] + ghv[e][0]);
      const float z = fast_sigmoid(gxv[e][1] + ghv[e][1]);
      const float n = fast_tanh(gxv[e][2] + r * ghv[e][2]);
      hc[e] = (1.0f - z) * n + z * hprev[e];
    }
    __nv_bfloat16* h_next = h_s + (cur ^ 1) * kRows * HS;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 2 * tq + (e & 1), u = u0 + 8 * (e >> 1);
      const __nv_bfloat16 hb = __float2bfloat16(hc[e]);
      h_next[row * HS + u] = hb;
      if (row < rows) {
        const size_t o = (size_t)t * B + r0 + row;
        ys[o * H + u] = hb;
        if (residuals) {
#pragma unroll
          for (int q = 0; q < 3; ++q) gh_res[o * H3 + q * H + u] = __float2bfloat16(ghv[e][q]);
          hp_res[o * H + u] = __float2bfloat16(hprev[e]);
        }
      }
    }
    // The next step's gates have landed and h_t is in the other buffer.
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 2) : "memory");
    __syncthreads();
  }
}

template <int KS>
int launch(const GruArgs& a, cudaStream_t stream) {
  const size_t smem = gru_smem_bytes(16 * KS);
  MSTTS_CHECK(cudaFuncSetAttribute(bigru_kernel<KS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem));
  bigru_kernel<KS><<<2 * a.groups, 32 * KS, smem, stream>>>(a);
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace

// whf / whb: W_hh transposed, (3H, H) bf16. ghf, hpf, ghb, hpb: all null or
// all set (the residual mode).
MSTTS_EXPORT int mstts_bigru_fwd(const void* gxf, const void* gxb, const void* whf,
                                 const void* whb, const void* bhf, const void* bhb,
                                 void* ysf, void* ysb, void* ghf, void* hpf, void* ghb,
                                 void* hpb, int T, int B, int H, void* stream) {
  const bool any = ghf || hpf || ghb || hpb, all = ghf && hpf && ghb && hpb;
  if (H % 16 != 0 || H < 16 || H > 192 || T < 1 || B < 1 || (any && !all))
    return (int)cudaErrorInvalidValue;
  GruArgs a;
  a.gx[0] = static_cast<const __nv_bfloat16*>(gxf);
  a.gx[1] = static_cast<const __nv_bfloat16*>(gxb);
  a.wt[0] = static_cast<const __nv_bfloat16*>(whf);
  a.wt[1] = static_cast<const __nv_bfloat16*>(whb);
  a.bh[0] = static_cast<const float*>(bhf);
  a.bh[1] = static_cast<const float*>(bhb);
  a.ys[0] = static_cast<__nv_bfloat16*>(ysf);
  a.ys[1] = static_cast<__nv_bfloat16*>(ysb);
  a.gh[0] = static_cast<__nv_bfloat16*>(ghf);
  a.gh[1] = static_cast<__nv_bfloat16*>(ghb);
  a.hp[0] = static_cast<__nv_bfloat16*>(hpf);
  a.hp[1] = static_cast<__nv_bfloat16*>(hpb);
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
