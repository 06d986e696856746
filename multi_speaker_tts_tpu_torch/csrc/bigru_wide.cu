// CBHG-head BiGRU past H = 192 a direction: forward (with its residual
// mode) and backward as persistent cooperative launches that split a
// direction's units across blocks.
//
// Replaces, at the widths bigru.cu and bigru_bwd.cu do not take,
// multi_speaker_tts_tpu/ops/birnn_pallas.py::_bigru_fwd_impl (kernel body
// _bigru_fwd_kernel, save_residuals both ways) and ::_bigru_vjp_bwd (kernel
// body _bigru_bwd_kernel). Same functions as those two kernels:
//   forward   gh = bf16(h) . W_hh + b_hh,  r = s(gx_r + gh_r),
//             z = s(gx_z + gh_z),  n = tanh(gx_n + r * gh_n),
//             h' = (1 - z) * n + z * h     (f32 carry, bf16 outputs;
//             b_hn inside the reset product, as birnn_pallas.py:450)
//   backward  dGx = [dr, dz, dn],  dGh = [dr, dz, dn * r]  (bf16), and
//             dh_{t-1} = dh * z + bf16(dGh) . W_hh^T in f32,
// the forward direction walking t (reverse t in the backward), the
// backward direction T-1-t, everything stored in natural time. The input
// gates gx arrive hoisted and rounded to bf16, as the JAX kernel path
// rounds them; the residual mode stores gh and h_{t-1} rounded to bf16.
//
// Why another route: the narrow kernels keep one direction's W_hh in one
// block (registers and shared memory); (3H x H) bf16 is 384 KB at H = 256,
// more than an SM holds. Here the LSTM kernels' design carries over
// (lstm_persistent.cuh, lstm_bwd.cuh): block j of direction d owns U units
// (U = ceil(2H / SMs), mstts_recurrence_grid) and keeps their W_hh slice
// resident in shared memory for the launch -- the forward the 3U gate
// columns (rows of W_hh^T, K = H), the backward the U rows of W_hh (K =
// 3H) -- and h_{t-1} (forward) or bf16(dGh_t) (backward) of every row
// reaches every block through L2 under the split grid barrier of
// common.cuh. A step: the recurrent product from L2 into registers
// (rows_product: a lane loads 16 bytes of four rows a 32-wide k chunk, the
// permuted-k MMA pair of common.cuh, m16n8k16 bf16 with f32 sums, K split
// across the 8 warps, partial tiles added in shared memory in a fixed
// order), the cell of the block's units for all rows, the outputs, then
// the barrier's arrival, the next step's own inputs into shared memory
// (read by no other block) and the wait. Two launches on one input are
// bit-equal.
//
// What bounds it on an H100: like the LSTM kernels', the T sequential
// steps, each a grid barrier and one pass of B x H (forward) or B x 3H
// (backward) bf16 from L2 into every SM; the bytes from device memory and
// the operations are far below it. The cell's stores are scattered 2-byte
// stores (U units a row): a first kernel, right and simple.
//
// Rows: a block's partial tiles, carries and staged inputs grow with the
// rows it carries, so a launch takes a group of the batch's rows and the
// wrapper runs as many rows a group as fit (ops/birnn_kernel.py::wide_rows).
// Widths: H % 16 == 0 (the wrapper's bigru_shape_reason). Where a block's
// whole W_hh slice holds a launch of 32 rows (up to H 1,184 forward, 1,248
// backward on an H100) it stays resident (the build <false>). Past it
// (wide_layout) the streamed build <true> keeps
// resident the first ntr n-tiles of 8 columns (forward: gate columns of
// depth H; backward: W_hh rows of depth 3H) that fit beside the partial
// tiles and the rows' state, and reads every other tile's B fragments
// from L2 (device memory where W_hh outgrows L2: 25 MB of bf16 a direction
// at H 2048) in the same register ring as the A rows, one k-step pair
// ahead of their MMAs; up to what the partial tiles leave room for (4,880
// a direction on an H100).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kNG = 4;      // n-tiles of 8 columns a pass of the product holds
constexpr int kChunks = 2;  // 32-wide k chunks a warp loads ahead
constexpr int kFullRows = 32;  // rows the resident layout must hold, else the streamed build

// part[warp][BP][NP] = this warp's k share of A[B, K] . W[NP, K]^T: A rows
// a + b * lda (bf16, read through L2: other blocks wrote them this launch),
// W the block's resident rows (n-major, row stride WS, zero past K and past
// the owned columns), NT n-tiles of 8. 32 rows at a time; rows past B read
// zeros, k past K too (K % 8 == 0). lstm_bwd.cuh's product with a depth
// that need not fill its last 32-wide chunk and more n-tiles than fit one
// pass; the LSTM kernel keeps its own copy (sharing this one made it 3-4%
// slower on an H100).
// kStream: the n-tiles from ntr on are not resident; wrow(n) is column n's
// row in device memory (null for a pad column), its B fragments loaded
// beside the A rows' in the ring.
template <bool kStream, class WRow>
__device__ __forceinline__ void rows_product(const __nv_bfloat16* a, size_t lda, int B, int K,
                                             const __nv_bfloat16* w_s, int WS, int NT,
                                             float* part_s, int BP, int NP, int ntr, WRow wrow) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, tq = lane & 3;
  const int nchunk = (K + 31) / 32;
  const int cb = warp * nchunk / kWarps, ce = (warp + 1) * nchunk / kWarps;
  float* pw = part_s + (size_t)warp * BP * NP;
  for (int m0 = 0; m0 < B; m0 += 32) {
    const __nv_bfloat16* rows[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b = m0 + g8 + 8 * r;
      rows[r] = b < B ? a + (size_t)b * lda + tq * 8 : nullptr;
    }
    auto load = [&](uint4 (&buf)[kChunks][4], int c) {
#pragma unroll
      for (int q = 0; q < kChunks; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          buf[q][r] = (c + q < ce && rows[r] != nullptr && (c + q) * 32 + tq * 8 < K)
                          ? __ldcg(reinterpret_cast<const uint4*>(rows[r] + (c + q) * 32))
                          : make_uint4(0u, 0u, 0u, 0u);
    };
    for (int ng = 0; ng < NT; ng += kNG) {
      // Streamed layout: this lane's row of each streamed n-tile of the group.
      const __nv_bfloat16* wr[kNG];
#pragma unroll
      for (int j = 0; j < kNG; ++j)
        wr[j] = kStream && ng + j < NT && ng + j >= ntr ? wrow((ng + j) * 8 + g8) : nullptr;
      auto loadw = [&](uint4 (&buf)[kChunks][kNG], int c) {
#pragma unroll
        for (int q = 0; q < kChunks; ++q)
#pragma unroll
          for (int j = 0; j < kNG; ++j)
            buf[q][j] = (wr[j] != nullptr && c + q < ce && (c + q) * 32 + tq * 8 < K)
                            ? __ldg(reinterpret_cast<const uint4*>(wr[j] + (c + q) * 32 + tq * 8))
                            : make_uint4(0u, 0u, 0u, 0u);
      };
      float acc[2][kNG][4] = {};
      uint4 cur[kChunks][4], nxt[kChunks][4];
      uint4 wcur[kChunks][kNG], wnxt[kChunks][kNG];
      load(cur, cb);
      if constexpr (kStream) loadw(wcur, cb);
      for (int c = cb; c < ce; c += kChunks) {
        const bool more = c + kChunks < ce;
        if (more) load(nxt, c + kChunks);
        if constexpr (kStream) {
          if (more) loadw(wnxt, c + kChunks);
        }
#pragma unroll
        for (int q = 0; q < kChunks; ++q) {
          if (c + q < ce) {
#pragma unroll
            for (int j = 0; j < kNG; ++j) {
              if (ng + j < NT) {
                uint4 bw;
                if (kStream && ng + j >= ntr)
                  bw = wcur[q][j];
                else
                  bw = *reinterpret_cast<const uint4*>(
                      w_s + (size_t)((ng + j) * 8 + g8) * WS + (c + q) * 32 + tq * 8);
                mstts_mma_bf16_k32(acc[0][j], cur[q][0], cur[q][1], bw);
                mstts_mma_bf16_k32(acc[1][j], cur[q][2], cur[q][3], bw);
              }
            }
          }
        }
        if (more) {
#pragma unroll
          for (int q = 0; q < kChunks; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) cur[q][r] = nxt[q][r];
          if constexpr (kStream) {
#pragma unroll
            for (int q = 0; q < kChunks; ++q)
#pragma unroll
              for (int j = 0; j < kNG; ++j) wcur[q][j] = wnxt[q][j];
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < kNG; ++j) {
          if (ng + j < NT) {
            const int m = m0 + mi * 16 + g8, n = (ng + j) * 8 + 2 * tq;
            *reinterpret_cast<float2*>(pw + m * NP + n) = make_float2(acc[mi][j][0], acc[mi][j][1]);
            *reinterpret_cast<float2*>(pw + (m + 8) * NP + n) =
                make_float2(acc[mi][j][2], acc[mi][j][3]);
          }
        }
      }
    }
  }
}

// Sum of the warps' partials of (row b, column n), in warp order.
__device__ __forceinline__ float warp_partials(const float* part_s, int BP, int NP, int b, int n) {
  float v = 0.0f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += part_s[((size_t)w * BP + b) * NP + n];
  return v;
}

struct WideArgs {
  int T, B, Bs, H, U, nblk;     // B rows in this launch, Bs the row stride (full batch)
  int ntr;                      // n-tiles of the W_hh slice resident (the streamed build)
  const __nv_bfloat16* gx[2];   // (T, Bs, 3H) input gates
  const __nv_bfloat16* w[2];    // forward: W_hh^T (3H, H); backward: W_hh (H, 3H)
  const float* bh[2];           // (3H) b_hh (forward)
  __nv_bfloat16* ys[2];         // (T, Bs, H) forward outputs
  __nv_bfloat16* gh[2];         // (T, Bs, 3H): forward residual out / backward input
  __nv_bfloat16* hp[2];         // (T, Bs, H): forward residual out / backward input
  const float* dy[2];           // (T, Bs, H) backward: output cotangents
  __nv_bfloat16* dgx[2];        // (T, Bs, 3H) backward out
  __nv_bfloat16* dgh[2];        // (T, Bs, 3H) backward out
  unsigned int* bar;            // the grid barrier's counter, zeroed by the wrapper
};

// A block's shared memory over B rows with NR rows of its W_hh slice
// resident (the forward's 3U gate columns of depth H, the backward's U rows
// of depth 3H): the resident rows, the warps' partial tiles, and per row
// the carries and the step's own inputs.
__host__ __device__ inline size_t wide_smem_bytes(bool bwd, int U, int H, int B, int NR) {
  const int NP = mstts_round_up(bwd ? U : 3 * U, 8), BP = mstts_round_up(B, 32);
  const size_t rest = bwd ? 10 * (size_t)B * U : 4 * (size_t)B * U + 3 * (size_t)U;
  return 2 * (size_t)NR * mstts_k32_stride(bwd ? 3 * H : H) +
         4 * ((size_t)kWarps * BP * NP + rest);
}

struct WideLayout {
  int stream;    // 0: the whole slice resident; 1: the streamed build
  int ntr, nt;   // n-tiles resident, n-tiles of the slice
  size_t bytes;  // shared memory a block
};

// The layout of a launch over `rows` rows: the whole slice resident
// wherever it holds a launch of kFullRows rows, else the streamed build
// with as many n-tiles as fit beside the rest. The launch fits if bytes <=
// max_smem.
__host__ __device__ inline WideLayout wide_layout(bool bwd, int U, int H, int rows,
                                                  size_t max_smem) {
  WideLayout L = {};
  const int NP = mstts_round_up(bwd ? U : 3 * U, 8);
  L.nt = NP / 8;
  L.stream = wide_smem_bytes(bwd, U, H, kFullRows, NP) > max_smem;
  if (!L.stream) {
    L.ntr = L.nt;
    L.bytes = wide_smem_bytes(bwd, U, H, rows, NP);
    return L;
  }
  const size_t base = wide_smem_bytes(bwd, U, H, rows, 0);
  const size_t tile = 2 * 8 * (size_t)mstts_k32_stride(bwd ? 3 * H : H);
  const size_t fit = base > max_smem ? 0 : (max_smem - base) / tile;
  L.ntr = fit < (size_t)L.nt ? (int)fit : L.nt;
  L.bytes = base + (size_t)L.ntr * tile;
  return L;
}

template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1) bigru_wide_fwd_kernel(WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, H3 = 3 * a.H, B = a.B, T = a.T;
  const int dir = blockIdx.x / a.nblk;
  const int u0 = (blockIdx.x % a.nblk) * a.U;
  const int U = min(a.U, H - u0), UA = a.U;  // units owned; the layout's stride
  const int NP = mstts_round_up(3 * UA, 8), NT = (3 * UA + 7) / 8;
  const int NR = kStream ? 8 * a.ntr : NP;  // resident columns
  const int BP = mstts_round_up(B, 32), WS = mstts_k32_stride(H);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NR][WS]: col q UA + u
  float* part_s = reinterpret_cast<float*>(w_s + (size_t)NR * WS);  // [warp][BP][NP]
  float* h_s = part_s + (size_t)kWarps * BP * NP;                    // [B][UA] f32 carry
  float* gx_s = h_s + (size_t)B * UA;                                // [B][3 UA] this step's gx
  float* bias_s = gx_s + (size_t)3 * B * UA;                         // [3 UA]
  // Runtime indexing of the argument arrays would copy them to the stack.
  const __nv_bfloat16* gx = dir == 0 ? a.gx[0] : a.gx[1];
  const __nv_bfloat16* w = dir == 0 ? a.w[0] : a.w[1];
  const float* bh = dir == 0 ? a.bh[0] : a.bh[1];
  __nv_bfloat16* ys = dir == 0 ? a.ys[0] : a.ys[1];
  __nv_bfloat16* gh_res = dir == 0 ? a.gh[0] : a.gh[1];  // null outside the residual mode
  __nv_bfloat16* hp_res = dir == 0 ? a.hp[0] : a.hp[1];

  for (size_t i = threadIdx.x; i < (size_t)NR * WS / 8; i += kThreads)
    reinterpret_cast<uint4*>(w_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  // Resident W_hh^T rows: local column q UA + u <- gate column q H + u0 + u
  // (the streamed build: the first NR local columns).
  const int K8 = H / 8;
  for (int i = threadIdx.x; i < 3 * U * K8; i += kThreads) {
    const int n = i / K8, k8 = i - n * K8, q = n / U, u = n - q * U;
    if (q * UA + u < NR)
      reinterpret_cast<uint4*>(w_s + (size_t)(q * UA + u) * WS)[k8] =
          __ldg(reinterpret_cast<const uint4*>(w + (size_t)(q * H + u0 + u) * H) + k8);
  }
  // A streamed column's row of W_hh^T in device memory, or null for a pad.
  auto wrow = [&](int n) -> const __nv_bfloat16* {
    const int q = n / UA, u = n - q * UA;
    return q < 3 && u < U ? w + (size_t)(q * H + u0 + u) * H : nullptr;
  };
  for (int i = threadIdx.x; i < B * UA; i += kThreads) h_s[i] = 0.0f;
  for (int i = threadIdx.x; i < 3 * U; i += kThreads) {
    const int q = i / U, u = i - q * U;
    bias_s[q * UA + u] = __ldg(bh + q * H + u0 + u);
  }
  // The input gates of step s for the owned units (no other block writes them).
  auto load_gx = [&](int s) {
    const int t = dir == 0 ? s : T - 1 - s;
    for (int i = threadIdx.x; i < 3 * B * U; i += kThreads) {
      const int b = i / (3 * U), n = i - b * 3 * U, q = n / U, u = n - q * U;
      gx_s[(size_t)b * 3 * UA + q * UA + u] =
          __bfloat162float(__ldg(gx + ((size_t)t * a.Bs + b) * H3 + q * H + u0 + u));
    }
  };
  load_gx(0);
  __syncthreads();

  unsigned int epoch = 0;  // of the grid barrier
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? s : T - 1 - s;   // natural time of this step
    const int tp = dir == 0 ? t - 1 : t + 1;  // natural time of h_{t-1}
    // gh's product: bf16(h_{t-1}) of every row, the outputs of the last
    // step (zero at s = 0: gh = b_hh).
    if (s > 0) {
      rows_product<kStream>(ys + (size_t)tp * a.Bs * H, H, B, H, w_s, WS, NT, part_s, BP, NP,
                            a.ntr, wrow);
      __syncthreads();
    }
    for (int i = threadIdx.x; i < B * U; i += kThreads) {
      const int b = i / U, u = i - b * U;
      float g[3];
#pragma unroll
      for (int q = 0; q < 3; ++q)
        g[q] = (s > 0 ? warp_partials(part_s, BP, NP, b, q * UA + u) : 0.0f) + bias_s[q * UA + u];
      const float* x = gx_s + (size_t)b * 3 * UA + u;
      const float r = mstts_sigmoid(x[0] + g[0]);
      const float z = mstts_sigmoid(x[UA] + g[1]);
      const float n = tanhf(x[2 * UA] + r * g[2]);
      const float hprev = h_s[b * UA + u];
      const float h = (1.0f - z) * n + z * hprev;
      h_s[b * UA + u] = h;
      const size_t o = (size_t)t * a.Bs + b;
      ys[o * H + u0 + u] = __float2bfloat16(h);
      if (gh_res != nullptr) {
#pragma unroll
        for (int q = 0; q < 3; ++q) gh_res[o * H3 + q * H + u0 + u] = __float2bfloat16(g[q]);
        hp_res[o * H + u0 + u] = __float2bfloat16(hprev);
      }
    }
    if (s + 1 == T) break;
    // h_t is out: arrive, stage the next step's gates, wait.
    mstts_grid_arrive(a.bar, epoch);
    load_gx(s + 1);
    mstts_grid_wait(a.bar, epoch);
  }
}

template <bool kStream>
__global__ void __launch_bounds__(kThreads, 1) bigru_wide_bwd_kernel(WideArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, H3 = 3 * a.H, B = a.B, T = a.T;
  const int dir = blockIdx.x / a.nblk;
  const int u0 = (blockIdx.x % a.nblk) * a.U;
  const int U = min(a.U, H - u0), UA = a.U;
  const int NP = mstts_round_up(UA, 8), NT = (UA + 7) / 8;
  const int NR = kStream ? 8 * a.ntr : NP;  // resident rows
  const int BP = mstts_round_up(B, 32), WS = mstts_k32_stride(H3);
  const int BU = B * UA;
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NR][WS]: W_hh rows
  float* part_s = reinterpret_cast<float*>(w_s + (size_t)NR * WS);  // [warp][BP][NP]
  float* dh_s = part_s + (size_t)kWarps * BP * NP;  // [B][UA] bf16(dGh) . W_hh^T of the last step
  float* dhz_s = dh_s + BU;                          // [B][UA] dh * z of the last step
  float* res_s = dhz_s + BU;  // [7][B][UA]: gx r, z, n; gh r, z, n; h_{t-1}; then dy below
  float* dy_s = res_s + 7 * BU;                      // [B][UA]
  const __nv_bfloat16* gx = dir == 0 ? a.gx[0] : a.gx[1];
  const __nv_bfloat16* w = dir == 0 ? a.w[0] : a.w[1];
  const __nv_bfloat16* gh = dir == 0 ? a.gh[0] : a.gh[1];
  const __nv_bfloat16* hp = dir == 0 ? a.hp[0] : a.hp[1];
  const float* dy = dir == 0 ? a.dy[0] : a.dy[1];
  __nv_bfloat16* dgx = dir == 0 ? a.dgx[0] : a.dgx[1];
  __nv_bfloat16* dgh = dir == 0 ? a.dgh[0] : a.dgh[1];

  for (size_t i = threadIdx.x; i < (size_t)NR * WS / 8; i += kThreads)
    reinterpret_cast<uint4*>(w_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int K8 = H3 / 8;
  for (int i = threadIdx.x; i < min(U, NR) * K8; i += kThreads) {
    const int u = i / K8, k8 = i - u * K8;
    reinterpret_cast<uint4*>(w_s + (size_t)u * WS)[k8] =
        __ldg(reinterpret_cast<const uint4*>(w + (size_t)(u0 + u) * H3) + k8);
  }
  auto wrow = [&](int n) -> const __nv_bfloat16* {
    return n < U ? w + (size_t)(u0 + n) * H3 : nullptr;
  };
  for (int i = threadIdx.x; i < BU; i += kThreads) dh_s[i] = dhz_s[i] = 0.0f;
  // The residuals and cotangents of step s for the owned units.
  auto load_res = [&](int s) {
    const int t = dir == 0 ? T - 1 - s : s;
    for (int i = threadIdx.x; i < B * U; i += kThreads) {
      const int b = i / U, u = i - b * U, j = b * UA + u;
      const size_t o = (size_t)t * a.Bs + b;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        res_s[q * BU + j] = __bfloat162float(__ldg(gx + o * H3 + q * H + u0 + u));
        res_s[(3 + q) * BU + j] = __bfloat162float(__ldg(gh + o * H3 + q * H + u0 + u));
      }
      res_s[6 * BU + j] = __bfloat162float(__ldg(hp + o * H + u0 + u));
      dy_s[j] = __ldg(dy + o * H + u0 + u);
    }
  };
  load_res(0);
  __syncthreads();

  unsigned int epoch = 0;
  for (int s = 0; s < T; ++s) {
    const int t = dir == 0 ? T - 1 - s : s;
    // 1. The cell of the owned units, every row.
    for (int i = threadIdx.x; i < B * U; i += kThreads) {
      const int b = i / U, u = i - b * U, j = b * UA + u;
      const float dh = (dhz_s[j] + dh_s[j]) + dy_s[j];
      const float ghn = res_s[5 * BU + j], h_prev = res_s[6 * BU + j];
      const float r = mstts_sigmoid(res_s[j] + res_s[3 * BU + j]);
      const float z = mstts_sigmoid(res_s[BU + j] + res_s[4 * BU + j]);
      const float n = tanhf(res_s[2 * BU + j] + r * ghn);
      const float dz = dh * (h_prev - n) * z * (1.0f - z);
      const float dn = dh * (1.0f - z) * (1.0f - n * n);
      const float dr = dn * ghn * r * (1.0f - r);
      const size_t o = ((size_t)t * a.Bs + b) * H3 + u0 + u;
      const __nv_bfloat16 br = __float2bfloat16(dr), bz = __float2bfloat16(dz);
      dgx[o] = br;
      dgx[o + H] = bz;
      dgx[o + 2 * H] = __float2bfloat16(dn);
      dgh[o] = br;
      dgh[o + H] = bz;
      dgh[o + 2 * H] = __float2bfloat16(dn * r);
      dhz_s[j] = dh * z;
    }
    if (s + 1 == T) break;
    // 2. dGh_t is complete in every block after the wait.
    mstts_grid_arrive(a.bar, epoch);
    load_res(s + 1);
    mstts_grid_wait(a.bar, epoch);
    // 3. bf16(dGh_t) . W_hh^T of the owned units, for the next step.
    rows_product<kStream>(dgh + (size_t)t * a.Bs * H3, H3, B, H3, w_s, WS, NT, part_s, BP, NP,
                          a.ntr, wrow);
    __syncthreads();
    for (int i = threadIdx.x; i < B * U; i += kThreads) {
      const int b = i / U, u = i - b * U;
      dh_s[b * UA + u] = warp_partials(part_s, BP, NP, b, u);
    }
    __syncthreads();
  }
}

// Both directions for rows b0 .. b0 + rows of the batch (a.Bs) in one
// cooperative launch, or a refusal if a block's shared memory does not hold
// that many rows. The wrapper runs a batch in groups
// (ops/birnn_kernel.py::wide_row_groups), each launch with a barrier
// counter of its own.
int wide_run(WideArgs a, bool bwd, int b0, int rows, cudaStream_t stream) {
  int dev = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (a.H % 16 != 0 || a.H < 16 || a.T < 1 || b0 < 0 || rows < 1 || b0 + rows > a.Bs)
    return (int)cudaErrorInvalidValue;
  MSTTS_CHECK(mstts_recurrence_grid(2, a.H, &a.U, &a.nblk));
  const WideLayout L = wide_layout(bwd, a.U, a.H, rows, (size_t)max_smem);
  const size_t smem = L.bytes;
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  a.ntr = L.ntr;
  const void* kernel =
      bwd ? (L.stream ? (const void*)bigru_wide_bwd_kernel<true>
                      : (const void*)bigru_wide_bwd_kernel<false>)
          : (L.stream ? (const void*)bigru_wide_fwd_kernel<true>
                      : (const void*)bigru_wide_fwd_kernel<false>);
  MSTTS_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem));
  a.B = rows;
  const size_t o1 = (size_t)b0 * a.H, o3 = 3 * o1;
  for (int d = 0; d < 2; ++d) {
    a.gx[d] += o3;
    if (a.ys[d]) a.ys[d] += o1;
    if (a.gh[d]) a.gh[d] += o3;
    if (a.hp[d]) a.hp[d] += o1;
    if (a.dy[d]) a.dy[d] += o1;
    if (a.dgx[d]) a.dgx[d] += o3;
    if (a.dgh[d]) a.dgh[d] += o3;
  }
  void* params[] = {&a};
  MSTTS_CHECK(cudaLaunchCooperativeKernel(kernel, dim3(2 * a.nblk), dim3(kThreads), params, smem,
                                          stream));
  MSTTS_RETURN_LAUNCH_ERROR();
}

}  // namespace

// The layout of a launch over `rows` rows at H a direction on this card,
// for the wrapper's mirror (ops/birnn_kernel.wide_layout): out = U, blocks
// a direction, streamed build, n-tiles resident, n-tiles, bytes, fits.
MSTTS_EXPORT int mstts_bigru_wide_layout(int bwd, int H, int rows, void* out) {
  int dev = 0, max_smem = 0, U = 0, nblk = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  MSTTS_CHECK(mstts_recurrence_grid(2, H, &U, &nblk));
  const WideLayout L = wide_layout(bwd != 0, U, H, rows, (size_t)max_smem);
  int* o = static_cast<int*>(out);
  o[0] = U; o[1] = nblk; o[2] = L.stream; o[3] = L.ntr; o[4] = L.nt; o[5] = (int)L.bytes;
  o[6] = L.bytes <= (size_t)max_smem;
  return 0;
}

// whf / whb: W_hh transposed, (3H, H) bf16; bhf / bhb: b_hh f32. ghf, hpf,
// ghb, hpb: all null or all set (the residual mode).
MSTTS_EXPORT int mstts_bigru_wide_fwd(const void* gxf, const void* gxb, const void* whf,
                                      const void* whb, const void* bhf, const void* bhb,
                                      void* ysf, void* ysb, void* ghf, void* hpf, void* ghb,
                                      void* hpb, void* bar, int T, int B, int H, int b0,
                                      int rows, void* stream) {
  const bool any = ghf || hpf || ghb || hpb, all = ghf && hpf && ghb && hpb;
  if (any && !all) return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  WideArgs a = {};
  a.T = T;
  a.Bs = B;
  a.H = H;
  a.gx[0] = static_cast<const bf*>(gxf);
  a.gx[1] = static_cast<const bf*>(gxb);
  a.w[0] = static_cast<const bf*>(whf);
  a.w[1] = static_cast<const bf*>(whb);
  a.bh[0] = static_cast<const float*>(bhf);
  a.bh[1] = static_cast<const float*>(bhb);
  a.ys[0] = static_cast<bf*>(ysf);
  a.ys[1] = static_cast<bf*>(ysb);
  a.gh[0] = static_cast<bf*>(ghf);
  a.gh[1] = static_cast<bf*>(ghb);
  a.hp[0] = static_cast<bf*>(hpf);
  a.hp[1] = static_cast<bf*>(hpb);
  a.bar = static_cast<unsigned int*>(bar);
  return wide_run(a, false, b0, rows, static_cast<cudaStream_t>(stream));
}

// wf / wb: W_hh, (H, 3H) bf16, as the layer stores it.
MSTTS_EXPORT int mstts_bigru_wide_bwd(const void* gxf, const void* ghf, const void* hpf,
                                      const void* gxb, const void* ghb, const void* hpb,
                                      const void* wf, const void* wb, const void* dyf,
                                      const void* dyb, void* dgxf, void* dghf, void* dgxb,
                                      void* dghb, void* bar, int T, int B, int H, int b0,
                                      int rows, void* stream) {
  using bf = __nv_bfloat16;
  WideArgs a = {};
  a.T = T;
  a.Bs = B;
  a.H = H;
  a.gx[0] = static_cast<const bf*>(gxf);
  a.gx[1] = static_cast<const bf*>(gxb);
  a.gh[0] = const_cast<bf*>(static_cast<const bf*>(ghf));
  a.gh[1] = const_cast<bf*>(static_cast<const bf*>(ghb));
  a.hp[0] = const_cast<bf*>(static_cast<const bf*>(hpf));
  a.hp[1] = const_cast<bf*>(static_cast<const bf*>(hpb));
  a.w[0] = static_cast<const bf*>(wf);
  a.w[1] = static_cast<const bf*>(wb);
  a.dy[0] = static_cast<const float*>(dyf);
  a.dy[1] = static_cast<const float*>(dyb);
  a.dgx[0] = static_cast<bf*>(dgxf);
  a.dgx[1] = static_cast<bf*>(dgxb);
  a.dgh[0] = static_cast<bf*>(dghf);
  a.dgh[1] = static_cast<bf*>(dghb);
  a.bar = static_cast<unsigned int*>(bar);
  return wide_run(a, true, b0, rows, static_cast<cudaStream_t>(stream));
}
