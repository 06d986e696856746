// Persistent reverse LSTM recurrence on tensor cores: one cooperative
// launch runs every time step of the backward pass and emits the
// pre-activation gate gradients dG (T, B, 4H) bf16, nothing else.
//
// Shared by lstm_bwd.cu (GE2E layer, one direction: replaces
// multi_speaker_tts_tpu/ops/lstm_pallas.py::lstm_seq_layer_bwd, kernel body
// _bwd_kernel) and bilstm_bwd.cu (text-encoder BiLSTM, both directions in
// one launch: replaces ops/birnn_pallas.py::_bilstm_vjp_bwd, kernel body
// _bilstm_bwd_kernel). It reverses the forward kernels of
// lstm_persistent.cuh from their residuals: the pre-activation gates and
// c_{t-1}, both bf16 in natural time.
//
// Numerics follow the TPU kernels (lstm_pallas.py::_bwd_kernel,
// birnn_pallas.py::_bilstm_bwd_kernel): the cell derivative is f32 from
// the bf16 residuals (c_t recomputed from c_{t-1}), the carries dh and dc
// are f32, dG is rounded to bf16 on store, and the carried
// dh_{t-1} = bf16(dG_t) . W_hh^T is a bf16 product with f32 accumulation.
//
// What bounds it: each step's product needs the whole dG_t row of every
// batch row from every block (B x 4H bf16: 196 KB at B = 32, H = 768), so
// a step costs one grid barrier plus one pass of 196 KB per SM through L2
// (about 25 MB a step over 128 SMs), and the launch T of those. The bytes
// from device memory (residuals, dG, W_hh once) and the 2*T*B*4H*H
// operations are far below it. The design:
//
// - Block j of direction d owns U of the H units. It keeps rows
//   u0..u0+U of W_hh (H, 4H) -- the columns of W_hh^T that produce its
//   units of dh_{t-1} -- resident in shared memory (rows padded to 8 with
//   zeros), with its units' f32 carries dh and dc.
// - A step: (1) the cell derivative of the block's units for all rows,
//   staged as a bf16 tile and stored as one run of U units per row and gate
//   in the widest aligned pieces (4 bytes at U = 6, 8 at U = 4); (2) the
//   grid barrier's arrival, then the next step's residuals and output
//   cotangents (which no other block writes) are loaded into shared
//   memory, then the wait; (3) dh_{t-1} [B, U] = dG_t [B, 4H] .
//   W_hh[u0:u0+U, :]^T as mma.sync m16n8k16 (N = U padded to 8), K split
//   across the 8 warps in 32-wide chunks, partial tiles added in shared
//   memory in a fixed order.
// - dG_t streams straight from L2 into registers: a lane loads 16 bytes
//   (8 consecutive k) of four batch rows per chunk and feeds them to two
//   MMAs through the permuted-k pairing of common.cuh
//   (mstts_mma_bf16_k32), with the weights read 16 bytes a lane from shared
//   memory. The loads of the next two chunks are in flight while the MMAs
//   of the current two run (a register ring), which keeps 32 KB a block in
//   flight: enough to cover L2 latency without shared-memory staging.
// Direction 0 walks time in reverse; direction 1 (the BiLSTM's backward
// direction, which ran t = T-1 .. 0) walks natural time. The last step
// needs no product and no barrier.
// - A block's shared memory grows with the rows it carries (the partial
//   tiles, the carries, the residual tile), so a launch takes a group of
//   the batch's rows (lstm_bwd_run) and the wrapper runs as many rows a
//   group as fit (352 at H = 768 on an H100, so GE2E's 64 x 10 = 640 rows
//   take two launches).
// - The wide layout (a second build, lstm_bwd_kernel<kLstmBwdWideNT, true>):
//   where the full layout does not hold min(B, 32) rows, or a block owns
//   more than 16 units (more n-tiles than the production build's
//   registers hold), W_hh's rows past the first ntr n-tiles leave shared
//   memory, and a streamed tile's 16-byte B pieces are read from L2 beside
//   the dG chunk they pair with. The launch then takes as many rows as the
//   rest of the block holds. dG_t, which every block reads from L2 every
//   step, stays the larger stream. lstm_bwd_layout decides;
//   ops/lstm_kernel.bwd_layout mirrors it. The production widths keep the
//   full layout and its build, lstm_bwd_kernel<kLstmBwdMaxNT, false>.
#pragma once

#include "common.cuh"

namespace mstts {

constexpr int kLstmBwdThreads = 256;
constexpr int kLstmBwdWarps = kLstmBwdThreads / 32;
constexpr int kLstmBwdMaxNT = 2;   // n-tiles of 8 units: U <= 16
constexpr int kLstmBwdWideNT = 8;  // the wide build's: U <= 64
constexpr int kLstmBwdChunks = 2;  // 32-wide k chunks a warp loads ahead

struct LstmBwdArgs {
  int T;       // time steps
  int B;       // rows in this launch
  int Bs;      // row stride of the time-major tensors (the full batch)
  int H;       // hidden units per direction
  int U;       // hidden units per block
  int nblk;    // blocks per direction
  int ntr;     // n-tiles of 8 W_hh rows resident in shared memory (the rest stream)
  const __nv_bfloat16* gates[2];  // (T, B, 4H) pre-activation gates
  const __nv_bfloat16* c_prev[2]; // (T, B, H) cell state before each step
  const __nv_bfloat16* w[2];      // (H, 4H) W_hh: row k holds the 4H gate columns of unit k
  const float* d_hT;              // (B, H) direction 0's final-h cotangent, or null (zero)
  const float* d_ys[2];           // (T, B, H) per-step output cotangents, or null
  __nv_bfloat16* dG[2];           // (T, B, 4H) out
  unsigned int* bar;              // the grid barrier's arrival counter, zeroed by the wrapper
};

// A block's shared memory for U units over B rows, W_hh aside: the warps'
// partial tiles, the carries, the residuals and the dG tile.
__host__ __device__ inline size_t lstm_bwd_base_bytes(int U, int B) {
  const int NP = mstts_round_up(U, 8), BP = mstts_round_up(B, 32);
  return 4 * ((size_t)kLstmBwdWarps * BP * NP + 8 * (size_t)B * U) + 2 * (size_t)B * 4 * U;
}

// The full layout: the base and the block's W_hh rows.
__host__ __device__ inline size_t lstm_bwd_smem_bytes(int U, int H, int B) {
  return 2 * (size_t)mstts_round_up(U, 8) * mstts_k32_stride(4 * H) + lstm_bwd_base_bytes(U, B);
}

struct LstmBwdLayout {
  int U, nblk;   // units a block, blocks a direction (mstts_recurrence_grid)
  int wide;      // 0: the full layout and build; 1: the W_hh tiles past ntr from L2
  int ntr;       // W_hh n-tiles resident
  size_t bytes;  // shared memory a block
  int fits;      // bytes <= max_smem and the build holds the block's n-tiles
};

// The layout of a launch over `rows` of a batch of Bs rows on a card of nsm
// SMs and max_smem opt-in bytes a block: the full one wherever it holds
// min(Bs, 32) rows within the production build's n-tiles, else the wide one
// with as many W_hh tiles as fit beside the base.
__host__ __device__ inline LstmBwdLayout lstm_bwd_layout(int ndir, int H, int Bs, int rows,
                                                         int nsm, size_t max_smem) {
  LstmBwdLayout L = {};
  L.U = (ndir * H + nsm - 1) / nsm;
  L.nblk = (H + L.U - 1) / L.U;
  const int NT = (L.U + 7) / 8;
  L.wide = NT > kLstmBwdMaxNT || lstm_bwd_smem_bytes(L.U, H, Bs < 32 ? Bs : 32) > max_smem;
  if (!L.wide) {
    L.ntr = NT;
    L.bytes = lstm_bwd_smem_bytes(L.U, H, rows);
  } else {
    const size_t base = lstm_bwd_base_bytes(L.U, rows);
    const size_t tile = 2 * 8 * (size_t)mstts_k32_stride(4 * H);
    const size_t fit = base > max_smem ? 0 : (max_smem - base) / tile;
    L.ntr = fit < (size_t)NT ? (int)fit : NT;
    L.bytes = base + (size_t)L.ntr * tile;
  }
  L.fits = L.bytes <= max_smem && NT <= (L.wide ? kLstmBwdWideNT : kLstmBwdMaxNT);
  return L;
}

template <int kMaxNT, bool kWide>
__global__ void __launch_bounds__(kLstmBwdThreads, 1) lstm_bwd_kernel(LstmBwdArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = a.H, H4 = 4 * a.H, B = a.B;
  const int dir = blockIdx.x / a.nblk;
  const int u0 = (blockIdx.x % a.nblk) * a.U;
  const int U = min(a.U, H - u0);  // units owned (the last block may own fewer)
  const int NP = mstts_round_up(a.U, 8), NT = (U + 7) / 8;
  const int BP = mstts_round_up(B, 32), WS = mstts_k32_stride(H4);
  const int BU = B * a.U;
  const int NR = kWide ? 8 * a.ntr : NP;  // W_hh rows resident
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NR][WS]
  float* part_s = reinterpret_cast<float*>(w_s + (size_t)NR * WS);  // [warp][BP][NP]
  float* dh_s = part_s + (size_t)kLstmBwdWarps * BP * NP;           // [B][a.U]
  float* dc_s = dh_s + BU;                                           // [B][a.U]
  float* res_s = dc_s + BU;  // [6][B][a.U]: gates i, f, g, o, c_{t-1}, output cotangent
  __nv_bfloat16* dg_s = reinterpret_cast<__nv_bfloat16*>(res_s + 6 * BU);  // [B][4U]

  for (size_t i = threadIdx.x; i < (size_t)NR * WS / 8; i += kLstmBwdThreads)
    reinterpret_cast<uint4*>(w_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();
  const int K8 = H4 / 8;
  for (int i = threadIdx.x; i < min(U, NR) * K8; i += kLstmBwdThreads) {
    const int u = i / K8, k8 = i - u * K8;
    reinterpret_cast<uint4*>(w_s + (size_t)u * WS)[k8] =
        __ldg(reinterpret_cast<const uint4*>(a.w[dir] + (size_t)(u0 + u) * H4) + k8);
  }
  for (int i = threadIdx.x; i < B * U; i += kLstmBwdThreads) {
    const int b = i / U, u = i - b * U;
    dh_s[b * a.U + u] = (dir == 0 && a.d_hT != nullptr) ? a.d_hT[(size_t)b * H + u0 + u] : 0.0f;
    dc_s[b * a.U + u] = 0.0f;
  }

  const __nv_bfloat16* gates = a.gates[dir];
  const __nv_bfloat16* c_prev = a.c_prev[dir];
  const float* d_ys = a.d_ys[dir];
  __nv_bfloat16* dG = a.dG[dir];
  // The inputs of step s that no other block writes.
  auto load_res = [&](int s) {
    const int t = dir == 0 ? a.T - 1 - s : s;
    for (int i = threadIdx.x; i < B * U; i += kLstmBwdThreads) {
      const int b = i / U, u = i - b * U, j = b * a.U + u;
      const size_t row = (size_t)t * a.Bs + b;
      const __nv_bfloat16* g = gates + row * H4 + u0 + u;
#pragma unroll
      for (int k = 0; k < 4; ++k) res_s[k * BU + j] = __bfloat162float(__ldg(g + k * H));
      res_s[4 * BU + j] = __bfloat162float(__ldg(c_prev + row * H + u0 + u));
      res_s[5 * BU + j] = d_ys != nullptr ? __ldg(d_ys + row * H + u0 + u) : 0.0f;
    }
  };
  load_res(0);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, tq = lane & 3;
  const int nchunk = H4 / 32;  // H % 8 == 0
  const int cb = warp * nchunk / kLstmBwdWarps, ce = (warp + 1) * nchunk / kLstmBwdWarps;
  unsigned int epoch = 0;  // of the grid barrier
  for (int s = 0; s < a.T; ++s) {
    const int t = dir == 0 ? a.T - 1 - s : s;
    // 1. Cell derivative of the owned units, staged as a bf16 tile.
    for (int i = threadIdx.x; i < B * U; i += kLstmBwdThreads) {
      const int b = i / U, u = i - b * U, j = b * a.U + u;
      const float dh = dh_s[j] + res_s[5 * BU + j];
      const float ig = mstts_sigmoid(res_s[j]);
      const float fg = mstts_sigmoid(res_s[BU + j]);
      const float gg = tanhf(res_s[2 * BU + j]);
      const float og = mstts_sigmoid(res_s[3 * BU + j]);
      const float cp = res_s[4 * BU + j];
      const float tc = tanhf(fg * cp + ig * gg);
      const float d_o = dh * tc * og * (1.0f - og);
      const float dc = dc_s[j] + dh * og * (1.0f - tc * tc);
      __nv_bfloat16* out = dg_s + b * 4 * U + u;
      out[0] = __float2bfloat16(dc * gg * ig * (1.0f - ig));
      out[U] = __float2bfloat16(dc * cp * fg * (1.0f - fg));
      out[2 * U] = __float2bfloat16(dc * ig * (1.0f - gg * gg));
      out[3 * U] = __float2bfloat16(d_o);
      dc_s[j] = dc * fg;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < B * 4; i += kLstmBwdThreads) {
      const int b = i / 4, k = i - b * 4;
      mstts_store_bf16_run(dG + ((size_t)t * a.Bs + b) * H4 + k * H + u0, dg_s + (b * 4 + k) * U,
                           U);
    }
    if (s + 1 == a.T) break;
    // 2. dG_t is complete in every block after the wait.
    mstts_grid_arrive(a.bar, epoch);
    load_res(s + 1);
    mstts_grid_wait(a.bar, epoch);
    // 3. dh_{t-1} of the owned units, 32 batch rows at a time: this lane
    // holds rows m0 + g8 + {0, 8, 16, 24} of each chunk.
    for (int m0 = 0; m0 < B; m0 += 32) {
      const __nv_bfloat16* rows[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int b = m0 + g8 + 8 * r;
        rows[r] = b < B ? dG + ((size_t)t * a.Bs + b) * H4 + tq * 8 : nullptr;
      }
      auto load = [&](uint4 (&buf)[kLstmBwdChunks][4], int c) {
#pragma unroll
        for (int q = 0; q < kLstmBwdChunks; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            buf[q][r] = (c + q < ce && rows[r] != nullptr)
                            ? __ldcg(reinterpret_cast<const uint4*>(rows[r] + (c + q) * 32))
                            : make_uint4(0u, 0u, 0u, 0u);
      };
      float acc[2][kMaxNT][4] = {};
      uint4 cur[kLstmBwdChunks][4], nxt[kLstmBwdChunks][4];
      load(cur, cb);
      for (int c = cb; c < ce; c += kLstmBwdChunks) {
        const bool more = c + kLstmBwdChunks < ce;
        if (more) load(nxt, c + kLstmBwdChunks);
#pragma unroll
        for (int q = 0; q < kLstmBwdChunks; ++q) {
          if (c + q < ce) {
#pragma unroll
            for (int j = 0; j < kMaxNT; ++j) {
              if (j < NT) {
                uint4 bw;
                if (!kWide || j < a.ntr)
                  bw = *reinterpret_cast<const uint4*>(w_s + (size_t)(j * 8 + g8) * WS +
                                                       (c + q) * 32 + tq * 8);
                else  // a streamed tile: row u0 + j*8 + g8 of W_hh, from L2
                  bw = j * 8 + g8 < U
                           ? __ldg(reinterpret_cast<const uint4*>(
                                 a.w[dir] + (size_t)(u0 + j * 8 + g8) * H4 + (c + q) * 32 +
                                 tq * 8))
                           : make_uint4(0u, 0u, 0u, 0u);
                mstts_mma_bf16_k32(acc[0][j], cur[q][0], cur[q][1], bw);
                mstts_mma_bf16_k32(acc[1][j], cur[q][2], cur[q][3], bw);
              }
            }
          }
        }
        if (more) {
#pragma unroll
          for (int q = 0; q < kLstmBwdChunks; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) cur[q][r] = nxt[q][r];
        }
      }
      float* pw = part_s + (size_t)warp * BP * NP;
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int j = 0; j < kMaxNT; ++j) {
          if (j < NT) {
            const int m = m0 + mi * 16 + g8, n = j * 8 + 2 * tq;
            *reinterpret_cast<float2*>(pw + m * NP + n) = make_float2(acc[mi][j][0], acc[mi][j][1]);
            *reinterpret_cast<float2*>(pw + (m + 8) * NP + n) =
                make_float2(acc[mi][j][2], acc[mi][j][3]);
          }
        }
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < B * U; i += kLstmBwdThreads) {
      const int b = i / U, u = i - b * U;
      float v = 0.0f;
#pragma unroll
      for (int w = 0; w < kLstmBwdWarps; ++w) v += part_s[((size_t)w * BP + b) * NP + u];
      dh_s[b * a.U + u] = v;
    }
    __syncthreads();
  }
}

// Runs the reverse recurrence of ndir directions for rows b0 .. b0 + rows
// of the batch (a.Bs rows) in one cooperative launch, in the layout
// lstm_bwd_layout gives, or refuses them where it does not fit. Rows are
// independent (only W_hh is shared), so the caller runs a batch in groups
// (ops/lstm_kernel.py::bwd_row_groups), each launch with a barrier counter
// of its own.
inline int lstm_bwd_run(LstmBwdArgs a, int ndir, int b0, int rows, cudaStream_t stream) {
  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (a.H % 8 != 0 || a.T < 1 || b0 < 0 || rows < 1 || b0 + rows > a.Bs)
    return (int)cudaErrorInvalidValue;
  const LstmBwdLayout L = lstm_bwd_layout(ndir, a.H, a.Bs, rows, nsm, (size_t)max_smem);
  if (!L.fits) return (int)cudaErrorInvalidValue;
  a.U = L.U;
  a.nblk = L.nblk;
  a.ntr = L.ntr;
  a.B = rows;
  for (int d = 0; d < ndir; ++d) {
    a.gates[d] += (size_t)b0 * 4 * a.H;
    a.c_prev[d] += (size_t)b0 * a.H;
    if (a.d_ys[d]) a.d_ys[d] += (size_t)b0 * a.H;
    a.dG[d] += (size_t)b0 * 4 * a.H;
  }
  if (a.d_hT) a.d_hT += (size_t)b0 * a.H;
  const void* kernel = L.wide ? (const void*)lstm_bwd_kernel<kLstmBwdWideNT, true>
                              : (const void*)lstm_bwd_kernel<kLstmBwdMaxNT, false>;
  MSTTS_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)L.bytes));
  void* params[] = {&a};
  MSTTS_CHECK(cudaLaunchCooperativeKernel(kernel, dim3(ndir * L.nblk), dim3(kLstmBwdThreads),
                                          params, L.bytes, stream));
  MSTTS_RETURN_LAUNCH_ERROR();
}

// The layout of a launch on this card, for the caller's mirror
// (ops/lstm_kernel.bwd_layout): out = U, nblk, wide, ntr, bytes, fits.
inline int lstm_bwd_layout_of(int ndir, int H, int Bs, int rows, int* out) {
  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  const LstmBwdLayout L = lstm_bwd_layout(ndir, H, Bs, rows, nsm, (size_t)max_smem);
  out[0] = L.U;
  out[1] = L.nblk;
  out[2] = L.wide;
  out[3] = L.ntr;
  out[4] = (int)L.bytes;
  out[5] = L.fits;
  return 0;
}

}  // namespace mstts
