// Persistent LSTM recurrence on tensor cores: one cooperative launch runs
// every time step.
//
// Shared by lstm.cu (GE2E layer: replaces
// multi_speaker_tts_tpu/ops/lstm_pallas.py::lstm_seq_layer_fwd, kernel body
// _fwd_kernel) and bilstm.cu (text-encoder BiLSTM, both directions in one
// launch: replaces ops/birnn_pallas.py::_bilstm_fwd_impl, kernel body
// _bilstm_fwd_kernel). Numerics follow the TPU kernels: bf16 operands, f32
// accumulation, f32 gates and cell state, h stored as bf16 (the carried h
// is used only as a bf16 matmul operand, so storing it bf16 loses nothing
// the next step would have used). As in _fwd_kernel, which sums
// dot(x_t, W_ih) and dot(h, W_hh) as two f32-accumulated products, the
// input half and the recurrent half are summed separately in f32.
//
// What bounds it: the time steps are sequential, and each one needs
// h_{t-1} from every block. So a step costs one grid barrier plus one L2
// round trip of h (B x H bf16, 48 KB at B = 32, H = 768), and the launch
// costs T of those. Bytes and operations are far below that (the weights
// are read from device memory once per launch; the GE2E layer's products
// are ~19 GFLOP at B = 32, ~20 us of tensor cores). The design keeps
// everything else off that chain:
//
// - Block j of direction d owns U hidden units and their 4U gate columns.
//   Its slice of W_ih and W_hh (gate column n = g*U + u <- global column
//   g*H + u0 + u) is loaded into shared memory once and stays there.
// - Phase 0 (GE2E, D > 0), before the time loop: the block computes the
//   input half X = x . W_ih + b of its own columns for all T*B rows on
//   tensor cores into an f32 scratch (T, B, 4H) that the wrapper
//   allocates. No barrier: a block reads back only its own columns. The
//   BiLSTM (D = 0) reads the gates its caller hoisted (gx, bias included).
// - A step: h_{t-1} (B rows of ys, contiguous) is staged into shared
//   memory by cp.async (16 bytes a thread, L2 only), each warp the columns
//   of its own k range, so no block-wide barrier precedes the product
//   h_{t-1} [B, H] . W_hh slice [H, 4U]. It runs as mma.sync m16n8k16
//   (ldmatrix for both operands; B padded with zero rows to a multiple of
//   16, 4U to a multiple of 8), K split across the 8 warps, the partial
//   tiles added in shared memory in a fixed order; the cell update adds
//   the input half and writes h_t.
// - The grid barrier is split (common.cuh): after arriving, the block
//   stores the step's residuals and puts the next step's input half
//   (loaded into registers at the start of the step) into shared memory,
//   then waits. Neither depends on other blocks.
// - Shared-memory rows are padded so that ldmatrix's eight 16-byte rows
//   fall in distinct banks (stride an odd multiple of 16 bytes), and the
//   phase-0 weight rows so that a quarter-warp's 16-byte loads of two rows
//   do (stride 64 mod 128 bytes).
//
// The wide layout (a second instantiation, lstm_persistent_kernel<true>):
// where a block's full layout does not hold min(B, kLstmMaxRows) rows
// (at 32 rows on an H100: from H 1000 for a stacked layer with D = H, from
// H 1208 for GE2E's layer 0 at D 80, from H 904 a direction for the
// BiLSTM), W_ih leaves shared memory (phase 0 reads it from L2, 16 bytes a
// lane, in the register ring that brings x), the partial tiles take 4
// slots of two warps each (kLstmWideSlots), and every n-tile of W_hh past
// the ntr that fit beside the launch's other regions stays in L2 (at 32
// rows: from H 1328, and from H 952 a direction): a streamed tile's B
// fragments are loaded each step, one k-step ahead of their MMAs.
// lstm_layout decides, from the card's opt-in bytes;
// ops/lstm_kernel.fwd_layout mirrors it. Every production width keeps the
// full layout, so its code is the instantiation
// lstm_persistent_kernel<false>, unchanged.
//
// Residual mode (training): with g_res / c_res set, each step also stores
// the f32 pre-activation gates rounded to bf16 and c_{t-1} rounded to bf16,
// in natural time, which is what the TPU kernels store with
// save_residuals=True and what the reverse kernel (lstm_bwd.cuh) reads.
// They are staged as a bf16 tile and written after the barrier's arrival,
// one run of U units per row and gate in the widest aligned pieces (4
// bytes at U = 6, 8 at U = 4; 16 would need 16-byte aligned runs, U a
// multiple of 8).
#pragma once

#include <algorithm>

#include "common.cuh"

namespace mstts {

constexpr int kLstmThreads = 256;
constexpr int kLstmWarps = kLstmThreads / 32;
// Rows a launch: at most kLstmMT m-tiles of 16. Larger batches take more
// launches, one entry call a row group that the caller plans
// (ops/lstm_kernel.fwd_row_groups); at B = 64 two launches of 32 rows took
// the time of one of 64, and the step's code, which every step fetches
// again, is smaller.
constexpr int kLstmMaxRows = 32;
constexpr int kLstmMT = kLstmMaxRows / 16;
constexpr int kLstmNGroup = 3;    // n-tiles of 8 gate columns a warp holds at once
constexpr int kLstmRing = 2;      // phase 0: 32-wide k chunks a warp loads ahead
constexpr int kLstmPre = 4;       // input-half values a thread prefetches a step
// Slots of partial tiles: the full layout splits a step's K across the 8
// warps; the wide one across 4 slots of two warps each, the two taking
// alternate n-groups, which halves the partial tiles (at H 4096 a
// direction they would outgrow a block beside h_{t-1}).
constexpr int kLstmWideSlots = 4;

struct LstmArgs {
  int T;      // time steps
  int B;      // rows in this launch
  int Bs;     // row stride of the time-major tensors (the full batch)
  int D;      // input width (0: gates precomputed in gx)
  int H;      // hidden units per direction
  int U;      // hidden units per block
  int nblk;   // blocks per direction
  int ntr;    // n-tiles of 8 W_hh columns resident in shared memory (the rest stream)
  const __nv_bfloat16* x;      // (T, Bs, D) when D > 0
  const __nv_bfloat16* gx[2];  // (T, Bs, 4H) hoisted gates + bias when D == 0
  const __nv_bfloat16* w[2];   // (4H, D + H): row n = [W_ih[:, n]; W_hh[:, n]]
  const float* bias[2];        // (4H) when D > 0
  float* xg;                   // (T, Bs, 4H) f32 scratch for phase 0 when D > 0
  __nv_bfloat16* ys[2];        // (T, Bs, H), natural time for both directions
  float* h_last;               // (Bs, H) direction 0 final h, or null
  float* c_last;               // (Bs, H) direction 0 final c, or null
  __nv_bfloat16* g_res[2];     // (T, Bs, 4H) pre-activation gates, or null
  __nv_bfloat16* c_res[2];     // (T, Bs, H) cell state before the step, or null
  unsigned int* bar;           // the grid barrier's arrival counter, zeroed by the wrapper
};

// A block's shared memory for U units of H over B rows, the weights aside:
// h_{t-1}, the partial tiles of `slots` slots, the input half, c and the
// residual tile.
__host__ __device__ inline size_t lstm_base_bytes(int U, int H, int B, int slots) {
  const int NP = mstts_round_up(4 * U, 8), BP = mstts_round_up(B, 16);
  return 2 * (size_t)BP * mstts_ldmatrix_stride(H) +
         4 * ((size_t)slots * BP * NP + (size_t)B * NP + (size_t)B * U) +
         2 * ((size_t)B * 4 * U + (size_t)B * U);
}

// The full layout: the base and the block's W_ih and W_hh columns.
__host__ __device__ inline size_t lstm_smem_bytes(int U, int D, int H, int B) {
  const int NP = mstts_round_up(4 * U, 8);
  return lstm_base_bytes(U, H, B, kLstmWarps) +
         2 * (size_t)NP * ((D > 0 ? mstts_k32_stride(D) : 0) + mstts_ldmatrix_stride(H));
}

struct LstmLayout {
  int U, nblk;   // units a block, blocks a direction (mstts_recurrence_grid)
  int wide;      // 0: the full layout; 1: W_ih and the W_hh tiles past ntr from L2
  int ntr;       // W_hh n-tiles resident
  size_t bytes;  // shared memory a block
};

// The layout of a launch over `rows` of a batch of Bs rows on a card of nsm
// SMs and max_smem opt-in bytes a block: the full one wherever it holds
// min(Bs, kLstmMaxRows) rows, else the wide one with as many W_hh tiles as
// fit beside the base. The launch fits if bytes <= max_smem.
__host__ __device__ inline LstmLayout lstm_layout(int ndir, int D, int H, int Bs, int rows,
                                                  int nsm, size_t max_smem) {
  LstmLayout L = {};
  L.U = (ndir * H + nsm - 1) / nsm;
  L.nblk = (H + L.U - 1) / L.U;
  const int NT = mstts_round_up(4 * L.U, 8) / 8;
  L.wide = lstm_smem_bytes(L.U, D, H, Bs < kLstmMaxRows ? Bs : kLstmMaxRows) > max_smem;
  if (!L.wide) {
    L.ntr = NT;
    L.bytes = lstm_smem_bytes(L.U, D, H, rows);
    return L;
  }
  const size_t base = lstm_base_bytes(L.U, H, rows, kLstmWideSlots);
  const size_t tile = 2 * 8 * (size_t)mstts_ldmatrix_stride(H);
  const size_t fit = base > max_smem ? 0 : (max_smem - base) / tile;
  L.ntr = fit < (size_t)NT ? (int)fit : NT;
  L.bytes = base + (size_t)L.ntr * tile;
  return L;
}

template <bool kWide>
__global__ void __launch_bounds__(kLstmThreads, 1) lstm_persistent_kernel(LstmArgs a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int D = a.D, H = a.H, B = a.B, H4 = 4 * a.H;
  const int dir = blockIdx.x / a.nblk;
  const int u0 = (blockIdx.x % a.nblk) * a.U;
  const int U = min(a.U, H - u0);  // units owned (the last block may own fewer)
  const int R = 4 * U;             // gate columns owned: n = g*U + u
  const int NP = mstts_round_up(4 * a.U, 8), NT = (R + 7) / 8;
  const int BP = mstts_round_up(B, 16), MT = BP / 16;
  const int DS = D > 0 && !kWide ? mstts_k32_stride(D) : 0, HS = mstts_ldmatrix_stride(H);
  const int NR = kWide ? 8 * a.ntr : NP;  // W_hh rows resident
  constexpr int kSlots = kWide ? kLstmWideSlots : kLstmWarps;  // partial tiles
  __nv_bfloat16* wx_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [NP][DS] W_ih columns
  __nv_bfloat16* wh_s = wx_s + (size_t)NP * DS;                      // [NR][HS] W_hh columns
  __nv_bfloat16* h_s = wh_s + (size_t)NR * HS;                       // [BP][HS] h_{t-1}
  float* part_s = reinterpret_cast<float*>(h_s + (size_t)BP * HS);   // [warp][BP][NP]
  float* pre_s = part_s + (size_t)kSlots * BP * NP;                  // [B][NP] input half
  float* c_s = pre_s + (size_t)B * NP;                               // [B][a.U]
  __nv_bfloat16* gres_s = reinterpret_cast<__nv_bfloat16*>(c_s + (size_t)B * a.U);  // [B][R]
  __nv_bfloat16* cres_s = gres_s + (size_t)B * 4 * a.U;                             // [B][a.U]

  // Zero the padded tiles (rows past R or B, columns past D or H), then
  // load the resident weight slice: local row r = g*U + u <- global row
  // g*H + u0 + u (wide layout: W_hh's first NR rows only).
  const size_t n_bf16_16 = ((size_t)NP * DS + (size_t)(NR + BP) * HS) / 8;
  for (size_t i = threadIdx.x; i < n_bf16_16; i += kLstmThreads)
    reinterpret_cast<uint4*>(wx_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = threadIdx.x; i < B * a.U; i += kLstmThreads) c_s[i] = 0.0f;
  __syncthreads();
  const int K8 = (D + H) / 8, D8 = D / 8;
  // This block's global weight row of local gate column n.
  auto wrow = [&](int n) { return a.w[dir] + (size_t)((n / U) * H + u0 + n % U) * (D + H); };
  if constexpr (!kWide) {
    for (int i = threadIdx.x; i < R * K8; i += kLstmThreads) {
      const int r = i / K8, k8 = i - r * K8;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(wrow(r)) + k8);
      if (k8 < D8)
        reinterpret_cast<uint4*>(wx_s + (size_t)r * DS)[k8] = v;
      else
        reinterpret_cast<uint4*>(wh_s + (size_t)r * HS)[k8 - D8] = v;
    }
  } else {
    const int H8 = H / 8, RR = min(R, NR);
    for (int i = threadIdx.x; i < RR * H8; i += kLstmThreads) {
      const int r = i / H8, k8 = i - r * H8;
      reinterpret_cast<uint4*>(wh_s + (size_t)r * HS)[k8] =
          __ldg(reinterpret_cast<const uint4*>(wrow(r) + D) + k8);
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g8 = lane >> 2, tq = lane & 3;  // fragment row / column pair of this lane

  // Phase 0: X[m, n] = x[m] . W_ih[:, n] + b[n] for the rows m = t*B + b of
  // this launch and the block's columns, 32 rows (two m-tiles) a warp at a
  // time. Each lane loads 8 consecutive k of rows g8 + {0, 8, 16, 24}
  // straight from global memory (mstts_mma_bf16_k32 pairs them with the same
  // k of the weight rows); the loads of the next two 32-wide k chunks are in
  // flight while the current two's MMAs run. Every block reads all of x
  // (3 MB at the train shape) through L2, so this phase is bound by L2
  // bandwidth and by the loads a lane keeps in flight.
  if (D > 0) {
    const int M = a.T * B, kchunks = (D + 31) / 32;
    for (int m0 = warp * 32; m0 < M; m0 += kLstmWarps * 32) {
      const __nv_bfloat16* xr[4];
      size_t row[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int m = m0 + g8 + 8 * r;
        row[r] = (size_t)(m / B) * a.Bs + m % B;
        xr[r] = m < M ? a.x + row[r] * D + tq * 8 : nullptr;
      }
      auto load = [&](uint4 (&buf)[kLstmRing][4], int kc) {
#pragma unroll
        for (int q = 0; q < kLstmRing; ++q)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            buf[q][r] = (kc + q < kchunks && (kc + q) * 32 + tq * 8 < D && xr[r] != nullptr)
                            ? __ldg(reinterpret_cast<const uint4*>(xr[r] + (kc + q) * 32))
                            : make_uint4(0u, 0u, 0u, 0u);
      };
      for (int ng = 0; ng < NT; ng += kLstmNGroup) {
        // Wide layout: this lane's W_ih row of each n-tile, read from L2 in
        // the same ring as x (wcur / wnxt: the weight pieces of the chunks
        // whose x pieces cur / nxt hold).
        const __nv_bfloat16* wxr[kLstmNGroup];
#pragma unroll
        for (int j = 0; j < kLstmNGroup; ++j) {
          const int n = (ng + j) * 8 + g8;
          wxr[j] = kWide && ng + j < NT && n < R ? wrow(n) + tq * 8 : nullptr;
        }
        auto loadw = [&](uint4 (&buf)[kLstmRing][kLstmNGroup], int kc) {
#pragma unroll
          for (int q = 0; q < kLstmRing; ++q)
#pragma unroll
            for (int j = 0; j < kLstmNGroup; ++j)
              buf[q][j] = wxr[j] != nullptr && kc + q < kchunks && (kc + q) * 32 + tq * 8 < D
                              ? __ldg(reinterpret_cast<const uint4*>(wxr[j] + (kc + q) * 32))
                              : make_uint4(0u, 0u, 0u, 0u);
        };
        float acc[2][kLstmNGroup][4] = {};
        uint4 cur[kLstmRing][4], nxt[kLstmRing][4];
        uint4 wcur[kLstmRing][kLstmNGroup], wnxt[kLstmRing][kLstmNGroup];
        load(cur, 0);
        if constexpr (kWide) loadw(wcur, 0);
        for (int kc = 0; kc < kchunks; kc += kLstmRing) {
          const bool more = kc + kLstmRing < kchunks;
          if (more) load(nxt, kc + kLstmRing);
          if constexpr (kWide) {
            if (more) loadw(wnxt, kc + kLstmRing);
          }
#pragma unroll
          for (int q = 0; q < kLstmRing; ++q) {
#pragma unroll
            for (int j = 0; j < kLstmNGroup; ++j) {
              if (kc + q < kchunks && ng + j < NT) {
                uint4 b;
                if constexpr (kWide)
                  b = wcur[q][j];
                else
                  b = *reinterpret_cast<const uint4*>(
                      wx_s + (size_t)((ng + j) * 8 + g8) * DS + (kc + q) * 32 + tq * 8);
                mstts_mma_bf16_k32(acc[0][j], cur[q][0], cur[q][1], b);
                mstts_mma_bf16_k32(acc[1][j], cur[q][2], cur[q][3], b);
              }
            }
          }
          if (more) {
#pragma unroll
            for (int q = 0; q < kLstmRing; ++q)
#pragma unroll
              for (int r = 0; r < 4; ++r) cur[q][r] = nxt[q][r];
            if constexpr (kWide) {
#pragma unroll
              for (int q = 0; q < kLstmRing; ++q)
#pragma unroll
                for (int j = 0; j < kLstmNGroup; ++j) wcur[q][j] = wnxt[q][j];
            }
          }
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
          for (int j = 0; j < kLstmNGroup; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = 2 * mi + (e >> 1);  // row slot: g8 + 8r
              const int n = (ng + j) * 8 + 2 * tq + (e & 1);
              if (ng + j < NT && xr[r] != nullptr && n < R) {
                const int col = (n / U) * H + u0 + n % U;
                a.xg[row[r] * H4 + col] = acc[mi][j][e] + a.bias[dir][col];
              }
            }
          }
        }
      }
    }
    __syncthreads();  // the block's own xg writes, visible to its threads
  }

  // The input half of step s: phase 0's scratch (read through L2) or the
  // caller's hoisted gates. fetch_pre loads up to kLstmPre values a thread
  // into registers a step ahead; put_pre stores them into pre_s and loads
  // any further values (4U > 32 gate columns) directly.
  float pre_v[kLstmPre];
  auto pre_at = [&](int s, int i) {
    const int t = dir == 0 ? s : a.T - 1 - s;
    const int b = i / R, n = i - b * R;
    const size_t off = ((size_t)t * a.Bs + b) * H4 + (n / U) * H + u0 + n % U;
    return D > 0 ? __ldcg(a.xg + off) : __bfloat162float(__ldg(a.gx[dir] + off));
  };
  auto fetch_pre = [&](int s) {
#pragma unroll
    for (int q = 0; q < kLstmPre; ++q) {
      const int i = q * kLstmThreads + threadIdx.x;
      if (i < B * R) pre_v[q] = pre_at(s, i);
    }
  };
  auto put_pre = [&](int s) {
#pragma unroll
    for (int q = 0; q < kLstmPre; ++q) {
      const int i = q * kLstmThreads + threadIdx.x;
      if (i < B * R) pre_s[(i / R) * NP + i % R] = pre_v[q];
    }
    for (int i = kLstmPre * kLstmThreads + threadIdx.x; i < B * R; i += kLstmThreads)
      pre_s[(i / R) * NP + i % R] = pre_at(s, i);
  };
  // Residual runs of step s: four gate runs and one c_{t-1} run per row,
  // stored by warps 1-7: thread 0 fences after the barrier's wait, which
  // would wait for stores of its own.
  auto store_residuals = [&](int s) {
    const int t = dir == 0 ? s : a.T - 1 - s;
    for (int i = threadIdx.x - 32; i < B * 5; i += kLstmThreads - 32) {
      if (i < 0) break;
      const int b = i / 5, k = i - b * 5;
      const size_t row = (size_t)t * a.Bs + b;
      if (k < 4)
        mstts_store_bf16_run(a.g_res[dir] + row * H4 + k * H + u0, gres_s + (b * 4 + k) * U, U);
      else
        mstts_store_bf16_run(a.c_res[dir] + row * H + u0, cres_s + b * U, U);
    }
  };
  fetch_pre(0);
  put_pre(0);

  const int ksteps = (H + 15) / 16;
  // This warp's k range (its slot's) and its first n-group; the full
  // layout: a k range a warp, every n-group.
  const int slot = warp % kSlots, pair = warp / kSlots;
  const int kb = slot * ksteps / kSlots, ke = (slot + 1) * ksteps / kSlots;
  const bool residuals = a.g_res[dir] != nullptr;
  unsigned int epoch = 0;  // of the grid barrier
  for (int s = 0; s < a.T; ++s) {
    const int t = dir == 0 ? s : a.T - 1 - s;  // natural time of this step
    const int tp = dir == 0 ? t - 1 : t + 1;   // natural time of h_{prev}
    if (s + 1 < a.T) fetch_pre(s + 1);  // in flight through the step
    if (s > 0) {  // at s = 0, h_s holds zeros
      // Each warp stages the columns of h_{t-1} that its own k range reads
      // (and no other warp does), so it waits for its own copies only; in
      // the wide layout the two warps of a slot share them, and the block
      // waits for all. Written by other blocks this launch: cp.async.cg
      // reads through L2.
      const int c0 = 2 * kb, cw = min(2 * ke, H / 8) - c0;  // 8-column pieces
      const __nv_bfloat16* src = a.ys[dir] + (size_t)tp * a.Bs * H;
      for (int i = lane + 32 * pair; i < B * cw; i += 32 * (kLstmWarps / kSlots)) {
        const int b = i / cw, k8 = c0 + i % cw;
        mstts_cp_async16(h_s + (size_t)b * HS + 8 * k8, src + (size_t)b * H + 8 * k8);
      }
      mstts_cp_async_wait_all();
      if constexpr (kWide)
        __syncthreads();
      else
        __syncwarp();
    }

    // The recurrent half: this warp's k range of h_{t-1} . W_hh slice.
    for (int ng = pair * kLstmNGroup; ng < NT; ng += kLstmWarps / kSlots * kLstmNGroup) {
      // Wide layout: a streamed n-tile's B fragments (b0 = k 2tq, 2tq + 1 and
      // b1 = k 2tq + 8, 2tq + 9 of row n = g8) come from this lane's W_hh row
      // in L2, loaded one k-step ahead of their MMAs.
      const __nv_bfloat16* whr[kLstmNGroup];
      uint32_t nb[kLstmNGroup][2];
      auto fetch = [&](int ks) {
#pragma unroll
        for (int j = 0; j < kLstmNGroup; ++j) {
          const int k0 = ks * 16 + 2 * tq;
          const bool on = whr[j] != nullptr && ks < ke;
          nb[j][0] = on ? __ldg(reinterpret_cast<const unsigned int*>(whr[j] + k0)) : 0u;
          nb[j][1] = on && k0 + 8 < H
                         ? __ldg(reinterpret_cast<const unsigned int*>(whr[j] + k0 + 8)) : 0u;
        }
      };
      if constexpr (kWide) {
#pragma unroll
        for (int j = 0; j < kLstmNGroup; ++j) {
          const int n = (ng + j) * 8 + g8;
          whr[j] = ng + j >= a.ntr && ng + j < NT && n < R ? wrow(n) + D : nullptr;
        }
        fetch(kb);
      }
      float acc[kLstmMT][kLstmNGroup][4] = {};
      for (int ks = kb; ks < ke; ++ks) {
        const int k0 = ks * 16;
        uint32_t bf[kLstmNGroup][2];
        if constexpr (kWide) {
#pragma unroll
          for (int j = 0; j < kLstmNGroup; ++j) {
            bf[j][0] = nb[j][0];
            bf[j][1] = nb[j][1];
          }
          fetch(ks + 1);
        }
#pragma unroll
        for (int j = 0; j < kLstmNGroup; ++j)
          if (ng + j < NT && (!kWide || ng + j < a.ntr))
            mstts_ldmatrix_x2(bf[j], wh_s + (size_t)((ng + j) * 8 + (lane & 7)) * HS + k0 +
                                         ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < kLstmMT; ++mi) {
          if (mi < MT) {
            uint32_t af[4];
            mstts_ldmatrix_x4(af, h_s + (size_t)(mi * 16 + (lane & 15)) * HS + k0 +
                                      (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < kLstmNGroup; ++j)
              if (ng + j < NT)
                mstts_mma_bf16(acc[mi][j], af[0], af[1], af[2], af[3], bf[j][0], bf[j][1]);
          }
        }
      }
      float* pw = part_s + (size_t)slot * BP * NP;
#pragma unroll
      for (int mi = 0; mi < kLstmMT; ++mi) {
#pragma unroll
        for (int j = 0; j < kLstmNGroup; ++j) {
          if (mi < MT && ng + j < NT) {
            const int m = mi * 16 + g8, n = (ng + j) * 8 + 2 * tq;
            *reinterpret_cast<float2*>(pw + m * NP + n) = make_float2(acc[mi][j][0], acc[mi][j][1]);
            *reinterpret_cast<float2*>(pw + (m + 8) * NP + n) =
                make_float2(acc[mi][j][2], acc[mi][j][3]);
          }
        }
      }
    }
    __syncthreads();

    // Cell update: gates = input half + the warps' partials, in warp order.
    for (int i = threadIdx.x; i < B * U; i += kLstmThreads) {
      const int b = i / U, u = i - b * U;
      float gs[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const int n = g * U + u;
        float v = pre_s[b * NP + n];
#pragma unroll
        for (int w = 0; w < kSlots; ++w) v += part_s[((size_t)w * BP + b) * NP + n];
        gs[g] = v;
      }
      const float ig = mstts_sigmoid(gs[0]);
      const float fg = mstts_sigmoid(gs[1]);
      const float gg = tanhf(gs[2]);
      const float og = mstts_sigmoid(gs[3]);
      const float c_prev = c_s[b * a.U + u];
      const float c = fg * c_prev + ig * gg;
      const float h = og * tanhf(c);
      c_s[b * a.U + u] = c;
      a.ys[dir][((size_t)t * a.Bs + b) * H + u0 + u] = __float2bfloat16(h);
      if (residuals) {
#pragma unroll
        for (int g = 0; g < 4; ++g) gres_s[(b * 4 + g) * U + u] = __float2bfloat16(gs[g]);
        cres_s[b * U + u] = __float2bfloat16(c_prev);
      }
      if (s == a.T - 1 && dir == 0 && a.h_last != nullptr) {
        a.h_last[(size_t)b * H + u0 + u] = h;
        a.c_last[(size_t)b * H + u0 + u] = c;
      }
    }
    if (s + 1 < a.T) {
      // h_t is out: arrive, then do what needs no other block, then wait.
      mstts_grid_arrive(a.bar, epoch);
      put_pre(s + 1);
      if (residuals) store_residuals(s);
      mstts_grid_wait(a.bar, epoch);
    } else if (residuals) {
      __syncthreads();
      store_residuals(s);
    }
  }
}

// Runs the recurrence of ndir directions for rows b0 .. b0 + rows of the
// batch (a.Bs rows) in one cooperative launch, in the layout lstm_layout
// gives, or refuses them where it does not fit. Rows are independent
// (only the weights are shared), so the caller runs a batch in groups
// (ops/lstm_kernel.py::fwd_row_groups), each launch with a barrier counter
// of its own. `a` arrives with its pointers at row 0.
inline int lstm_run(LstmArgs a, int ndir, int b0, int rows, cudaStream_t stream) {
  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  if (a.D % 8 != 0 || a.H % 8 != 0 || a.T < 1 || a.Bs < 1 || (a.D > 0 && a.xg == nullptr) ||
      b0 < 0 || rows < 1 || rows > kLstmMaxRows || b0 + rows > a.Bs)
    return (int)cudaErrorInvalidValue;
  const LstmLayout L = lstm_layout(ndir, a.D, a.H, a.Bs, rows, nsm, (size_t)max_smem);
  if (L.bytes > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  a.U = L.U;
  a.nblk = L.nblk;
  a.ntr = L.ntr;
  a.B = rows;
  if (a.x) a.x += (size_t)b0 * a.D;
  if (a.xg) a.xg += (size_t)b0 * 4 * a.H;
  for (int d = 0; d < ndir; ++d) {
    if (a.gx[d]) a.gx[d] += (size_t)b0 * 4 * a.H;
    a.ys[d] += (size_t)b0 * a.H;
    if (a.g_res[d]) {
      a.g_res[d] += (size_t)b0 * 4 * a.H;
      a.c_res[d] += (size_t)b0 * a.H;
    }
  }
  if (a.h_last) {
    a.h_last += (size_t)b0 * a.H;
    a.c_last += (size_t)b0 * a.H;
  }
  const void* kernel = L.wide ? (const void*)lstm_persistent_kernel<true>
                              : (const void*)lstm_persistent_kernel<false>;
  MSTTS_CHECK(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)L.bytes));
  void* params[] = {&a};
  MSTTS_CHECK(cudaLaunchCooperativeKernel(kernel, dim3(ndir * L.nblk), dim3(kLstmThreads), params,
                                          L.bytes, stream));
  MSTTS_RETURN_LAUNCH_ERROR();
}

// The layout of a launch on this card, for the caller's mirror
// (ops/lstm_kernel.fwd_layout): out = U, nblk, wide, ntr, bytes, fits.
inline int lstm_layout_of(int ndir, int D, int H, int Bs, int rows, int* out) {
  int dev = 0, nsm = 0, max_smem = 0;
  MSTTS_CHECK(cudaGetDevice(&dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev));
  MSTTS_CHECK(cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev));
  const LstmLayout L = lstm_layout(ndir, D, H, Bs, rows, nsm, (size_t)max_smem);
  out[0] = L.U;
  out[1] = L.nblk;
  out[2] = L.wide;
  out[3] = L.ntr;
  out[4] = (int)L.bytes;
  out[5] = L.bytes <= (size_t)max_smem && rows <= kLstmMaxRows;
  return 0;
}

}  // namespace mstts
