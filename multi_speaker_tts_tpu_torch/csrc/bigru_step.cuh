// The recurrent product of one BiGRU forward step, gh^T = W_hh^T . bf16(h)^T,
// as bigru.cu runs it; barrier_floor.cu runs the same product, without the
// gates and the cell, for the BiGRU's sequential floor.
//
// A block has KS = H / 16 warps; warp w owns hidden units [16w, 16w + 16)
// and their r, z and n gate columns (u, H + u, 2H + u): three m16 tiles of
// W_hh^T, H / 16 k-steps each. The A fragments of the first gru_reg_steps(KS)
// k-steps stay in registers for the whole launch (12 registers a k-step);
// above H = 128 the rest stay in shared memory, one row of the remaining k
// values per gate column, read by ldmatrix every step. The B fragments are
// the rows of h_{t-1}, read by ldmatrix from shared memory. Sums go to four
// accumulators a gate (k-step mod 4), added in a fixed order by the caller.
#pragma once

#include "common.cuh"

constexpr int kGruRows = 8;  // batch rows a block: the n of one MMA tile

// k-steps whose A fragments a thread keeps in registers: all of them up to
// H = 128 (96 registers at 256 threads), then fewer as the block grows, so
// that a thread stays within the 65536 / (32 KS) registers an SM gives it.
__host__ __device__ constexpr int gru_reg_steps(int KS) { return KS <= 8 ? KS : 16 - KS; }

// Row stride (elements) of the shared-memory A rows: the k values past the
// register k-steps, padded for conflict-free ldmatrix.
__host__ __device__ inline int gru_wsmem_stride(int H) {
  return mstts_ldmatrix_stride(H - 16 * gru_reg_steps(H / 16));
}

// Elements of the shared-memory A rows (0 up to H = 128).
__host__ __device__ inline size_t gru_wsmem_elems(int H) {
  return H / 16 > gru_reg_steps(H / 16) ? (size_t)3 * H * gru_wsmem_stride(H) : 0;
}

template <int KS>
struct GruProduct {
  static constexpr int H = 16 * KS, KR = gru_reg_steps(KS);
  uint32_t wf[3][KR][4];           // register A fragments, k-steps 0 .. KR - 1
  const __nv_bfloat16* wa;         // this lane's shared A row for ldmatrix
  int WS;

  // Loads the register fragments and, with every thread of the block, the
  // shared rows (wt: (3H, H) W_hh^T, row n holds its k values; ws: shared
  // memory of gru_wsmem_elems(H)). The caller syncs the block before the
  // first product.
  __device__ __forceinline__ void load(const __nv_bfloat16* wt, __nv_bfloat16* ws) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g8 = lane >> 2, tq = lane & 3;
    // a0 = (col g, k 2t..2t+1), a1 = (col g + 8, ..), a2 / a3 the same at k + 8.
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const int col = q * H + 16 * warp + g8;
      const uint32_t* w0 = reinterpret_cast<const uint32_t*>(wt + (size_t)col * H);
      const uint32_t* w1 = reinterpret_cast<const uint32_t*>(wt + (size_t)(col + 8) * H);
#pragma unroll
      for (int ks = 0; ks < KR; ++ks) {
        wf[q][ks][0] = __ldg(w0 + 8 * ks + tq);
        wf[q][ks][1] = __ldg(w1 + 8 * ks + tq);
        wf[q][ks][2] = __ldg(w0 + 8 * ks + 4 + tq);
        wf[q][ks][3] = __ldg(w1 + 8 * ks + 4 + tq);
      }
    }
    WS = gru_wsmem_stride(H);
    if constexpr (KR < KS) {
      constexpr int XC = 2 * (KS - KR);  // 16-byte chunks of a shared row
      for (int i = threadIdx.x; i < 3 * H * XC; i += blockDim.x) {
        const int n = i / XC, c = i - n * XC;
        *reinterpret_cast<uint4*>(ws + (size_t)n * WS + 8 * c) =
            __ldg(reinterpret_cast<const uint4*>(wt + (size_t)n * H + 16 * KR + 8 * c));
      }
    }
    // ldmatrix x4 of an m16k16 tile: lane l addresses row l % 16, k half l / 16.
    wa = ws + (size_t)(16 * warp + (lane & 15)) * WS + (lane >> 4) * 8;
  }

  // acc[q][j] += the k-steps ks = j (mod 4) of gate q; hB: this lane's
  // ldmatrix address of the k-step 0 B fragment of h_{t-1}.
  __device__ __forceinline__ void run(float (&acc)[3][4][4], const __nv_bfloat16* hB) const {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t bf[2];
      mstts_ldmatrix_x2(bf, hB + 16 * ks);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        if (ks < KR) {  // resolved at compile time: the loop is unrolled
          const int r = ks < KR ? ks : 0;  // in range in the branch that is dropped, too
          mstts_mma_bf16(acc[q][ks & 3], wf[q][r][0], wf[q][r][1], wf[q][r][2], wf[q][r][3],
                         bf[0], bf[1]);
        } else {
          uint32_t af[4];
          mstts_ldmatrix_x4(af, wa + (size_t)q * H * WS + 16 * (ks - KR));
          mstts_mma_bf16(acc[q][ks & 3], af[0], af[1], af[2], af[3], bf[0], bf[1]);
        }
      }
    }
  }
};
