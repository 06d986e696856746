// The recurrent products of one BiGRU step, as the kernels run them;
// barrier_floor.cu runs the same products, without the gates and the cell,
// for the BiGRU's sequential floors.
//
// Forward (bigru.cu): gh^T = W_hh^T . bf16(h)^T. Backward (bigru_bwd.cu):
// dh^T = W_hh . bf16(dGh)^T, K = 3H. A block has KS = H / 16 warps; warp w
// owns hidden units [16w, 16w + 16) and, for each gate q (r, z, n), one
// m16 x H slice of the A matrix, H / 16 k-steps: in the forward the rows
// of W_hh^T for gate columns qH + u (K: the hidden inputs), in the backward
// the rows u of W_hh over gate columns qH .. qH + H - 1 (K: the gate
// gradients; m16 row g holds unit 16w + 2g and row g + 8 unit 16w + 2g + 1,
// so that a thread's two units of the C fragment are neighbours and its
// cell reads and writes them as pairs). The A fragments of the first
// gru_reg_steps(KS) k-steps of each gate stay in registers for the whole
// launch (12 registers a k-step); above H = 128 the rest stay in shared
// memory, one row of the remaining k
// values per (gate, unit), read by ldmatrix every step. The B fragments are
// the 8 rows of h_{t-1} (forward) or of bf16(dGh) (backward), read by
// ldmatrix from shared memory. Sums go to four accumulators a gate (k-step
// mod 4), added in a fixed order by the caller.
#pragma once

#include "common.cuh"

constexpr int kGruRows = 8;  // batch rows a block: the n of one MMA tile

// k-steps a gate whose A fragments a thread keeps in registers: all of them
// up to H = 128 (96 registers at 256 threads), then fewer as the block
// grows past 8 warps, so that a thread stays within the 168 registers that
// 3 warps a scheduler leave it. The backward at H = 192 holds one more:
// the shared memory the rest would take is its residual ring's.
__host__ __device__ constexpr int gru_reg_steps(int KS, bool bwd = false) {
  return KS <= 8 ? KS : (bwd && KS == 12 ? 5 : 16 - KS);
}

// Row stride (elements) of the shared-memory A rows: the k values past the
// register k-steps, padded for conflict-free ldmatrix.
__host__ __device__ constexpr int gru_wsmem_stride(int H, bool bwd = false) {
  return mstts_ldmatrix_stride(H - 16 * gru_reg_steps(H / 16, bwd));
}

// Elements of the shared-memory A rows (0 up to H = 128).
__host__ __device__ constexpr size_t gru_wsmem_elems(int H, bool bwd = false) {
  return H / 16 > gru_reg_steps(H / 16, bwd) ? (size_t)3 * H * gru_wsmem_stride(H, bwd) : 0;
}

// The cell's sigmoid and tanh from the ex2 and rcp approximations: about
// 1e-6 absolute error, far below the bf16 outputs' step (4e-3 near 1), and a
// few instructions each, where the accurate expf, division and tanhf are
// long sequences on the step's dependent chain.
__device__ __forceinline__ float fast_sigmoid(float x) { return __fdividef(1.0f, 1.0f + __expf(-x)); }
__device__ __forceinline__ float fast_tanh(float x) { return 2.0f * fast_sigmoid(2.0f * x) - 1.0f; }

template <int KS, bool kBwd = false>
struct GruProduct {
  static constexpr int H = 16 * KS, KR = gru_reg_steps(KS, kBwd);
  // Element (gate q, row u, k) of the A slices in the source matrix: the
  // forward's W_hh^T (3H, H) at (qH + u) H + k, the backward's W_hh (H, 3H)
  // at u 3H + qH + k.
  static constexpr size_t kGateOff = kBwd ? H : (size_t)H * H, kRowLen = kBwd ? 3 * H : H;

  // The unit of m16 row m (0..15) of warp w's tile.
  static __device__ __forceinline__ int unit(int warp, int m) {
    return 16 * warp + (kBwd ? 2 * (m & 7) + (m >> 3) : m);
  }
  uint32_t wf[3][KR][4];           // register A fragments, k-steps 0 .. KR - 1
  const __nv_bfloat16* wa;         // this lane's shared A row for ldmatrix
  int WS;

  // Loads the shared rows with every thread of the block, then this warp's
  // register fragments (w: the source matrix above; ws: shared memory of
  // gru_wsmem_elems(H, kBwd)). The caller syncs the block before the first
  // product.
  __device__ __forceinline__ void load(const __nv_bfloat16* w, __nv_bfloat16* ws) {
    load_rows(w, ws);
    load_regs(w, ws);
  }

  // The shared rows, with every thread of the block.
  static __device__ __forceinline__ void load_rows(const __nv_bfloat16* w, __nv_bfloat16* ws) {
    if constexpr (KR < KS) {
      constexpr int XC = 2 * (KS - KR);  // 16-byte chunks of a shared row
      constexpr int WSC = gru_wsmem_stride(H, kBwd);
      // Shared row qH + 16w + m holds gate q's remaining k values of unit
      // unit(w, m): the rows of a tile lie in m order, conflict-free.
      for (int i = threadIdx.x; i < 3 * H * XC; i += blockDim.x) {
        const int n = i / XC, c = i - n * XC, q = n / H, m = n - q * H;
        *reinterpret_cast<uint4*>(ws + (size_t)n * WSC + 8 * c) =
            __ldg(reinterpret_cast<const uint4*>(w + q * kGateOff + unit(m / 16, m % 16) * kRowLen +
                                                 16 * KR + 8 * c));
      }
    }
  }

  __device__ __forceinline__ void load_regs(const __nv_bfloat16* w, const __nv_bfloat16* ws) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int g8 = lane >> 2, tq = lane & 3;
    // a0 = (row g, k 2t..2t+1), a1 = (row g + 8, ..), a2 / a3 the same at k + 8.
#pragma unroll
    for (int q = 0; q < 3; ++q) {
      const uint32_t* w0 =
          reinterpret_cast<const uint32_t*>(w + q * kGateOff + unit(warp, g8) * kRowLen);
      const uint32_t* w1 =
          reinterpret_cast<const uint32_t*>(w + q * kGateOff + unit(warp, g8 + 8) * kRowLen);
#pragma unroll
      for (int ks = 0; ks < KR; ++ks) {
        wf[q][ks][0] = __ldg(w0 + 8 * ks + tq);
        wf[q][ks][1] = __ldg(w1 + 8 * ks + tq);
        wf[q][ks][2] = __ldg(w0 + 8 * ks + 4 + tq);
        wf[q][ks][3] = __ldg(w1 + 8 * ks + 4 + tq);
      }
    }
    WS = gru_wsmem_stride(H, kBwd);
    // ldmatrix x4 of an m16k16 tile: lane l addresses row l % 16, k half l / 16.
    wa = ws + (size_t)(16 * warp + (lane & 15)) * WS + (lane >> 4) * 8;
  }

  // acc[q][j] += the k-steps ks = j (mod 4) of gate q; hB: this lane's
  // ldmatrix address of the k-step 0 B fragment, row lane % 8 at k offset
  // 8 (lane / 8) (the forward's h_{t-1}, shared by the three gates, one
  // k-step an ldmatrix x2; the backward's bf16(dGh), gate q's k values at
  // hB + qH, two k-steps an ldmatrix x4).
  __device__ __forceinline__ void run(float (&acc)[3][4][4], const __nv_bfloat16* hB) const {
    constexpr int kStep = kBwd ? 2 : 1;  // k-steps an ldmatrix of B
#pragma unroll
    for (int ks0 = 0; ks0 < KS; ks0 += kStep) {
      uint32_t bf[3][4];
#pragma unroll
      for (int q = 0; q < (kBwd ? 3 : 1); ++q) {
        if (kBwd && ks0 + 1 < KS)
          mstts_ldmatrix_x4(bf[q], hB + q * H + 16 * ks0);
        else
          mstts_ldmatrix_x2(bf[q], hB + q * H + 16 * ks0);
      }
#pragma unroll
      for (int ks = ks0; ks < ks0 + kStep && ks < KS; ++ks) {
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const uint32_t* b = bf[kBwd ? q : 0] + 2 * (ks - ks0);
          mma(acc[q][ks & 3], q, ks, b);
        }
      }
    }
  }

 private:
  __device__ __forceinline__ void mma(float* c, int q, int ks, const uint32_t* b) const {
    if (ks < KR) {  // resolved at compile time: the loops are unrolled
      const int r = ks < KR ? ks : 0;  // in range in the branch that is dropped, too
      mstts_mma_bf16(c, wf[q][r][0], wf[q][r][1], wf[q][r][2], wf[q][r][3], b[0], b[1]);
    } else {
      uint32_t af[4];
      mstts_ldmatrix_x4(af, wa + (size_t)q * H * WS + 16 * (ks - KR));
      mstts_mma_bf16(c, af[0], af[1], af[2], af[3], b[0], b[1]);
    }
  }
};
