// Shared helpers of the port's Hopper kernels (built for sm_90a).
//
// Every extern "C" entry point launches on the caller's stream, allocates
// nothing, and returns the cudaError_t read with cudaGetLastError() right
// after its launches (0 = success). The Python wrapper raises on anything
// else, with the text from mstts_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MSTTS_EXPORT extern "C" __attribute__((visibility("default")))

MSTTS_EXPORT const char* mstts_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Launch-time failures (bad configuration, too much shared memory) are
// reported by cudaGetLastError; faults during the run surface at the
// caller's next synchronisation.
#define MSTTS_RETURN_LAUNCH_ERROR() return static_cast<int>(cudaGetLastError())

#define MSTTS_CHECK(call)                                  \
  do {                                                     \
    cudaError_t mstts_err_ = (call);                       \
    if (mstts_err_ != cudaSuccess) return (int)mstts_err_; \
  } while (0)

__device__ __forceinline__ float mstts_sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ unsigned int mstts_ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// Grid-wide barrier for a cooperative launch (every block co-resident).
// *count only grows: a block adds one per barrier and waits until every
// arrival of that barrier is in. ``epoch`` is the kernel's running total of
// expected arrivals: one variable per kernel, starting at 0, and every block
// runs the same sequence of barriers. The wrapper zeroes the counter before
// each launch. Writes made before the barrier by any thread of any block
// are visible to every thread after it (__syncthreads, then a device-scope
// fence by the arriving thread, as cooperative_groups does). One fence, one
// atomic and the polling loads: no generation word to read first or reset.
//
// The barrier in two halves: between mstts_grid_arrive and mstts_grid_wait
// a block may do work that no other block's writes of this round feed
// (the recurrences load their next step's inputs there). Nothing written
// by other blocks may be read before the wait returns.
__device__ __forceinline__ void mstts_grid_arrive(unsigned int* count, unsigned int& epoch) {
  __syncthreads();
  epoch += gridDim.x * gridDim.y * gridDim.z;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
  }
}

__device__ __forceinline__ void mstts_grid_wait(const unsigned int* count, unsigned int epoch) {
  if (threadIdx.x == 0) {
    while (mstts_ld_acquire(count) < epoch) {
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void mstts_grid_barrier(unsigned int* count, unsigned int& epoch) {
  mstts_grid_arrive(count, epoch);
  mstts_grid_wait(count, epoch);
}

// The grid of the persistent recurrences (lstm_persistent.cuh,
// lstm_bwd.cuh, barrier_floor.cu): at most one block per SM, since every
// block must be co-resident for the grid barrier, and fewer units per
// block means more parallel blocks. Block j of a direction owns units
// [j * U, min((j + 1) * U, H)).
inline cudaError_t mstts_recurrence_grid(int ndir, int H, int* U, int* nblk) {
  int dev = 0, nsm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  *U = (ndir * H + nsm - 1) / nsm;
  *nblk = (H + *U - 1) / *U;
  return cudaSuccess;
}

__host__ __device__ constexpr int mstts_round_up(int x, int m) { return (x + m - 1) / m * m; }

// Row stride (elements) of a bf16 tile read with ldmatrix: an odd
// multiple of 16 bytes, so eight consecutive rows hit eight bank groups.
__host__ __device__ constexpr int mstts_ldmatrix_stride(int k) { return mstts_round_up(k, 16) + 8; }

// Row stride of a bf16 tile read 16 bytes a lane in 32-wide k chunks
// (lanes 4g..4g+3 read 64 bytes of row g): 64 mod 128 bytes.
__host__ __device__ inline int mstts_k32_stride(int k) {
  const int s = mstts_round_up(k, 32);
  return (2 * s) % 128 == 0 ? s + 32 : s;
}

// One thread copies a run of n bf16 from shared to global memory in the
// widest pieces that the destination's alignment allows.
__device__ __forceinline__ void mstts_store_bf16_run(__nv_bfloat16* dst,
                                                     const __nv_bfloat16* src, int n) {
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  int i = 0;
  while (i < n) {
    const uintptr_t p = reinterpret_cast<uintptr_t>(dst + i);
    if ((p & 7) == 0 && n - i >= 4) {
      *reinterpret_cast<uint2*>(dst + i) =
          make_uint2((uint32_t)s[i] | ((uint32_t)s[i + 1] << 16),
                     (uint32_t)s[i + 2] | ((uint32_t)s[i + 3] << 16));
      i += 4;
    } else if ((p & 3) == 0 && n - i >= 2) {
      *reinterpret_cast<uint32_t*>(dst + i) = (uint32_t)s[i] | ((uint32_t)s[i + 1] << 16);
      i += 2;
    } else {
      dst[i] = src[i];
      ++i;
    }
  }
}

// -- Tensor-core helpers (sm_80+ warp-level MMA, used on sm_90a) ------------
//
// mma.sync m16n8k16, bf16 operands, f32 accumulators. Fragments of lane l
// (g = l / 4, t = l % 4): A (16 x 16, row-major) a0 = (row g, k 2t..2t+1),
// a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..); B (16 x 8,
// stored n-major: row n holds its k values) b0 = (k 2t..2t+1, n g), b1 =
// (k 2t + 8.., n g); C c0, c1 = (row g, n 2t, 2t + 1), c2, c3 = (row g + 8,
// n 2t, 2t + 1).
__device__ __forceinline__ void mstts_mma_bf16(float* c, uint32_t a0, uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t mstts_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ldmatrix reads shared memory that cp.async and plain stores fill: the
// "memory" clobber keeps it after the waits and barriers that order them.
//
// Four 8 x 8 bf16 matrices: lane l gives the address of one 16-byte row;
// lanes 8i..8i+7 the rows of matrix i, which lands in r[i]. For an A tile:
// row (l % 16), column (l / 16) * 8.
__device__ __forceinline__ void mstts_ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(mstts_smem_addr(p))
               : "memory");
}

// Two 8 x 8 matrices from lanes 0-15 (the other lanes' addresses are
// ignored). For a B tile stored n-major: row (l % 8), column (l / 8 % 2) * 8.
__device__ __forceinline__ void mstts_ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(mstts_smem_addr(p))
               : "memory");
}

// Four 8 x 8 bf16 matrices, each transposed on the way: a thread receives
// (row 2t, col g) and (row 2t + 1, col g) of each. For a B operand stored
// k-major (row k holds its n values): lane l gives row k0 + (l % 8) +
// (l / 8 % 2) * 8 at column n0 + (l / 16) * 8; r[0], r[1] are b0, b1 of
// n-tile n0, r[2], r[3] those of n-tile n0 + 8.
__device__ __forceinline__ void mstts_ldmatrix_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(mstts_smem_addr(p))
               : "memory");
}

// 16 bytes global -> shared, cached in L2 only (data that other blocks
// write during the launch must never come from L1).
__device__ __forceinline__ void mstts_cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(mstts_smem_addr(smem)), "l"(gmem) : "memory");
}

__device__ __forceinline__ void mstts_cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// The permuted-k MMA pair: a lane that holds 8 consecutive k values
// (k = 8t .. 8t + 7 of a 32-wide k chunk, one 16-byte load) of A rows g and
// g + 8 and of B row n = g feeds two m16n8k16 products with them. The sum
// over k does not depend on which k each MMA slot carries, as long as A and
// B carry the same: slot (2t, 2t + 1) takes k 8t..8t+1, slot (2t + 8, 2t + 9)
// k 8t+2..8t+3 in the first product, 8t+4.. and 8t+6.. in the second. So a
// row's k chunk is one coalesced 16-byte load a lane, with no shuffle and no
// shared-memory staging.
__device__ __forceinline__ void mstts_mma_bf16_k32(float* c, const uint4& lo, const uint4& hi,
                                                   const uint4& b) {
  mstts_mma_bf16(c, lo.x, hi.x, lo.y, hi.y, b.x, b.y);
  mstts_mma_bf16(c, lo.z, hi.z, lo.w, hi.w, b.z, b.w);
}

// -- The TMA unit's bulk copies (sm_90) -----------------------------------
//
// One thread copies a contiguous run of bytes (a multiple of 16, both ends
// 16-byte aligned) from global to shared memory without a register or an
// instruction per 16 bytes. The copy completes on an mbarrier in shared
// memory: the issuing side adds the bytes it expects (one arrival with
// expect_tx), every reader waits on the barrier's phase. Shared memory that
// plain stores wrote before is handed to the copies by fence.proxy.async.
__device__ __forceinline__ void mstts_mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mstts_smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mstts_mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(mstts_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mstts_mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mstts_smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void mstts_fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mstts_bulk_load(void* smem, const void* gmem, uint32_t bytes,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(mstts_smem_addr(smem)), "l"(gmem), "r"(bytes), "r"(mstts_smem_addr(bar))
      : "memory");
}
