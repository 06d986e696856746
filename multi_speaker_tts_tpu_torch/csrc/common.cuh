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
// bar[0] counts arrivals and is back at 0 after each barrier; bar[1] is a
// generation number the last arrival advances. The wrapper zeroes both
// before the first launch. Writes made before the barrier by any thread of
// any block are visible to every thread after it (__syncthreads, then a
// device-scope fence by the arriving thread, as cooperative_groups does).
__device__ __forceinline__ void mstts_grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int gen = mstts_ld_acquire(bar + 1);
    __threadfence();
    const unsigned int arrived = atomicAdd(bar, 1u);
    if (arrived == gridDim.x * gridDim.y * gridDim.z - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (mstts_ld_acquire(bar + 1) == gen) __nanosleep(20);
    }
    __threadfence();
  }
  __syncthreads();
}
