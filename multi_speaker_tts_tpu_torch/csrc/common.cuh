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
__device__ __forceinline__ void mstts_grid_barrier(unsigned int* count, unsigned int& epoch) {
  __syncthreads();
  epoch += gridDim.x * gridDim.y * gridDim.z;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    while (mstts_ld_acquire(count) < epoch) {
    }
    __threadfence();
  }
  __syncthreads();
}
