// The sequential floor of the persistent recurrences: their grid and block
// (common.cuh's mstts_recurrence_grid, 256 threads) and `rounds` rounds of
// their grid barrier, with no arithmetic and no memory traffic besides the
// barrier's own. Replaces no TPU kernel: chip_smoke.py times it beside the
// LSTM and BiLSTM kernels (their rows' floor_ms) to show how far each is
// from the least time its T dependent steps can take on the card.
#include "common.cuh"

__global__ void __launch_bounds__(256, 1) mstts_barrier_floor_kernel(unsigned int* bar,
                                                                     int rounds) {
  unsigned int epoch = 0;
  for (int r = 0; r < rounds; ++r) mstts_grid_barrier(bar, epoch);
}

// blocks_out (host) receives the grid size, so that a caller can check the
// counter: rounds * blocks arrivals.
MSTTS_EXPORT int mstts_barrier_floor(void* bar, int rounds, int ndir, int H, void* blocks_out,
                                     void* stream) {
  if (rounds < 0 || ndir < 1 || H < 1) return (int)cudaErrorInvalidValue;
  int U = 0, nblk = 0;
  MSTTS_CHECK(mstts_recurrence_grid(ndir, H, &U, &nblk));
  *static_cast<int*>(blocks_out) = ndir * nblk;
  unsigned int* counter = static_cast<unsigned int*>(bar);
  void* params[] = {&counter, &rounds};
  MSTTS_CHECK(cudaLaunchCooperativeKernel((const void*)mstts_barrier_floor_kernel,
                                          dim3(ndir * nblk), dim3(256), params, 0,
                                          static_cast<cudaStream_t>(stream)));
  MSTTS_RETURN_LAUNCH_ERROR();
}
