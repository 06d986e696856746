// GE2E LSTM layer: the whole sequence in one persistent cooperative launch.
//
// Replaces multi_speaker_tts_tpu/ops/lstm_pallas.py::lstm_seq_layer_fwd
// (kernel body _fwd_kernel; the stack loop is lstm_stack_seq_pallas).
// As on the TPU, the input projection x_t . W_ih is fused into the step:
// each block keeps its slice of [W_ih; W_hh] resident in shared memory and
// computes gates = [x_t, h_{t-1}] . W + b per step (lstm_persistent.cuh).
// At the production width (H = 768, D = 768) the layer's 9.4 MB of bf16
// weights are read once per launch; 128 blocks of 6 units hold 72 KB of
// weights each. Bound on an H100: 64 steps of barrier and L2 latency; the
// bytes (weights + activations, ~9.7 MB, ~3 us at 3.35 TB/s) and the
// operations (~1.2 GFLOP at 3 windows) are far below it.
//
// g_res / c_res non-null selects the residual mode of
// lstm_seq_layer_fwd(save_residuals=True): the pre-activation gates
// (T, B, 4H) and c_{t-1} (T, B, H), both bf16, for the reverse kernel
// (lstm_bwd.cu).
#include "lstm_persistent.cuh"

MSTTS_EXPORT int mstts_lstm_layer_fwd(const void* x, const void* w, const void* bias,
                                      void* ys, void* h_last, void* c_last, void* g_res,
                                      void* c_res, void* bar, int T, int B, int D, int H,
                                      void* stream) {
  if (D <= 0) return (int)cudaErrorInvalidValue;
  mstts::LstmArgs a = {};
  a.T = T;
  a.B = B;
  a.Bs = B;
  a.D = D;
  a.H = H;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.w[0] = static_cast<const __nv_bfloat16*>(w);
  a.bias[0] = static_cast<const float*>(bias);
  a.ys[0] = static_cast<__nv_bfloat16*>(ys);
  a.h_last = static_cast<float*>(h_last);
  a.c_last = static_cast<float*>(c_last);
  a.g_res[0] = static_cast<__nv_bfloat16*>(g_res);
  a.c_res[0] = static_cast<__nv_bfloat16*>(c_res);
  if ((g_res == nullptr) != (c_res == nullptr)) return (int)cudaErrorInvalidValue;
  a.bar = static_cast<unsigned int*>(bar);
  return mstts::lstm_run(a, 1, static_cast<cudaStream_t>(stream));
}
