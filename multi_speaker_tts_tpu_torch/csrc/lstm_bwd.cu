// GE2E LSTM layer backward: the reverse recurrence in one persistent
// cooperative launch.
//
// Replaces multi_speaker_tts_tpu/ops/lstm_pallas.py::lstm_seq_layer_bwd
// (kernel body _bwd_kernel; the stack's backward is _stack_bwd). From the
// forward's residuals (pre-activation gates, c_{t-1}; lstm.cu's residual
// mode) and the f32 cotangents of h_T and of each step's output, it emits
// dG (T, B, 4H) bf16; dW_ih, dW_hh, db and dx are whole-sequence GEMMs of
// the caller, as in the JAX package. Design and numerics: lstm_bwd.cuh.
// At the production width (H = 768, 4H = 3072) 128 blocks each keep 6 rows
// of W_hh resident and run dh_{t-1} = dG_t . W_hh^T on tensor cores.
//
// What bounds it on an H100: 64 sequential steps, each a grid barrier and
// one pass over dG_t (196 KB at B = 32) from L2 into every SM; the bytes
// from device memory (~39 MB a layer at B = 32: 12 us at 3.35 TB/s) and
// the 9.7 GFLOP (~10 us of tensor cores) are far below it. The design
// streams dG_t through a register ring of 16-byte loads and loads the next
// step's residuals between the barrier's arrival and its wait.
#include "lstm_bwd.cuh"

MSTTS_EXPORT int mstts_lstm_layer_bwd(const void* gates, const void* c_prev, const void* w,
                                      const void* d_hT, const void* d_ys, void* dG, void* bar,
                                      int T, int B, int H, int b0, int rows, void* stream) {
  mstts::LstmBwdArgs a = {};
  a.T = T;
  a.Bs = B;
  a.H = H;
  a.gates[0] = static_cast<const __nv_bfloat16*>(gates);
  a.c_prev[0] = static_cast<const __nv_bfloat16*>(c_prev);
  a.w[0] = static_cast<const __nv_bfloat16*>(w);
  a.d_hT = static_cast<const float*>(d_hT);
  a.d_ys[0] = static_cast<const float*>(d_ys);
  a.dG[0] = static_cast<__nv_bfloat16*>(dG);
  a.bar = static_cast<unsigned int*>(bar);
  return mstts::lstm_bwd_run(a, 1, b0, rows, static_cast<cudaStream_t>(stream));
}

// The layout a launch takes on this card (lstm_bwd_layout): out = U, nblk,
// wide, ntr, bytes, fits; for ops/lstm_kernel.bwd_layout's card test.
MSTTS_EXPORT int mstts_lstm_bwd_layout(int ndir, int H, int B, int rows, void* out) {
  return mstts::lstm_bwd_layout_of(ndir, H, B, rows, static_cast<int*>(out));
}
