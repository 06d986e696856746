// GE2E LSTM layer: the whole sequence in one persistent cooperative launch.
//
// Replaces multi_speaker_tts_tpu/ops/lstm_pallas.py::lstm_seq_layer_fwd
// (kernel body _fwd_kernel; the stack loop is lstm_stack_seq_pallas).
// As on the TPU, the input projection x_t . W_ih + b is computed inside
// the kernel: in its phase 0, before the time loop, on tensor cores, into
// the f32 scratch xg (T, B, 4H) that the caller allocates; each step then
// adds h_{t-1} . W_hh (tensor cores, lstm_persistent.cuh). At the
// production width (H = 768, D = 768) 128 blocks of 6 units keep 74 KB of
// weights each resident for the launch.
//
// What bounds it on an H100: 64 sequential steps, each a grid barrier and
// one L2 round trip of h_{t-1} (48 KB at B = 32). The bytes (weights +
// activations, ~10 MB, ~3 us at 3.35 TB/s) and the operations (~19 GFLOP
// at B = 32, ~20 us of tensor cores) are far below it. The design takes the
// input half off the step (phase 0), makes the step's product 36 MMAs a
// warp at B = 32, and loads the next step's input half and stores the
// residuals between the barrier's arrival and its wait.
//
// Past those widths (a block's full layout no longer holding 32 rows) the
// launch takes the wide layout of lstm_persistent.cuh: W_ih read from L2 in
// phase 0 and the W_hh tiles that do not fit streamed from L2 each step.
// One call launches once, over rows b0 .. b0 + rows of the batch; the
// caller plans the groups (ops/lstm_kernel.fwd_row_groups).
//
// g_res / c_res non-null selects the residual mode of
// lstm_seq_layer_fwd(save_residuals=True): the pre-activation gates
// (T, B, 4H) and c_{t-1} (T, B, H), both bf16, for the reverse kernel
// (lstm_bwd.cu).
#include "lstm_persistent.cuh"

MSTTS_EXPORT int mstts_lstm_layer_fwd(const void* x, const void* w, const void* bias,
                                      void* xg, void* ys, void* h_last, void* c_last, void* g_res,
                                      void* c_res, void* bar, int T, int B, int D, int H,
                                      int b0, int rows, void* stream) {
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
  a.xg = static_cast<float*>(xg);
  a.ys[0] = static_cast<__nv_bfloat16*>(ys);
  a.h_last = static_cast<float*>(h_last);
  a.c_last = static_cast<float*>(c_last);
  a.g_res[0] = static_cast<__nv_bfloat16*>(g_res);
  a.c_res[0] = static_cast<__nv_bfloat16*>(c_res);
  if ((g_res == nullptr) != (c_res == nullptr)) return (int)cudaErrorInvalidValue;
  a.bar = static_cast<unsigned int*>(bar);
  return mstts::lstm_run(a, 1, b0, rows, static_cast<cudaStream_t>(stream));
}

// The layout a launch takes on this card (lstm_layout): out = U, nblk, wide,
// ntr, bytes, fits; for ops/lstm_kernel.fwd_layout's card test.
MSTTS_EXPORT int mstts_lstm_fwd_layout(int ndir, int D, int H, int B, int rows, void* out) {
  return mstts::lstm_layout_of(ndir, D, H, B, rows, static_cast<int*>(out));
}
