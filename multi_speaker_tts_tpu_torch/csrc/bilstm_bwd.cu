// Text-encoder BiLSTM backward: both directions' reverse recurrences in
// one persistent cooperative launch.
//
// Replaces multi_speaker_tts_tpu/ops/birnn_pallas.py::_bilstm_vjp_bwd
// (kernel body _bilstm_bwd_kernel). From the forward's residuals (gates and
// c_{t-1} per direction, natural time; bilstm.cu's residual mode) and the
// f32 output cotangents of each direction, it emits dGf and dGb (T, B, 4H)
// bf16. As on the TPU, one step advances both directions: the forward
// direction walks time in reverse, the backward direction natural time.
// The weight and input gradients are whole-sequence GEMMs of the caller.
// Design and numerics: lstm_bwd.cuh. At the production width (H = 256 a
// direction) 64 blocks a direction keep 4 rows of W_hh each and run the
// step's product on tensor cores.
//
// What bounds it on an H100: T sequential steps, each a grid barrier and
// one pass over dG_t (64 KB at B = 32) from L2 into every SM; the bytes
// (~24 MB at T = 64, B = 32) and operations are far below it.
#include "lstm_bwd.cuh"

MSTTS_EXPORT int mstts_bilstm_bwd(const void* gf, const void* cf, const void* gb,
                                  const void* cb, const void* whf, const void* whb,
                                  const void* dyf, const void* dyb, void* dGf, void* dGb,
                                  void* bar, int T, int B, int H, int b0, int rows, void* stream) {
  mstts::LstmBwdArgs a = {};
  a.T = T;
  a.Bs = B;
  a.H = H;
  a.gates[0] = static_cast<const __nv_bfloat16*>(gf);
  a.gates[1] = static_cast<const __nv_bfloat16*>(gb);
  a.c_prev[0] = static_cast<const __nv_bfloat16*>(cf);
  a.c_prev[1] = static_cast<const __nv_bfloat16*>(cb);
  a.w[0] = static_cast<const __nv_bfloat16*>(whf);
  a.w[1] = static_cast<const __nv_bfloat16*>(whb);
  a.d_ys[0] = static_cast<const float*>(dyf);
  a.d_ys[1] = static_cast<const float*>(dyb);
  a.dG[0] = static_cast<__nv_bfloat16*>(dGf);
  a.dG[1] = static_cast<__nv_bfloat16*>(dGb);
  a.bar = static_cast<unsigned int*>(bar);
  return mstts::lstm_bwd_run(a, 2, b0, rows, static_cast<cudaStream_t>(stream));
}
