// Text-encoder BiLSTM recurrence: both directions in one persistent launch.
//
// Replaces multi_speaker_tts_tpu/ops/birnn_pallas.py::_bilstm_fwd_impl
// (kernel body _bilstm_fwd_kernel, reached through bilstm_pallas). As on
// the TPU, the input projections x . W_ih + b of both directions are
// hoisted out as two large matmuls by the caller; the kernel runs only the
// recurrence: step s advances the forward direction at natural time s and
// the backward direction at T-1-s, both stored in natural time. The blocks
// of each direction keep their slice of W_hh (64 blocks of 4 units a
// direction at production width, H = 256) resident in shared memory, and
// each step's h_{t-1} . W_hh runs on tensor cores (lstm_persistent.cuh).
//
// What bounds it on an H100: S sequential steps, each a grid barrier and
// one L2 round trip of h_{t-1} (16 KB at B = 32); bytes (~1 MB of weights
// plus the gates) and operations are tiny. The design loads the next
// step's hoisted gates and stores the residuals between the barrier's
// arrival and its wait.
//
// Past H 1088 a direction on an H100 the launch takes the wide layout of
// lstm_persistent.cuh (the W_hh tiles that do not fit stream from L2 each
// step). One call launches once, over rows b0 .. b0 + rows of the batch.
//
// gf / cf / gb / cb non-null selects the residual mode of
// _bilstm_fwd_impl(save_residuals=True): per direction the pre-activation
// gates (T, B, 4H) and c_{t-1} (T, B, H), bf16, in natural time, for the
// reverse kernel (bilstm_bwd.cu).
#include "lstm_persistent.cuh"

MSTTS_EXPORT int mstts_bilstm_fwd(const void* gxf, const void* gxb, const void* whf,
                                  const void* whb, void* ysf, void* ysb, void* gf, void* cf,
                                  void* gb, void* cb, void* bar, int T, int B, int H,
                                  int b0, int rows, void* stream) {
  mstts::LstmArgs a = {};
  a.T = T;
  a.B = B;
  a.Bs = B;
  a.D = 0;
  a.H = H;
  a.gx[0] = static_cast<const __nv_bfloat16*>(gxf);
  a.gx[1] = static_cast<const __nv_bfloat16*>(gxb);
  a.w[0] = static_cast<const __nv_bfloat16*>(whf);
  a.w[1] = static_cast<const __nv_bfloat16*>(whb);
  a.ys[0] = static_cast<__nv_bfloat16*>(ysf);
  a.ys[1] = static_cast<__nv_bfloat16*>(ysb);
  a.g_res[0] = static_cast<__nv_bfloat16*>(gf);
  a.c_res[0] = static_cast<__nv_bfloat16*>(cf);
  a.g_res[1] = static_cast<__nv_bfloat16*>(gb);
  a.c_res[1] = static_cast<__nv_bfloat16*>(cb);
  const bool any = gf || cf || gb || cb, all = gf && cf && gb && cb;
  if (any && !all) return (int)cudaErrorInvalidValue;
  a.bar = static_cast<unsigned int*>(bar);
  return mstts::lstm_run(a, 2, b0, rows, static_cast<cudaStream_t>(stream));
}
