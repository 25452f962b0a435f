// gram: G_m = Y_m Y_m^T + I/mu for M workers at once, for Hopper
// (sm_90a).  The kernels, what they replace, what bounds them and why
// their output is deterministic and exactly symmetric: gram.cuh.

#include "gram.cuh"

// C interface for ctypes.  y is (m, n, j) row-major, g is (m, n, n) f32,
// ws holds gram_workspace_floats(m, n, j) floats (null when that is 0);
// pointers are device pointers.  The launches go on `stream` and do not
// synchronise.  Returns the first failing launch's cudaError_t (0 on
// success).
extern "C" long long gram_workspace_floats(int m, int n, int j) {
  return dssfn::gram_workspace_floats(m, n, j);
}

extern "C" int gram_f32(const void* y, void* g, void* ws, int m, int n, int j,
                        float inv_mu, void* stream) {
  return dssfn::launch_gram<float>(static_cast<const float*>(y),
                                   static_cast<float*>(g), static_cast<float*>(ws),
                                   m, n, j, inv_mu, static_cast<cudaStream_t>(stream));
}

extern "C" int gram_bf16(const void* y, void* g, void* ws, int m, int n, int j,
                         float inv_mu, void* stream) {
  return dssfn::launch_gram<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(y), static_cast<float*>(g),
      static_cast<float*>(ws), m, n, j, inv_mu, static_cast<cudaStream_t>(stream));
}
