// gram: G_m = Y_m Y_m^T + I/mu for M workers at once, for Hopper
// (sm_90a).  The kernel, what it replaces, what bounds it and why its
// output is deterministic and exactly symmetric: gram.cuh.

#include "gram.cuh"

// C interface for ctypes.  y is (m, n, j) row-major, g is (m, n, n) f32;
// pointers are device pointers.  The launch goes on `stream` and does
// not synchronise.  Returns the cudaError_t of the launch (0 on success).
extern "C" int gram_f32(const void* y, void* g, int m, int n, int j,
                        float inv_mu, void* stream) {
  return dssfn::launch_gram<float>(static_cast<const float*>(y),
                                   static_cast<float*>(g), m, n, j, inv_mu,
                                   static_cast<cudaStream_t>(stream));
}

extern "C" int gram_bf16(const void* y, void* g, int m, int n, int j,
                         float inv_mu, void* stream) {
  return dssfn::launch_gram<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(y), static_cast<float*>(g), m, n, j,
      inv_mu, static_cast<cudaStream_t>(stream));
}
