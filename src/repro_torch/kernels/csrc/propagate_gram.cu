// propagate_gram: the dSSFN layer step for M workers sharing one weight,
//
//     Y'_m = relu(W @ Y_m)              in W's type (f32 or bf16)
//     G_m  = Y'_m Y'_m^T + I/mu         in f32, from the f32 Y'_m
//
// for Hopper (sm_90a).  W is (n, n_prev), Y is (M, n_prev, J), both
// row-major and of one type.
//
// Replaces the Pallas TPU kernel src/repro/kernels/propagate_gram/
// kernel.py (propagate_gram_pallas, body _propagate_gram_kernel).  That
// kernel keeps W and the whole (n, n) f32 accumulator in VMEM and makes
// one pass over J tiles.  At n = 1020 the accumulator alone is 4 MB and
// with W 8 MB, far above the 227 KB of shared memory an H100 block can
// use, so this port does not carry it over block by block.  The op is two
// passes launched back to back on one stream:
//   1. propagate_kernel: a masked tiled relu(W @ Y_m) for all workers
//      (grid J tiles x n tiles x M) that writes Y' and, for bf16, an f32
//      copy of Y' before rounding;
//   2. the Gram (gram.cuh) of the f32 Y'.
// For bf16 the Gram must see the f32 values before rounding, as the TPU
// kernel's does (its accumulator takes the f32 dot product).  This port
// keeps an f32 scratch copy of Y' (allocated by the wrapper) rather than
// fusing the Gram into the propagation per J tile: the fused form would
// need the (n, n) accumulator across J tiles, which is what does not fit,
// and the copy costs one more write and read of 4 n J M bytes, small
// against the operation bound below.
//
// What bounds it on an H100 SXM: arithmetic.  At the Table-I MNIST layer
// (M=20, n = n_prev = 1020, J_m = 3000) it is 2 n n_prev J M + n (n+1) J M
// = 1.87e11 operations: 2.8 ms at the CUDA cores' 67 TFLOP/s, and, as
// both passes compute them on the tensor cores with three TF32 products
// each, 3 x 1.87e11 at 495 TFLOP/s = 1.13 ms; its bytes (W, Y, Y', G,
// about 0.58 GB) bound it at 0.17 ms, and the round trip of Y' through
// HBM between the passes (about 0.49 GB) at about 0.15 ms more.
//
// The propagation is the Gram's block product (gram.cuh: the hi/lo split,
// mma.sync m16n8k8 tf32, kFold-deep chunks folded with Kahan
// compensation) with B = Y_m, whose rows
// run along J: its tiles are kept [k][j] in shared memory, rows padded to
// 68 words so that a warp's B fragment reads (rows 2t and 2t + 1, columns
// g) hit 32 banks, and read with 32-bit loads (ldmatrix.trans moves
// 16-bit elements only).  bf16 operands take one product each, as they
// are exact in TF32.  At (n, n_prev, M, J) = (1020, 1020, 1, 60000) on
// seeded ReLU features, Y' is held within 8 f32 ulps of max|Y'| of a
// float64 forward (tests/test_torch_cuda.py).
//
// Determinism: each Y' element is summed in one thread in order over k,
// and each G element as gram.cuh says, so both outputs are bit-identical
// from run to run and do not depend on a worker's position in the batch.
// relu writes -0 as +0 and keeps NaN (not fmaxf, which turns NaN into 0),
// as torch.relu does; a NaN or inf in W or Y makes every Y' it enters NaN
// (gram.cuh, non-finite values).
//
// Edges: every load and store is masked on n, n_prev and J.

#include <type_traits>

#include "gram.cuh"

namespace dssfn {

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as the plain version
}

template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
propagate_kernel(const T* __restrict__ w, const T* __restrict__ y, T* __restrict__ out,
                 float* __restrict__ out32, int n, int n_prev, int J) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t worker = blockIdx.z;
  const T* ym = y + worker * (size_t)n_prev * (size_t)J;
  const size_t out_ofs = worker * (size_t)n * (size_t)J;
  const int row0 = blockIdx.y * kBM, col0 = blockIdx.x * kBM;

  WarpTile total, comp;
  block_product<T, true, kVec>(reinterpret_cast<T*>(smem_raw), w, n, row0, ym, J, col0,
                               n_prev, 0, n_prev, total, comp);

  const Lane ln;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = row0 + ln.row(mi, q), c = col0 + ln.col(ni, q);
        const float sum = total[mi][ni][q] - comp[mi][ni][q];
        const float v = sum <= 0.0f ? 0.0f : sum;
        if (r < n && c < J) {
          const size_t at = out_ofs + (size_t)r * J + c;
          store_from_f32(out + at, v);
          if (out32 != nullptr) out32[at] = v;
        }
      }
    }
  }
}

template <typename T, int kVec>
int launch_propagate(const T* w, const T* y, T* y_out, float* copy32, int m, int n, int n_prev,
                     int J, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T, true>();
  const cudaError_t attr = cudaFuncSetAttribute(
      propagate_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((J + kBM - 1) / kBM, (n + kBM - 1) / kBM, m);
  propagate_kernel<T, kVec><<<grid, kThreads, kSmem, stream>>>(w, y, y_out, copy32, n, n_prev, J);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_propagate_gram(const T* w, const T* y, T* y_out, float* y32, float* g, float* ws,
                          int m, int n, int n_prev, int J, float inv_mu, cudaStream_t stream) {
  // f32: Y' is itself the Gram pass's input, and no second copy is
  // stored.  bf16: the Gram pass reads the f32 copy written beside Y'.
  float* copy32 = nullptr;
  const float* gram_in;
  if constexpr (std::is_same_v<T, float>) {
    gram_in = y_out;
  } else {
    copy32 = y32;
    gram_in = y32;
  }
  constexpr int kV = 16 / sizeof(T);
  const bool vec = n_prev % kV == 0 && J % kV == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int err = vec ? launch_propagate<T, kV>(w, y, y_out, copy32, m, n, n_prev, J, stream)
                      : launch_propagate<T, 1>(w, y, y_out, copy32, m, n, n_prev, J, stream);
  if (err != 0) return err;
  return launch_gram<float>(gram_in, g, ws, m, n, J, inv_mu, stream);
}

}  // namespace dssfn

// C interface for ctypes.  w (n, n_prev), y (m, n_prev, j) and y_out
// (m, n, j) are of one type; g is (m, n, n) f32.  y32 is an f32
// (m, n, j) scratch buffer for Y' before rounding, read for bf16 only
// (f32 passes null); ws holds propagate_gram_workspace_floats(m, n, j)
// floats for the Gram pass (null when that is 0).  The launches go on
// `stream` and do not synchronise.  Returns the first failing launch's
// cudaError_t (0 on success).
extern "C" long long propagate_gram_workspace_floats(int m, int n, int j) {
  return dssfn::gram_workspace_floats(m, n, j);
}

extern "C" int propagate_gram_f32(const void* w, const void* y, void* y_out,
                                  void* y32, void* g, void* ws, int m, int n,
                                  int n_prev, int j, float inv_mu,
                                  void* stream) {
  return dssfn::launch_propagate_gram<float>(
      static_cast<const float*>(w), static_cast<const float*>(y),
      static_cast<float*>(y_out), static_cast<float*>(y32),
      static_cast<float*>(g), static_cast<float*>(ws), m, n, n_prev, j, inv_mu,
      static_cast<cudaStream_t>(stream));
}

extern "C" int propagate_gram_bf16(const void* w, const void* y, void* y_out,
                                   void* y32, void* g, void* ws, int m, int n,
                                   int n_prev, int j, float inv_mu,
                                   void* stream) {
  return dssfn::launch_propagate_gram<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(y_out), static_cast<float*>(y32),
      static_cast<float*>(g), static_cast<float*>(ws), m, n, n_prev, j, inv_mu,
      static_cast<cudaStream_t>(stream));
}
