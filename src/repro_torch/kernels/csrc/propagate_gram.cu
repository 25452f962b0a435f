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
// kernels launched back to back on one stream:
//   1. propagate_kernel: a masked tiled relu(W @ Y_m) for all workers
//      (grid J tiles x n tiles x M) that writes Y' and, for bf16, an f32
//      copy of Y' before rounding;
//   2. gram_kernel (gram.cuh) on the f32 Y'.
// For bf16 the Gram must see the f32 values before rounding, as the TPU
// kernel's does (its accumulator takes the f32 dot product).  This port
// keeps an f32 scratch copy of Y' (allocated by the wrapper) rather than
// fusing the Gram into the propagation per J tile: the fused form would
// need the (n, n) accumulator across J tiles, which is what does not fit,
// and the copy costs one more write and read of 4 n J M bytes, small
// against the operation bound below.
//
// What bounds it on an H100 SXM: f32 arithmetic.  At the Table-I MNIST
// layer (M=20, n = n_prev = 1020, J_m = 3000) it is 2 n n_prev J M +
// n (n+1) J M = 1.87e11 operations, about 2.8 ms at 67 TFLOP/s; its bytes
// (W, Y, Y', G, about 0.58 GB) bound it at 0.17 ms, and the round trip
// of Y' through HBM between the two passes (about 0.49 GB) at about
// 0.15 ms more.  Both passes are plain SIMT tiles, right first and fast
// later (wgmma and TMA come in later work; TF32 would break the f32
// parity with the plain version).
//
// Summation and determinism: each Y' element is summed in one thread in
// order over k, as kBK-term fmaf chains added with Kahan compensation,
// and each G element likewise over j (gram.cuh, which says why), so both
// outputs are bit-identical from run to run and do not depend on a
// worker's position in the batch.  relu writes -0 as +0
// and keeps NaN (not fmaxf, which turns NaN into 0), as torch.relu does.
//
// Edges: every load and store is masked on n, n_prev and J.

#include <type_traits>

#include "gram.cuh"

namespace dssfn {

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, 2)
propagate_kernel(const T* __restrict__ w, const T* __restrict__ y,
                 T* __restrict__ out, float* __restrict__ out32, int n,
                 int n_prev, int J) {
  constexpr int BK = kBK;
  constexpr int TM = BM / kSide;
  constexpr int kLoads = BM * BK / kThreads;
  static_assert(BM % kSide == 0 && (BM * BK) % kThreads == 0,
                "tile loads must split evenly over the threads");
  __shared__ float ws[BK][BM + 1];  // ws[kk][i] = W[row0 + i][k0 + kk]
  __shared__ float ys[BK][BM];      // ys[kk][j] = Y[k0 + kk][col0 + j]

  const size_t worker = blockIdx.z;
  const T* ym = y + worker * (size_t)n_prev * (size_t)J;
  const size_t out_ofs = worker * (size_t)n * (size_t)J;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;

  float total[TM][TM], comp[TM][TM], part[TM][TM];
  zero(total);
  zero(comp);

  // Y tile loads: neighbouring threads read neighbouring columns of one
  // Y row, zeros past every edge.
  auto fetch_y = [&](float (&r)[kLoads], int k0) {
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int e = tid + t * kThreads;
      const int rr = k0 + e / BM, c = col0 + e % BM;
      r[t] = (rr < n_prev && c < J) ? widen(ym[(size_t)rr * J + c]) : 0.0f;
    }
  };

  float wr[kLoads], yr[kLoads];
  fetch_row_tile<T, BM, BK>(w, wr, row0, 0, n, n_prev, tid);
  fetch_y(yr, 0);
  for (int k0 = 0; k0 < n_prev; k0 += BK) {
    stash_transposed<BM, BK>(ws, wr, tid);
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int e = tid + t * kThreads;
      ys[e / BM][e % BM] = yr[t];
    }
    __syncthreads();
    if (k0 + BK < n_prev) {
      fetch_row_tile<T, BM, BK>(w, wr, row0, k0 + BK, n, n_prev, tid);
      fetch_y(yr, k0 + BK);
    }
    zero(part);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ws[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) b[j] = ys[kk][tx + kSide * j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TM; ++j) part[i][j] = fmaf(a[i], b[j], part[i][j]);
      }
    }
    fold(total, comp, part);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + kSide * i;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int c = col0 + tx + kSide * j;
      const float sum = total[i][j] - comp[i][j];
      const float v = sum <= 0.0f ? 0.0f : sum;
      if (r < n && c < J) {
        const size_t at = out_ofs + (size_t)r * J + c;
        store_from_f32(out + at, v);
        if (out32 != nullptr) out32[at] = v;
      }
    }
  }
}

template <typename T>
int launch_propagate_gram(const T* w, const T* y, T* y_out, float* y32,
                          float* g, int m, int n, int n_prev, int J,
                          float inv_mu, cudaStream_t stream) {
  constexpr int BM = 64;
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
  const dim3 grid((J + BM - 1) / BM, (n + BM - 1) / BM, m);
  propagate_kernel<T, BM><<<grid, kThreads, 0, stream>>>(
      w, y, y_out, copy32, n, n_prev, J);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  return launch_gram<float>(gram_in, g, m, n, J, inv_mu, stream);
}

}  // namespace dssfn

// C interface for ctypes.  w (n, n_prev), y (m, n_prev, j) and y_out
// (m, n, j) are of one type; g is (m, n, n) f32.  y32 is an f32
// (m, n, j) scratch buffer for Y' before rounding, read for bf16 only
// (f32 passes null).  The launches go on `stream` and do not
// synchronise.  Returns the first failing launch's cudaError_t (0 on
// success).
extern "C" int propagate_gram_f32(const void* w, const void* y, void* y_out,
                                  void* y32, void* g, int m, int n,
                                  int n_prev, int j, float inv_mu,
                                  void* stream) {
  return dssfn::launch_propagate_gram<float>(
      static_cast<const float*>(w), static_cast<const float*>(y),
      static_cast<float*>(y_out), static_cast<float*>(y32),
      static_cast<float*>(g), m, n, n_prev, j, inv_mu,
      static_cast<cudaStream_t>(stream));
}

extern "C" int propagate_gram_bf16(const void* w, const void* y, void* y_out,
                                   void* y32, void* g, int m, int n,
                                   int n_prev, int j, float inv_mu,
                                   void* stream) {
  return dssfn::launch_propagate_gram<__nv_bfloat16>(
      static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(y),
      static_cast<__nv_bfloat16*>(y_out), static_cast<float*>(y32),
      static_cast<float*>(g), m, n, n_prev, j, inv_mu,
      static_cast<cudaStream_t>(stream));
}
