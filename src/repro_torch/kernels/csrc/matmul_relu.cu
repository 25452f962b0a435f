// matmul_relu: out = relu(W @ X), the SSFN layer step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul_relu/kernel.py
// (matmul_relu_pallas, body _matmul_relu_kernel): W (m, k) and X (k, n),
// both row-major and of one type (f32 or bf16), give (m, n) in that type.
// Sums are kept in f32 and the ReLU and the cast are applied once, on
// the finished sum, as the TPU kernel does on its last K step.
//
// What bounds it on an H100 SXM at the serving shapes (W 1020x1020):
//  - bucket 128: f32 arithmetic on the CUDA cores.  2*1020*1020*128 =
//    266 MFLOP per layer, about 4.0 us at 67 TFLOP/s.
//  - bucket 1: HBM.  W is 4.2 MB per layer, about 1.2 us at 3.35 TB/s,
//    and the 20 layers' 83 MB of W do not stay in the 50 MB L2 between
//    forwards.
// What this design does about it: it is a plain tiled SIMT GEMM, right
// first and fast later.  Tiles of W and X over K go through shared
// memory, each thread keeps a TM x TN micro-tile of sums in registers,
// bf16 is widened to f32 on load, and the ReLU and the cast sit in the
// epilogue.  The next K tiles are loaded into registers while the
// current ones are summed.  Narrow batches take 8-row tiles so that
// bucket 1 still spreads W's rows over 128 blocks.  It reaches neither
// bound: each sum is one dependent chain of k FMAs (at least 4 cycles
// each), and wgmma, TMA and a deeper pipeline come in later work.
//
// Edges: every load and store is masked on m, n and k, so any shape
// runs (the paper's widths, n = 2Q + 1000, are not tile multiples).
//
// Padding invariance: each output element is ONE f32 fmaf chain over
// k = 0, 1, ..., k-1 in order, in one thread, whatever the tile shape,
// the column's position or n.  The chain then takes fmaf(0, 0, sum) for
// the zero-filled tail of the last K tile; that leaves every sum but -0
// unchanged, and the epilogue writes -0 as +0, so the tail's length
// (which depends on BK) never shows in the output.  There is no split-K
// and no atomic, so a column's result does not depend on which bucket or
// batch it lands in, and padded, bucketed and micro-batched forwards
// agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as the plain version
}

// Loads this thread's share of the W (BM x BK) and X (BK x BN) tiles at
// k0 into registers, widened to f32; zeros past every edge.
template <typename T, int BM, int BN, int BK, int kThreads>
__device__ __forceinline__ void fetch_tiles(
    const T* __restrict__ w, const T* __restrict__ x,
    float (&wr)[BM * BK / kThreads], float (&xr)[BK * BN / kThreads],
    int row0, int col0, int k0, int m, int n, int k, int tid) {
  // Neighbouring threads read neighbouring k of one W row.
#pragma unroll
  for (int t = 0; t < BM * BK / kThreads; ++t) {
    const int e = tid + t * kThreads;
    const int r = row0 + e / BK, c = k0 + e % BK;
    wr[t] = (r < m && c < k) ? load_f32(w + (size_t)r * k + c) : 0.0f;
  }
  // Neighbouring threads read neighbouring columns of one X row.
#pragma unroll
  for (int t = 0; t < BK * BN / kThreads; ++t) {
    const int e = tid + t * kThreads;
    const int r = k0 + e / BN, c = col0 + e % BN;
    xr[t] = (r < k && c < n) ? load_f32(x + (size_t)r * n + c) : 0.0f;
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
matmul_relu_kernel(const T* __restrict__ w, const T* __restrict__ x,
                   T* __restrict__ out, int m, int n, int k) {
  constexpr int kThreads = (BM / TM) * (BN / TN);
  static_assert((BM * BK) % kThreads == 0 && (BK * BN) % kThreads == 0,
                "tile loads must split evenly over the threads");
  // ws is k-major (ws[kk][i] = W[row0 + i][k0 + kk]) so that a thread's
  // TM rows at one kk sit side by side; +1 keeps the transposing stores
  // free of bank conflicts.
  __shared__ float ws[BK][BM + 1];
  __shared__ float xs[BK][BN];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;
  }

  // Register double buffer: the next tiles' loads are issued before the
  // FMAs on the current ones, so their latency hides behind the math.
  float wr[BM * BK / kThreads], xr[BK * BN / kThreads];
  fetch_tiles<T, BM, BN, BK, kThreads>(w, x, wr, xr, row0, col0, 0, m, n, k, tid);

  for (int k0 = 0; k0 < k; k0 += BK) {
#pragma unroll
    for (int t = 0; t < BM * BK / kThreads; ++t) {
      const int e = tid + t * kThreads;
      ws[e % BK][e / BK] = wr[t];
    }
#pragma unroll
    for (int t = 0; t < BK * BN / kThreads; ++t) {
      const int e = tid + t * kThreads;
      xs[e / BN][e % BN] = xr[t];
    }
    __syncthreads();
    if (k0 + BK < k) {
      fetch_tiles<T, BM, BN, BK, kThreads>(w, x, wr, xr, row0, col0, k0 + BK, m, n, k, tid);
    }
    // No branch in the unrolled loop, so the shared-memory loads run
    // ahead of the dependent FMAs.  Past the last real k the tiles hold
    // zeros, which add +0 to the finished sum (see the note on padding).
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ws[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = xs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx * TN + j;
      // Not fmaxf, which turns NaN into 0: a NaN sum stays NaN, as in
      // torch.relu.  -0 is written as +0.
      const float v = acc[i][j] <= 0.0f ? 0.0f : acc[i][j];
      if (r < m && c < n) store_from_f32(out + (size_t)r * n + c, v);
    }
  }
}

template <typename T, int BM, int BN, int BK, int TM, int TN>
void launch_tiles(const T* w, const T* x, T* out, int m, int n, int k,
                  cudaStream_t stream) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const dim3 block((BM / TM) * (BN / TN));
  matmul_relu_kernel<T, BM, BN, BK, TM, TN><<<grid, block, 0, stream>>>(w, x, out, m, n, k);
}

template <typename T>
int launch(const void* w, const void* x, void* out, int m, int n, int k, void* stream) {
  const T* wt = static_cast<const T*>(w);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Tile shape by batch width.  Narrow batches read W and little else:
  // thin row tiles put W's rows on ~128 blocks, and a deep BK keeps 16
  // independent W loads per thread in flight.  Wide batches take a 2x2
  // micro-tile per thread for more FMAs per shared-memory load.
  if (n <= 16) {
    launch_tiles<T, 8, 16, 256, 1, 1>(wt, xt, ot, m, n, k, s);
  } else if (n <= 64) {
    launch_tiles<T, 8, 32, 128, 1, 1>(wt, xt, ot, m, n, k, s);
  } else {
    launch_tiles<T, 32, 32, 64, 2, 2>(wt, xt, ot, m, n, k, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers; the launch goes
// on `stream` and does not synchronise.  Returns the cudaError_t of the
// launch (0 on success).
extern "C" int matmul_relu_f32(const void* w, const void* x, void* out,
                               int m, int n, int k, void* stream) {
  return launch<float>(w, x, out, m, n, k, stream);
}

extern "C" int matmul_relu_bf16(const void* w, const void* x, void* out,
                                int m, int n, int k, void* stream) {
  return launch<__nv_bfloat16>(w, x, out, m, n, k, stream);
}
