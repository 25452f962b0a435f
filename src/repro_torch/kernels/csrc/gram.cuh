// Shared tiles of the Gram kernels: the batched regularized Gram product
// G_m = Y_m Y_m^T + I/mu, included by gram.cu and by propagate_gram.cu
// (whose second pass it is).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram/kernel.py
// (gram_pallas, body _gram_kernel): Y_m (n, J) row-major, f32 or bf16,
// gives G_m (n, n) in f32, with 1/mu added on the diagonal in the
// epilogue, as the TPU kernel does on its last reduction step.  The TPU
// kernel is called once per worker under vmap; here all M workers go in
// one launch, grid (upper-triangle tile pairs, M).
//
// What bounds it on an H100 SXM: f32 arithmetic on the CUDA cores.  A
// symmetric Gram is n(n+1) J operations per worker; layer 0 of the
// Table-I MNIST train (M=20, n=784, J_m=3000) is 3.7e10 operations,
// about 0.55 ms at 67 TFLOP/s, against 0.19 GB of Y and 49 MB of G
// (about 0.07 ms at 3.35 TB/s).
// What this design does about it: only the tiles on and above the
// diagonal are computed (half the products); a plain tiled SIMT GEMM,
// right first and fast later.  Row tiles of Y over J go through shared
// memory j-major, each thread keeps a TM x TM micro-tile of sums in
// registers (rows ty + 16 i, columns tx + 16 j, so the shared-memory
// reads of a warp fall on distinct banks or broadcast), and the next J
// tile is loaded into registers while the current one is summed.  Tensor
// cores are not used: TF32 inputs would not keep the f32 parity with the
// plain version; wgmma and TMA come in later work.
//
// Summation: each output is summed in one thread, in order over j, as
// kBK-term f32 fmaf chains from +0 (one per J tile), whose partial sums
// are added to the running total in order with Kahan compensation.  A
// single chain over all of j = 0..J-1 (the first version) sums thousands
// of non-negative products (ReLU features) into an ever larger total,
// and its rounding error grows with sqrt(J): at the Table-I layer 1
// (M = 20, J_m = 3000) chip_smoke.py found the card's ADMM readout 2.0e-4
// from the CPU's, whose BLAS sums in blocks, against a bar of 1e-4.  The
// compensated blocks cost four adds per output per kBK FMAs.
//
// Determinism and symmetry: the order of every operation is fixed by j
// and kBK alone, whatever the tile side, the worker's position in the
// batch or M.  There is no split-J and no atomic, so G is bit-identical
// from run to run and a worker's G does not depend on the batch it is
// computed in.  fmaf(a, b, c) rounds the exact product a*b, which does
// not depend on the order of a and b, so the sums for (i, k) and (k, i)
// are equal bit for bit; an off-diagonal tile is written to (i, k) and,
// through shared memory so that the stores stay coalesced, to (k, i): G
// is exactly symmetric.  The zero-filled tail of the last J tile adds
// fmaf(0, 0, s) = s to its chain (s is never -0: a chain starts at +0
// and an exact cancellation rounds to +0).
//
// Edges: every load and store is masked on n and J, so any shape runs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace dssfn {

constexpr int kThreads = 256;  // 16 x 16 threads per tile
constexpr int kSide = 16;      // threads along each side of a tile
constexpr int kBK = 32;        // reduction tile depth: the length of a chain

// Kahan step: total += part, with the low-order bits the add loses kept
// in comp (total - comp is the compensated sum).  No multiply, so the
// compiler's FMA contraction cannot fold it; nvcc keeps IEEE adds
// without --use_fast_math.
__device__ __forceinline__ void kahan_add(float& total, float& comp, float part) {
  const float y = part - comp;
  const float t = total + y;
  comp = (t - total) - y;
  total = t;
}

// Zeroes a TM x TM register tile.
template <int TM>
__device__ __forceinline__ void zero(float (&r)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) r[i][j] = 0.0f;
  }
}

// Adds a finished chain tile into the compensated running totals.
template <int TM>
__device__ __forceinline__ void fold(float (&total)[TM][TM], float (&comp)[TM][TM],
                                     const float (&part)[TM][TM]) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TM; ++j) kahan_add(total[i][j], comp[i][j], part[i][j]);
  }
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as the plain version
}

// This thread's share of the BM x BK tile at (row0, col0) of the
// row-major (rows, cols) matrix src, widened to f32; zeros past every
// edge.  Neighbouring threads read neighbouring columns of one row.
template <typename T, int BM, int BK>
__device__ __forceinline__ void fetch_row_tile(
    const T* __restrict__ src, float (&r)[BM * BK / kThreads],
    int row0, int col0, int rows, int cols, int tid) {
#pragma unroll
  for (int t = 0; t < BM * BK / kThreads; ++t) {
    const int e = tid + t * kThreads;
    const int rr = row0 + e / BK, c = col0 + e % BK;
    r[t] = (rr < rows && c < cols) ? widen(src[(size_t)rr * cols + c]) : 0.0f;
  }
}

// Stores a tile fetched by fetch_row_tile transposed, column-major:
// dst[kk][i] = tile[i][kk].  The +1 row padding keeps the transposing
// stores free of bank conflicts.
template <int BM, int BK>
__device__ __forceinline__ void stash_transposed(
    float (*dst)[BM + 1], const float (&r)[BM * BK / kThreads], int tid) {
#pragma unroll
  for (int t = 0; t < BM * BK / kThreads; ++t) {
    const int e = tid + t * kThreads;
    dst[e % BK][e / BK] = r[t];
  }
}

// Tile pair p of the upper triangle (ti <= tk) of a tiles x tiles grid,
// numbered row by row.
__device__ __forceinline__ void upper_pair(int p, int tiles, int& ti, int& tk) {
  ti = 0;
  while (p >= tiles - ti) {
    p -= tiles - ti;
    ++ti;
  }
  tk = ti + p;
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads, 2)
gram_kernel(const T* __restrict__ y, float* __restrict__ g, int n, int J,
            float inv_mu, int tiles) {
  constexpr int BK = kBK;
  constexpr int TM = BM / kSide;
  constexpr int kLoads = BM * BK / kThreads;
  static_assert(BM % kSide == 0 && (BM * BK) % kThreads == 0,
                "tile loads must split evenly over the threads");
  __shared__ float ya[BK][BM + 1];  // rows of the i tile, j-major
  __shared__ float yb[BK][BM + 1];  // rows of the k tile, j-major
  __shared__ float out[BM][BM + 1];  // the finished tile, for the mirror

  int ti, tk;
  upper_pair(blockIdx.x, tiles, ti, tk);
  const T* yw = y + (size_t)blockIdx.y * (size_t)n * (size_t)J;
  float* gw = g + (size_t)blockIdx.y * (size_t)n * (size_t)n;
  const int row0 = ti * BM, col0 = tk * BM;
  const int tid = threadIdx.x;
  const int tx = tid % kSide, ty = tid / kSide;

  float total[TM][TM], comp[TM][TM], part[TM][TM];
  zero(total);
  zero(comp);

  float ra[kLoads], rb[kLoads];
  fetch_row_tile<T, BM, BK>(yw, ra, row0, 0, n, J, tid);
  fetch_row_tile<T, BM, BK>(yw, rb, col0, 0, n, J, tid);
  for (int j0 = 0; j0 < J; j0 += BK) {
    stash_transposed<BM, BK>(ya, ra, tid);
    stash_transposed<BM, BK>(yb, rb, tid);
    __syncthreads();
    if (j0 + BK < J) {
      fetch_row_tile<T, BM, BK>(yw, ra, row0, j0 + BK, n, J, tid);
      fetch_row_tile<T, BM, BK>(yw, rb, col0, j0 + BK, n, J, tid);
    }
    zero(part);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = ya[kk][ty + kSide * i];
#pragma unroll
      for (int j = 0; j < TM; ++j) b[j] = yb[kk][tx + kSide * j];
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
    const int lr = ty + kSide * i, r = row0 + lr;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      const int lc = tx + kSide * j, c = col0 + lc;
      float v = total[i][j] - comp[i][j];
      if (r == c) v += inv_mu;
      if (r < n && c < n) gw[(size_t)r * n + c] = v;
      out[lr][lc] = v;
    }
  }
  if (ti == tk) return;  // a diagonal tile holds its own mirror image
  __syncthreads();
  // Mirror: G[col0 + lc][row0 + lr] = out[lr][lc]; neighbouring threads
  // write neighbouring columns row0 + lr of one row of G.
#pragma unroll
  for (int t = 0; t < BM * BM / kThreads; ++t) {
    const int e = tid + t * kThreads;
    const int lr = e % BM, lc = e / BM;
    const int r = col0 + lc, c = row0 + lr;
    if (r < n && c < n) gw[(size_t)r * n + c] = out[lr][lc];
  }
}

// G_m = Y_m Y_m^T + I/mu for m < M, on `stream`; returns the launch's
// cudaError_t.  The tile side only changes how the work is spread (the
// bits are the same): 64 where that gives two waves of blocks on the
// card's 132 SMs, else 32.
template <typename T>
int launch_gram(const T* y, float* g, int m, int n, int J, float inv_mu,
                cudaStream_t stream) {
  const int tiles64 = (n + 63) / 64;
  const long long pairs64 = (long long)tiles64 * (tiles64 + 1) / 2;
  if (pairs64 * m >= 2 * 132) {
    gram_kernel<T, 64><<<dim3((unsigned)pairs64, m), kThreads, 0, stream>>>(
        y, g, n, J, inv_mu, tiles64);
  } else {
    const int tiles32 = (n + 31) / 32;
    const long long pairs32 = (long long)tiles32 * (tiles32 + 1) / 2;
    gram_kernel<T, 32><<<dim3((unsigned)pairs32, m), kThreads, 0, stream>>>(
        y, g, n, J, inv_mu, tiles32);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dssfn
