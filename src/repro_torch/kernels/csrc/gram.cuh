// Shared tiles of the Gram kernels: the batched regularized Gram product
// G_m = Y_m Y_m^T + I/mu, included by gram.cu and by propagate_gram.cu
// (whose second pass it is, and whose first pass uses the same tensor-core
// block product).
//
// Replaces the Pallas TPU kernel src/repro/kernels/gram/kernel.py
// (gram_pallas, body _gram_kernel): Y_m (n, J) row-major, f32 or bf16,
// gives G_m (n, n) in f32, with 1/mu added on the diagonal in the
// epilogue, as the TPU kernel does on its last reduction step.  The TPU
// kernel is called once per worker under vmap; here all M workers go in
// one launch, grid (upper-triangle tile pairs, J slices, M).
//
// What bounds it on an H100 SXM: arithmetic.  A symmetric Gram is
// n(n+1) J operations per worker; layer 0 of the Table-I MNIST train
// (M=20, n=784, J_m=3000) is 3.7e10 operations.  On the CUDA cores
// (67 TFLOP/s f32) that is 0.55 ms; this kernel computes on the tensor
// cores in TF32 with three products per f32 product (below), so its bound
// is 3 x 3.7e10 operations at 495 TFLOP/s, 0.22 ms, against 0.19 GB of Y
// and 49 MB of G (0.07 ms at 3.35 TB/s).
//
// The split (3xTF32).  A TF32 operand keeps 11 significant bits, too few
// for the f32 parity with the plain version.  Each f32 operand x is split
// as hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest with
// ties away from zero as cvt.rna.tf32.f32 rounds (tc::tf32_rna, in two
// integer operations); the subtraction is exact, so x = hi + lo to
// 2^-22 |x|.  Each product is summed as lo_a hi_b + hi_a lo_b + hi_a hi_b
// with mma.sync m16n8k8 tf32 (f32 accumulators); the dropped lo_a lo_b is
// below 2^-22 |a b|.  The two small products go first, while the chunk's
// accumulator is still small.  bf16 operands are exact in TF32 (8
// significant bits) and their products exact in f32, so a bf16 Gram takes
// one product per pair.
//
// Summation.  The tensor cores' f32 accumulation does not round to
// nearest (published measurements on V100 and A100 show it truncates),
// so a long chain kept in an mma accumulator drifts one way by up to an
// ulp of the running sum per mma; the error measured below grows with
// the chain's depth, as such drift does.  The sum
// over j is therefore cut into chunks of kFold samples, each summed on
// the tensor cores from a zero accumulator; the chunks' sums are added
// in f32 (rounded to nearest, so without drift) into `mid`, and `mid`
// into per-thread (total, comp) registers with Kahan compensation every
// kKahan samples.  The chunk depth trades accuracy for time; deeper
// chunks (16, 32) were tried while the kernel was written and their
// error grew with the depth, by a few percent less time, so kFold = 8 is
// kept, with the most headroom under the bar of 8 f32 ulps of max|G| from
// a float64 Gram: on an H100 80GB HBM3 (700 W), chip_smoke.py measured
// 2.82 ulps at y(20, 784, 3000) and 2.23 at y(1, 784, 60000), and
// tests/test_torch_cuda.py holds gram at J = 60000 and propagate_gram's
// Y' and G at (1020, 1020, 1, 60000) to the bar.
//
// Non-finite values: every entry of G that a NaN or inf operand enters
// is NaN.  For f32, split_tf32 makes its lo NaN; a bf16 one is its own
// hi, and an inf sum becomes NaN in the Kahan step (comp = (inf - total)
// - inf).  So a NaN stays NaN, as in the plain version, and an inf, which
// the plain version may leave inf, gives NaN.
//
// Tiles.  64 x 64 output tiles, 4 warps of 32 x 32, two blocks to an SM;
// row tiles of Y over 32 samples come in by cp.async (16-byte copies
// where every row is 16-byte aligned, else one element each) through a
// ring of 3 stages, in shared rows padded so that a warp's fragment reads
// hit 32 banks.  Only tiles on and above the diagonal are computed.  The
// loop is bound by the rate its instructions are dispatched at: the split
// costs more instructions than the three mma.sync it feeds.
//
// Slices.  M=1, n=784 gives only 91 tiles, too few to fill 132 SMs.  Where
// J > kSlice, J is cut into slices of kSlice samples (a constant, so the
// cut depends on J alone), each block writes its slice's (total, comp)
// tile to a workspace, and a second kernel adds the slices' partials in
// slice order with Kahan compensation.
//
// Determinism and symmetry: the order of every operation is fixed by j,
// kFold, kKahan and kSlice alone, whatever M or the worker's position in
// the batch; there is no atomic, so G is bit-identical from run to run
// and a worker's G does not depend on the batch it is computed in.  The
// split makes G[i][k] and G[k][i] sum hi_i lo_k and lo_i hi_k in opposite
// roles, so they may differ in the last bit: an off-diagonal tile is
// written to (i, k) and, through shared memory so that the stores stay
// coalesced, to (k, i), and a diagonal tile's strict lower half is
// written from its upper half.  G is exactly symmetric.
//
// Edges: every load and store is masked on n and J (zeros past the
// edges add exact zeros), so any shape runs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tensor_core.cuh"

namespace dssfn {

constexpr int kWarps = 4;               // 2 x 2 warps of 32 x 32 outputs
constexpr int kThreads = 32 * kWarps;
constexpr int kBM = 64;                 // output tile side
constexpr int kBK = 32;                 // reduction depth of one pipeline stage
constexpr int kStages = 3;              // the cp.async ring
constexpr int kMinBlocks = 2;           // blocks an SM must hold (__launch_bounds__)
constexpr int kFold = 8;                // reduction depth of one tensor-core chunk
constexpr int kKahan = 128;             // reduction depth between Kahan steps
constexpr int kSlice = 4096;            // samples of one J slice, where J > kSlice
static_assert(kBK % kFold == 0 && kFold % 8 == 0 && kKahan % kBK == 0 && kSlice % kKahan == 0,
              "chunks, Kahan steps and slices must not cross pipeline stages");

// Shared-memory row strides, in elements, so that a warp's fragment
// reads are free of bank conflicts.  K-major tiles [kBM][kBK + 8]: a
// thread reads two neighbouring samples of a row at once (64 bits for
// f32, 32 for bf16); rows g then start 8 g (f32) or 20 g (bf16) words
// apart.  N-major tiles [kBK][kBM + 4] f32 or [kBK][kBM + 8] bf16: rows 2t
// and 2t + 1 start 8 t and 8 t + 4 words apart (mod 32), columns g within.
// Every stride is a multiple of 16 bytes, as cp.async needs.
template <typename T>
__host__ __device__ constexpr int k_major_stride() {
  return kBK + 8;
}
template <typename T>
__host__ __device__ constexpr int n_major_stride() {
  return sizeof(T) == 4 ? kBM + 4 : kBM + 8;
}

// The tf32 halves of an operand: hi and lo for f32; a bf16 is exact in
// tf32, so hi alone (lo is never read).
__device__ __forceinline__ void halves(float v, uint32_t& hi, uint32_t& lo) {
  tc::split_tf32(v, hi, lo);
}
__device__ __forceinline__ void halves(__nv_bfloat16 v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(__bfloat162float(v));
  lo = 0;
}

// The halves of two neighbouring elements p[0] and p[1], read at once.
__device__ __forceinline__ void halves2(const float* p, uint32_t& h0, uint32_t& l0, uint32_t& h1,
                                        uint32_t& l1) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  halves(v.x, h0, l0);
  halves(v.y, h1, l1);
}
__device__ __forceinline__ void halves2(const __nv_bfloat16* p, uint32_t& h0, uint32_t& l0,
                                        uint32_t& h1, uint32_t& l1) {
  const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
  halves(v.x, h0, l0);
  halves(v.y, h1, l1);
}

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

// A warp's 32 x 32 outputs in mma C layout: 2 m-tiles of 16 rows by 4
// n-tiles of 8 columns, 4 values each.
using WarpTile = float[2][4][4];

// This thread's place in the block's tile: its warp's first row and
// column (2 x 2 warps of 32 x 32) and its mma fragment row g and column
// pair t.
struct Lane {
  int wr, wc, g, t;
  __device__ Lane()
      : wr(threadIdx.x / 64 * 32), wc(threadIdx.x / 32 % 2 * 32), g(threadIdx.x % 32 / 4),
        t(threadIdx.x % 4) {}
  // The tile row and column of value q of mma tile (mi, ni).
  __device__ int row(int mi, int q) const { return wr + 16 * mi + g + 8 * (q / 2); }
  __device__ int col(int ni, int q) const { return wc + 8 * ni + 2 * t + q % 2; }
};

__device__ __forceinline__ void zero(WarpTile& r) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) r[mi][ni][q] = 0.0f;
    }
  }
}

// mid += acc, rounded to nearest: a finished chunk's sum.
__device__ __forceinline__ void add_chunk(WarpTile& mid, const WarpTile& acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) mid[mi][ni][q] += acc[mi][ni][q];
    }
  }
}

// Adds mid into the compensated (total, comp) and clears it.
__device__ __forceinline__ void fold(WarpTile& total, WarpTile& comp, WarpTile& mid) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        kahan_add(total[mi][ni][q], comp[mi][ni][q], mid[mi][ni][q]);
        mid[mi][ni][q] = 0.0f;
      }
    }
  }
}

// Copies the ROWS x COLS tile at (r0, c0) of the row-major matrix src
// (row stride ld, rows_lim x cols_lim valid) into shared memory dst (row
// stride ds), zeros past every edge, kVec elements per copy: 16 bytes
// where every row starts 16-byte aligned and cols_lim % kVec == 0, else
// one element (cp.async for f32, a plain copy for bf16).
template <typename T, int ROWS, int COLS, int kVec>
__device__ __forceinline__ void load_tile(T* dst, int ds, const T* __restrict__ src, size_t ld,
                                          int r0, int c0, int rows_lim, int cols_lim, int tid) {
  constexpr int kPerRow = COLS / kVec;
  constexpr int kCopies = ROWS * kPerRow;
  static_assert(COLS % kVec == 0 && kCopies % kThreads == 0, "copies must split evenly");
#pragma unroll
  for (int i = 0; i < kCopies / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / kPerRow, c = (e % kPerRow) * kVec;
    const int gr = r0 + r, gc = c0 + c;
    const bool valid = gr < rows_lim && gc < cols_lim;
    const T* p = valid ? src + (size_t)gr * ld + gc : src;
    T* q = dst + r * ds + c;
    if constexpr (kVec * sizeof(T) == 16) {
      tc::cp_async16(tc::smem_addr(q), p, valid);
    } else if constexpr (sizeof(T) == 4) {
      tc::cp_async4(tc::smem_addr(q), p, valid);
    } else {
      *q = valid ? *p : __float2bfloat16(0.0f);
    }
  }
}

// One k8 step of the warp's 32 x 32 product: A(r, k) from the K-major
// tile sa ([row][k]); B(k, c) from sb, K-major ([c][k], the Gram) or
// N-major ([k][c], kBNMajor, the propagation).  Rows wr.., columns wc..
// The mma's k-slot t takes sample kk + 2t and slot t + 4 sample kk + 2t
// + 1, in A and B alike (the product is the same), so a thread's two
// samples sit side by side in a K-major row and come in one load.
template <typename T, bool kBNMajor>
__device__ __forceinline__ void mma_step(WarpTile& acc, bool first, const T* sa, const T* sb,
                                         int kk, const Lane& ln) {
  const int wr = ln.wr, wc = ln.wc, g = ln.g, t = ln.t;
  constexpr int SA = k_major_stride<T>();
  constexpr int SB = kBNMajor ? n_major_stride<T>() : k_major_stride<T>();
  uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const T* p = sa + (wr + 16 * mi + g) * SA + kk + 2 * t;
    halves2(p, ah[mi][0], al[mi][0], ah[mi][2], al[mi][2]);
    halves2(p + 8 * SA, ah[mi][1], al[mi][1], ah[mi][3], al[mi][3]);
  }
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int c = wc + 8 * ni + g;
    if constexpr (kBNMajor) {
      const T* p = sb + (kk + 2 * t) * SB + c;
      halves(p[0], bh[ni][0], bl[ni][0]);
      halves(p[SB], bh[ni][1], bl[ni][1]);
    } else {
      halves2(sb + c * SB + kk + 2 * t, bh[ni][0], bl[ni][0], bh[ni][1], bl[ni][1]);
    }
  }
  // The first product of a chunk starts from zero (no clearing moves).
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (first) {
          tc::mma_tf32_zero(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
        } else {
          tc::mma_tf32(acc[mi][ni], al[mi], bh[ni][0], bh[ni][1]);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) tc::mma_tf32(acc[mi][ni], ah[mi], bl[ni][0], bl[ni][1]);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) tc::mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
    }
  } else {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        if (first) {
          tc::mma_tf32_zero(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
        } else {
          tc::mma_tf32(acc[mi][ni], ah[mi], bh[ni][0], bh[ni][1]);
        }
      }
    }
  }
}

// Elements of one pipeline stage: the A tile, then the B tile.
template <typename T, bool kBNMajor>
__host__ __device__ constexpr int stage_elems() {
  return kBM * k_major_stride<T>() +
         (kBNMajor ? kBK * n_major_stride<T>() : kBM * k_major_stride<T>());
}

template <typename T, bool kBNMajor>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_elems<T, kBNMajor>() * (int)sizeof(T);
}

// The block's 64 x 64 sums over k in [k0, k1) of A(row0 + r, k) B(k,
// col0 + c), into each warp's compensated (total, comp).  A is row-major
// (a_rows, K); B is row-major (b_lim, K) (the Gram: B(k, c) = Y[c][k])
// or, kBNMajor, (K, b_lim) (the propagation).  k0 is a multiple of kBK.
template <typename T, bool kBNMajor, int kVec>
__device__ __forceinline__ void block_product(
    T* smem, const T* __restrict__ a, int a_rows, int row0, const T* __restrict__ b,
    int b_lim, int col0, int K, int k0, int k1, WarpTile& total, WarpTile& comp) {
  constexpr int SA = k_major_stride<T>();
  constexpr int SB = kBNMajor ? n_major_stride<T>() : k_major_stride<T>();
  constexpr int kStage = stage_elems<T, kBNMajor>();
  const int tid = threadIdx.x;
  const Lane ln;
  const int ntiles = (k1 - k0 + kBK - 1) / kBK;

  auto load = [&](int tile) {
    const int k = k0 + tile * kBK;
    T* sa = smem + (tile % kStages) * kStage;
    T* sb = sa + kBM * SA;
    load_tile<T, kBM, kBK, kVec>(sa, SA, a, K, row0, k, a_rows, K, tid);
    if constexpr (kBNMajor) {
      load_tile<T, kBK, kBM, kVec>(sb, SB, b, b_lim, k, col0, K, b_lim, tid);
    } else {
      load_tile<T, kBM, kBK, kVec>(sb, SB, b, K, col0, k, b_lim, K, tid);
    }
  };

  WarpTile acc, mid;  // the chunk's tensor-core sum; the chunks' sum since the last fold
  zero(mid);
  zero(total);
  zero(comp);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) load(s);
    tc::cp_async_commit();
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    tc::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (tile + kStages - 1 < ntiles) load(tile + kStages - 1);
    tc::cp_async_commit();
    const T* sa = smem + (tile % kStages) * kStage;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 8) {
      mma_step<T, kBNMajor>(acc, kk % kFold == 0, sa, sa + kBM * SA, kk, ln);
      if ((kk + 8) % kFold == 0) add_chunk(mid, acc);
    }
    if ((tile + 1) % (kKahan / kBK) == 0) fold(total, comp, mid);
  }
  if (ntiles % (kKahan / kBK) != 0) fold(total, comp, mid);
  tc::cp_async_wait<0>();
  __syncthreads();  // the ring's shared memory may now be reused
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

constexpr int kOutStride = kBM + 1;  // the finished tile in shared memory

// Writes the finished tile `out` (kBM x kBM f32 in shared memory) to G at
// (row0, col0), adding inv_mu on G's diagonal.  A diagonal tile (row0 ==
// col0) takes its strict lower half from its upper half; an off-diagonal
// one is also written mirrored to (col0, row0).  Neighbouring threads
// write neighbouring columns of one row of G.
__device__ __forceinline__ void store_tile(const float* out, float* __restrict__ gw, int n,
                                           int row0, int col0, float inv_mu) {
  const int tid = threadIdx.x;
  const bool diagonal = row0 == col0;
  for (int e = tid; e < kBM * kBM; e += kThreads) {
    const int lr = e / kBM, lc = e % kBM;
    const int r = row0 + lr, c = col0 + lc;
    if (r < n && c < n) {
      float v = (diagonal && lr > lc) ? out[lc * kOutStride + lr] : out[lr * kOutStride + lc];
      if (r == c) v += inv_mu;
      gw[(size_t)r * n + c] = v;
    }
  }
  if (diagonal) return;
  for (int e = tid; e < kBM * kBM; e += kThreads) {
    const int lc = e / kBM, lr = e % kBM;
    const int r = col0 + lc, c = row0 + lr;
    if (r < n && c < n) gw[(size_t)r * n + c] = out[lr * kOutStride + lc];
  }
}

// Pass 1 of the Gram: block (pair, slice, worker) sums its tile over the
// slice's samples.  With one slice it writes G; with several it writes
// the (total, comp) tile to ws[worker][slice][pair] for gram_slices_kernel.
template <typename T, int kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gram_kernel(const T* __restrict__ y, float* __restrict__ g, float* __restrict__ ws, int n,
            int J, float inv_mu, int tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  int ti, tk;
  upper_pair(blockIdx.x, tiles, ti, tk);
  const int row0 = ti * kBM, col0 = tk * kBM;
  const int slices = gridDim.y, slice = blockIdx.y;
  const size_t worker = blockIdx.z;
  const T* yw = y + worker * (size_t)n * (size_t)J;
  const int k0 = slice * kSlice;
  const int k1 = slices == 1 ? J : min(J, k0 + kSlice);

  WarpTile total, comp;
  block_product<T, false, kVec>(smem, yw, n, row0, yw, n, col0, J, k0, k1, total, comp);

  const Lane ln;
  if (slices > 1) {
    constexpr int kTile = kBM * kBM;
    float* part = ws + ((worker * slices + slice) * gridDim.x + blockIdx.x) * 2 * kTile;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = ln.row(mi, 2 * h) * kBM + ln.col(ni, 0);
          *reinterpret_cast<float2*>(part + at) =
              make_float2(total[mi][ni][2 * h], total[mi][ni][2 * h + 1]);
          *reinterpret_cast<float2*>(part + kTile + at) =
              make_float2(comp[mi][ni][2 * h], comp[mi][ni][2 * h + 1]);
        }
      }
    }
    return;
  }
  float* out = reinterpret_cast<float*>(smem_raw);
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        out[ln.row(mi, q) * kOutStride + ln.col(ni, q)] = total[mi][ni][q] - comp[mi][ni][q];
      }
    }
  }
  __syncthreads();
  store_tile(out, g + worker * (size_t)n * (size_t)n, n, row0, col0, inv_mu);
}

// Pass 2 where J was sliced: block (pair, worker) adds the slices'
// partial tiles in slice order, with Kahan compensation, and writes G.
__global__ void __launch_bounds__(kThreads)
gram_slices_kernel(const float* __restrict__ ws, float* __restrict__ g, int n, float inv_mu,
                   int tiles, int slices) {
  constexpr int kTile = kBM * kBM;
  __shared__ float out[kBM * kOutStride];
  int ti, tk;
  upper_pair(blockIdx.x, tiles, ti, tk);
  const size_t worker = blockIdx.y;
  for (int e = threadIdx.x; e < kTile; e += kThreads) {
    float total = 0.0f, comp = 0.0f;
    for (int s = 0; s < slices; ++s) {
      const float* part = ws + ((worker * slices + s) * gridDim.x + blockIdx.x) * 2 * kTile;
      kahan_add(total, comp, part[e] - part[kTile + e]);
    }
    out[(e / kBM) * kOutStride + e % kBM] = total - comp;
  }
  __syncthreads();
  store_tile(out, g + worker * (size_t)n * (size_t)n, n, ti * kBM, tk * kBM, inv_mu);
}

inline int gram_slices(int J) { return J > kSlice ? (J + kSlice - 1) / kSlice : 1; }

// Floats of workspace launch_gram needs (0 where J is not sliced).
inline long long gram_workspace_floats(int m, int n, int J) {
  const int slices = gram_slices(J);
  if (slices == 1) return 0;
  const long long tiles = (n + kBM - 1) / kBM;
  return (long long)m * slices * (tiles * (tiles + 1) / 2) * 2 * kBM * kBM;
}

template <typename T, int kVec>
int launch_gram_pass(const T* y, float* g, float* ws, int m, int n, int J, float inv_mu,
                     cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T, false>();
  static_assert(kSmem >= kBM * kOutStride * (int)sizeof(float), "the tile reuses the ring");
  const cudaError_t attr = cudaFuncSetAttribute(
      gram_kernel<T, kVec>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const int tiles = (n + kBM - 1) / kBM;
  const long long pairs = (long long)tiles * (tiles + 1) / 2;
  gram_kernel<T, kVec><<<dim3((unsigned)pairs, gram_slices(J), m), kThreads, kSmem, stream>>>(
      y, g, ws, n, J, inv_mu, tiles);
  return static_cast<int>(cudaGetLastError());
}

// G_m = Y_m Y_m^T + I/mu for m < M, on `stream`; ws holds
// gram_workspace_floats(m, n, J) floats (null when that is 0).  Returns
// the first failing launch's cudaError_t.  The copy width only changes
// how tiles reach shared memory, not the bits.
template <typename T>
int launch_gram(const T* y, float* g, float* ws, int m, int n, int J, float inv_mu,
                cudaStream_t stream) {
  constexpr int kV = 16 / sizeof(T);
  const bool vec = J % kV == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const int err = vec ? launch_gram_pass<T, kV>(y, g, ws, m, n, J, inv_mu, stream)
                      : launch_gram_pass<T, 1>(y, g, ws, m, n, J, inv_mu, stream);
  const int slices = gram_slices(J);
  if (err != 0 || slices == 1) return err;
  const int tiles = (n + kBM - 1) / kBM;
  const long long pairs = (long long)tiles * (tiles + 1) / 2;
  gram_slices_kernel<<<dim3((unsigned)pairs, m), kThreads, 0, stream>>>(ws, g, n, inv_mu,
                                                                      tiles, slices);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dssfn
