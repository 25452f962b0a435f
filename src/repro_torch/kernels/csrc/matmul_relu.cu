// matmul_relu: out = relu(W @ X), the SSFN layer step, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul_relu/kernel.py
// (matmul_relu_pallas, body _matmul_relu_kernel): W (m, k) and X (k, n),
// both row-major and of one type (f32 or bf16), give (m, n) in that type.
// Sums are kept in f32 and the ReLU and the cast are applied once, on
// the finished sum, as the TPU kernel does on its last K step.
//
// What bounds it on an H100 SXM at the serving shapes: HBM up to bucket
// 32, f32 arithmetic at bucket 128.  W is the served layer's (1020, 1020)
// or (1020, 784), 4.2 or 3.2 MB in f32, read once a forward, and the 20
// layers' 83 MB do not stay in the 50 MB L2.  At bucket 32 the least time
// is 1.3 us (4.3 MB at 3.35 TB/s, against 1.0 us of FMAs at 67 TFLOP/s);
// at bucket 128 it is 4.0 us of FMAs.
//
// Design.  A block owns a tile of BM rows x BN columns of the output and
// all of K; its 8 warps split K.  K is cut into slices of kSlice = 128, a
// constant, so the cut depends on k alone, and the S = ceil(k / kSlice)
// slices go to R = min(S, 8) warps, warp j taking the slices
// [j S / R, (j + 1) S / R).  Each warp streams its W rows and X rows
// through a ring of its own in shared memory, stages of 32 k filled by
// cp.async (16-, 8- or 4-byte copies, as the rows' alignment allows), up
// to a whole slice in flight, and synchronises with __syncwarp alone.
// Each slice's sum starts from zero and is added, in slice order, to the
// warp's running f32 sum; at the end the warps' sums go through shared
// memory and are added in warp order.  So W is read once, by 64 to 128
// blocks at m = 1020 and n <= 32, with no scratch in device memory, no
// second launch, no atomic and no cluster (a split over thread block
// clusters, tried first, was slower at every n: 7.99 us at n = 1, 11.13
// at 32 and 27.09 at 128 against the times below).  Tiles: 8 x 8
// for n <= 8 (buckets 1 and 8), 16 x 32 up to n = 32, 32 x 32 above,
// where the FMAs bound it and a taller tile reads X fewer times.  bf16 X
// whose rows are not 4-byte aligned (odd n) is copied element by element,
// one load latency a stage.
//  - f32: lane (ly, lx) = (lane / 8, lane % 8) of a warp owns rows ly + 4 i
//    and columns lx BN / 8 + j of the tile and runs one fmaf chain per
//    output over the slice's k in order, with float4 reads of W (and of X
//    at BN = 32) from shared memory.
//  - bf16: on the tensor cores, mma.sync m16n8k16 (W by ldmatrix, X by
//    ldmatrix.trans; an 8-row tile fills half of A and leaves the rest 0),
//    products of bf16 values exact in f32, each slice's 8 k-steps summed in
//    the mma accumulator from zero.
//
// Column bits do not depend on n.  An output (r, c) is, whatever the tile
// shape or the column's position: per slice, a sum from zero over the
// slice's k in order (one fmaf chain in f32; a fixed sequence of mmas in
// bf16, whose result for (r, c) reads only W's row r and X's column c);
// per warp, its slices' sums added in order; then the R warps' sums added
// in warp order.  S and R depend on k alone, so padded, bucketed and
// micro-batched forwards agree bit for bit, and the output is
// bit-identical from launch to launch.  The zero-filled tail of the last
// K stage adds +0 (fmaf(0, 0, s) == s for every s but -0, and the epilogue
// writes -0 as +0).
//
// Measured by chip_smoke.py on an H100 80GB HBM3 at 700 W, f32, W
// (1020, 1020) cold in L2: 4.93 us at n = 1, 8.10 at 32, 12.84 at 128,
// against 6.06, 14.01 and 16.38 for torch.relu(torch.matmul(w, x)); bf16
// 5.84, 4.97 and 8.31.  At n <= 32 most of a call is the fixed cost of a
// launch and its first loads (the bound is 1.24 us at n = 1); bf16 with
// odd n pays its element-wise X copy (33.7 us at (1204, 3000) x 77,
// cuBLAS 20.1).
//
// Non-finite values: a NaN in W or X makes every sum it enters NaN, and
// the ReLU keeps it (v <= 0 is false for NaN); an inf gives what the
// plain version gives (inf, or NaN where inf - inf or 0 * inf arises).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr int kSlice = 128;      // k per slice; a constant, so the split depends on k alone
constexpr int kRanks = 8;        // warps of a block, each a range of slices
constexpr int kThreads = 32 * kRanks;
constexpr int kKT = 32;          // k per pipeline stage
constexpr size_t kRingBytes = 200 * 1024;  // the warps' rings, one block an SM
static_assert(kSlice % kKT == 0 && kKT % 16 == 0, "stages must tile a slice and mma k-steps");

// A BM x BN tile of type T.  Shared-memory row strides (elements) of a
// warp's W and X stages: f32, 36 and BN + 4 floats (float4 reads; W rows
// ly + 4 i of one i fall in distinct banks); bf16, rows of an odd number
// of 16-byte chunks, so that the 8 rows an ldmatrix reads hit 8 distinct
// bank groups (8-column X tiles are one chunk a row).  Each warp's ring
// holds as many stages as kRingBytes allows, at most a slice and a half.
template <typename T, int BM, int BN>
struct Tile {
  static constexpr bool kF32 = sizeof(T) == 4;
  static constexpr int kWS = kF32 ? kKT + 4 : kKT + 8;
  static constexpr int kXS = kF32 ? BN + 4 : (BN == 8 ? 8 : BN + 8);
  static constexpr size_t kStage = ((size_t)BM * kWS + (size_t)kKT * kXS) * sizeof(T);
  static constexpr int kFit = (int)(kRingBytes / (kRanks * kStage));
  static constexpr int kStages = kFit > 6 ? 6 : kFit;
  static_assert(kStages >= 2 && kStage % 16 == 0, "a warp's ring needs two 16-byte-aligned stages");
  static constexpr size_t kRing = (size_t)kRanks * kStages * kStage;
  static constexpr size_t kPart = (size_t)kRanks * BM * BN * 4;
  static constexpr size_t kSmem = kRing > kPart ? kRing : kPart;
  // This lane's sums: f32 [row i][column j]; bf16 [m-tile x n-tile][mma C register].
  static constexpr int kMT = BM < 16 ? 1 : BM / 16, kNT = BN / 8;
  static constexpr int kA = kF32 ? BM / 4 : kMT * kNT;
  static constexpr int kB = kF32 ? BN / 8 : 4;
};

__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool valid, int bytes) {
  if (bytes == 16) {
    tc::cp_async16(dst, src, valid);
  } else if (bytes == 8) {
    tc::cp_async8(dst, src, valid);
  } else {
    tc::cp_async4(dst, src, valid);
  }
}

// Copies of E elements (E * sizeof(T) bytes) each, by the 32 lanes of a warp.
template <typename T, int E, int ROWS, int COLS, int DS>
__device__ __forceinline__ void copy_chunks(T* dst, const T* __restrict__ src, size_t ld, int nr,
                                            int nc, int lane) {
  constexpr int kPerRow = COLS / E;
#pragma unroll
  for (int i = lane; i < ROWS * kPerRow; i += 32) {
    const int r = i / kPerRow, c = (i % kPerRow) * E;
    const bool ok = r < nr && c < nc;
    cp_async(tc::smem_addr(dst + r * DS + c), ok ? src + (size_t)r * ld + c : src, ok,
             E * (int)sizeof(T));
  }
}

// The ROWS x COLS tile at src (row stride ld) into shared memory at dst
// (row stride DS), by one warp: element (r, c) where r < nr and c < nc,
// zero elsewhere.  vbytes is the copy width, 16, 8 or 4 bytes: it divides
// ld and nc in bytes and src is aligned to it, so a copy lies wholly inside
// or wholly outside the valid columns.  vbytes 2 (bf16 rows aligned to no
// more) is copied element by element.
template <typename T, int ROWS, int COLS, int DS>
__device__ __forceinline__ void copy_tile(T* dst, const T* __restrict__ src, size_t ld, int nr,
                                          int nc, int vbytes, int lane) {
  constexpr int kE = (int)sizeof(T);
  if (vbytes == 16) {
    copy_chunks<T, 16 / kE, ROWS, COLS, DS>(dst, src, ld, nr, nc, lane);
  } else if (vbytes == 8) {
    copy_chunks<T, 8 / kE, ROWS, COLS, DS>(dst, src, ld, nr, nc, lane);
  } else if (vbytes == 4) {
    copy_chunks<T, 4 / kE, ROWS, COLS, DS>(dst, src, ld, nr, nc, lane);
  } else {
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(src);
    unsigned short* d16 = reinterpret_cast<unsigned short*>(dst);
    for (int i = lane; i < ROWS * COLS; i += 32) {
      const int r = i / COLS, c = i % COLS;
      d16[r * DS + c] = (r < nr && c < nc) ? s16[(size_t)r * ld + c] : (unsigned short)0;
    }
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as the plain version
}

// One stage's products, f32 on the CUDA cores: lane (ly, lx) owns rows
// ly + 4 i and columns lx TN + j.
template <int BM, int BN>
__device__ __forceinline__ void stage_f32(const float* __restrict__ wt,
                                          const float* __restrict__ xt,
                                          float (&acc)[BM / 4][BN / 8], int lane) {
  using Tl = Tile<float, BM, BN>;
  constexpr int TM = BM / 4, TN = BN / 8;
  const int lx = lane & 7, ly = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < kKT; kk += 4) {
    float wv[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const float4 v = *reinterpret_cast<const float4*>(wt + (ly + 4 * i) * Tl::kWS + kk);
      wv[i][0] = v.x;
      wv[i][1] = v.y;
      wv[i][2] = v.z;
      wv[i][3] = v.w;
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float xv[TN];
      if constexpr (TN == 4) {
        const float4 v = *reinterpret_cast<const float4*>(xt + (kk + q) * Tl::kXS + lx * 4);
        xv[0] = v.x;
        xv[1] = v.y;
        xv[2] = v.z;
        xv[3] = v.w;
      } else {
        xv[0] = xt[(kk + q) * Tl::kXS + lx];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(wv[i][q], xv[j], acc[i][j]);
      }
    }
  }
}

// One stage's products, bf16 on the tensor cores: every m-tile x n-tile
// of the warp's tile.
template <int BM, int BN>
__device__ __forceinline__ void stage_bf16(const __nv_bfloat16* wt, const __nv_bfloat16* xt,
                                           float (&acc)[Tile<__nv_bfloat16, BM, BN>::kA][4],
                                           int lane) {
  using Tl = Tile<__nv_bfloat16, BM, BN>;
  constexpr int MT = Tl::kMT, NT = Tl::kNT;
#pragma unroll
  for (int kk = 0; kk < kKT / 16; ++kk) {
    uint32_t a[MT][4];
    if constexpr (BM == 8) {  // rows 8..15 of A are zero
      uint32_t h[2];
      const int col = kk * 16 + ((lane >> 3) & 1) * 8;
      tc::ldmatrix_x2(h, tc::smem_addr(wt + (lane & 7) * Tl::kWS + col));
      a[0][0] = h[0];
      a[0][1] = 0u;
      a[0][2] = h[1];
      a[0][3] = 0u;
    } else {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        tc::ldmatrix_x4(a[mt], tc::smem_addr(wt + (mt * 16 + (lane & 15)) * Tl::kWS + kk * 16 +
                                             (lane >> 4) * 8));
      }
    }
    const __nv_bfloat16* xr = xt + (kk * 16 + (lane & 15)) * Tl::kXS;
    if constexpr (NT == 1) {
      uint32_t b[2];
      tc::ldmatrix_x2_trans(b, tc::smem_addr(xr));
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) tc::mma_bf16(acc[mt], a[mt], b[0], b[1]);
    } else {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, tc::smem_addr(xr + np * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma_bf16(acc[mt * NT + 2 * np], a[mt], b[0], b[1]);
          tc::mma_bf16(acc[mt * NT + 2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
}

template <typename T, int BM, int BN>
__global__ void __launch_bounds__(kThreads, 1)
matmul_relu_kernel(const T* __restrict__ w, const T* __restrict__ x, T* __restrict__ out, int m,
                   int n, int k, int vw, int vx) {
  using Tl = Tile<T, BM, BN>;
  constexpr int kA = Tl::kA, kB = Tl::kB, kPerSlice = kSlice / kKT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int r0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  const int slices = (k + kSlice - 1) / kSlice;
  const int ranks = slices < kRanks ? slices : kRanks;

  float run[kA][kB];
#pragma unroll
  for (int i = 0; i < kA; ++i) {
#pragma unroll
    for (int j = 0; j < kB; ++j) run[i][j] = 0.0f;
  }
  if (warp < ranks) {
    unsigned char* ring = smem_raw + (size_t)warp * Tl::kStages * Tl::kStage;
    const int kb = warp * slices / ranks * kSlice;
    const int ke = min(k, (warp + 1) * slices / ranks * kSlice);
    const int stages = (ke - kb + kKT - 1) / kKT;
    const T* wb = w + (size_t)r0 * k;
    const T* xb = x + c0;
    auto w_stage = [&](int t) {
      return reinterpret_cast<T*>(ring + (t % Tl::kStages) * Tl::kStage);
    };
    auto x_stage = [&](int t) { return w_stage(t) + BM * Tl::kWS; };
    auto issue = [&](int t) {
      if (t < stages) {
        const int k0 = kb + t * kKT;
        copy_tile<T, BM, kKT, Tl::kWS>(w_stage(t), wb + k0, k, m - r0, k - k0, vw, lane);
        copy_tile<T, kKT, BN, Tl::kXS>(x_stage(t), xb + (size_t)k0 * n, n, k - k0, n - c0, vx,
                                       lane);
      }
      tc::cp_async_commit();
    };

    float acc[kA][kB];
#pragma unroll
    for (int i = 0; i < kA; ++i) {
#pragma unroll
      for (int j = 0; j < kB; ++j) acc[i][j] = 0.0f;
    }
    for (int t = 0; t < Tl::kStages - 1; ++t) issue(t);
    for (int t = 0; t < stages; ++t) {
      tc::cp_async_wait<Tl::kStages - 2>();  // stage t has landed ...
      __syncwarp();                          // ... for every lane, and stage t - 1 is read
      issue(t + Tl::kStages - 1);
      if constexpr (Tl::kF32) {
        stage_f32<BM, BN>(w_stage(t), x_stage(t), acc, lane);
      } else {
        stage_bf16<BM, BN>(w_stage(t), x_stage(t), acc, lane);
      }
      // A slice ends every kPerSlice stages and at the range's end: its
      // sum joins the running sum, and the next slice starts from zero.
      if ((t + 1) % kPerSlice == 0 || t + 1 == stages) {
#pragma unroll
        for (int i = 0; i < kA; ++i) {
#pragma unroll
          for (int j = 0; j < kB; ++j) {
            run[i][j] += acc[i][j];
            acc[i][j] = 0.0f;
          }
        }
      }
    }
  }
  __syncthreads();  // every ring is read: its space holds the warps' sums
  float* part = reinterpret_cast<float*>(smem_raw) + (size_t)warp * BM * BN;  // [BM][BN]
  if (warp < ranks) {
    if constexpr (Tl::kF32) {
      const int lx = lane & 7, ly = lane >> 3;
#pragma unroll
      for (int i = 0; i < kA; ++i) {
#pragma unroll
        for (int j = 0; j < kB; ++j) part[(ly + 4 * i) * BN + lx * kB + j] = run[i][j];
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < Tl::kMT; ++mt) {
#pragma unroll
        for (int nt = 0; nt < Tl::kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 16 + (lane >> 2) + (e >> 1) * 8;
            const int c = nt * 8 + (lane & 3) * 2 + (e & 1);
            if (r < BM) part[r * BN + c] = run[mt * Tl::kNT + nt][e];
          }
        }
      }
    }
  }
  __syncthreads();
  // The warps' sums in warp order.
  const float* parts = reinterpret_cast<const float*>(smem_raw);
  for (int e = tid; e < BM * BN; e += kThreads) {
    float v = parts[e];
    for (int j = 1; j < ranks; ++j) v += parts[(size_t)j * BM * BN + e];
    const int r = r0 + e / BN, c = c0 + e % BN;
    // Not fmaxf, which turns NaN into 0: a NaN sum stays NaN, as in
    // torch.relu.  -0 is written as +0.
    if (r < m && c < n) store_out(out + (size_t)r * n + c, v <= 0.0f ? 0.0f : v);
  }
}

// The widest copy (16, 8 or 4 bytes) that rows of `cols` elements of
// `elem` bytes starting at p allow; 2 for bf16 rows aligned to no more.
int copy_bytes(const void* p, int cols, int elem) {
  for (int v = 16; v >= 4; v /= 2) {
    if (((size_t)cols * elem) % v == 0 && reinterpret_cast<size_t>(p) % v == 0) return v;
  }
  return elem == 2 ? 2 : 4;
}

template <typename T, int BM, int BN>
int launch_tiles(const T* w, const T* x, T* out, int m, int n, int k, cudaStream_t stream) {
  using Tl = Tile<T, BM, BN>;
  const int col_tiles = (n + BN - 1) / BN;
  if (col_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = matmul_relu_kernel<T, BM, BN>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)Tl::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<dim3((m + BM - 1) / BM, col_tiles), kThreads, Tl::kSmem, stream>>>(
      w, x, out, m, n, k, copy_bytes(w, k, sizeof(T)), copy_bytes(x, n, sizeof(T)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* w, const void* x, void* out, int m, int n, int k, void* stream) {
  const T* wt = static_cast<const T*>(w);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The tile decides only how much of it is padding and how often W and X
  // are read: narrow batches (buckets 1 and 8) take 8 x 8 (128 blocks at
  // m = 1020), up to 32 columns 16 x 32, wider ones 32 x 32.
  if (n <= 8) return launch_tiles<T, 8, 8>(wt, xt, ot, m, n, k, s);
  if (n <= 32) return launch_tiles<T, 16, 32>(wt, xt, ot, m, n, k, s);
  return launch_tiles<T, 32, 32>(wt, xt, ot, m, n, k, s);
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
