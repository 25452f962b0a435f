// flash_attention: causal, optionally sliding-window, attention for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel).  q is (B, H, S, hd) and k,
// v are (B, H_kv, S, hd), row-major, of one type (f32 or bf16), with H a
// multiple of H_kv: query head h reads KV head h / (H / H_kv) in place, so
// a GQA model passes its KV heads unrepeated.  The output is (B, H, S, hd)
// in the inputs' type.  As in the TPU kernel the inputs are widened to f32
// and scaled by 1/sqrt(hd), an online softmax (m, l, acc) runs over KV
// tiles, a masked score is -1e30, and the output is acc / max(l, 1e-30),
// cast once at the end.
//
// Masks and skipping: key kp counts for query qp when kp <= qp, kp < S and,
// with a window, qp - kp < window.  A KV tile is skipped whole when it lies
// right of every row of the query tile or, with a window, left of every
// row's window: the TPU kernel's two conditions at this kernel's tile
// sizes.  A masked pair adds exactly 0 to l and acc (the TPU kernel gets
// the same sums, since every row it finishes has seen its own key).  Rows
// past S load as 0, so any S >= 1 runs, with no alignment fallback.  Query
// tiles run longest first.  Tiles come in as 16-byte chunks, so a row of
// hd values must be a whole number of them (hd a multiple of 4 in f32, of
// 8 in bf16: every head_dim of the repo's configs, 64, 80, 120 and 128)
// and q, k, v 16-byte aligned; the launch refuses anything else.
//
// What bounds it on an H100 SXM: operations.  At the full-width
// H2O-Danube3-4B shape (1, 32, 8192, 120), window 4096, the unmasked pairs
// need 4 * hd * 32 * 25,167,872 = 3.87e11 operations: 0.391 ms at the bf16
// tensor-core peak of 989 TFLOP/s, 5.8 ms at the f32 CUDA-core peak of 67.
//
// The bf16 instance (flash_attention_mma_kernel): FlashAttention-2 tiling
// on the tensor cores.  One block of 4 warps takes 64 query rows of one
// (b, h), each warp 16 of them, and two blocks share an SM (at most 255
// registers a thread, 40 or 80 KB of shared memory a block), so that one
// block computes while the other waits at a barrier.  Q is loaded once
// and its mma A fragments stay in registers; K and V come in tiles of 64
// keys through a ring of two shared-memory stages filled by cp.async
// (zero fill past S and in the columns of hd padded to a multiple of 16),
// the next tile's copy in flight during the current tile's math.  Rows of
// 16-byte chunks are XOR-swizzled (chunk ^ row % 8), so every ldmatrix
// reads 8 distinct bank groups.  S = Q K^T runs on mma.m16n8k16 bf16 with
// f32 accumulators: the products of bf16 values are exact in f32, and the
// scale (with log2 e) is applied to the f32 sum.  The online softmax works
// on the accumulator fragments (row max over the 4 lanes of a quad), with
// 2^x from ex2.approx (relative error about 2^-22; a p below 2^-126 is
// flushed to 0, nothing beside the row maximum's p = 1).  Only tiles that
// cross a warp's diagonal or window edge test each pair, and a warp skips
// the tiles that are wholly masked for its rows.  P V keeps p at about 16
// significant bits, not bf16's 8: p is split in registers into p_hi =
// bf16(p) and p_lo = bf16(p - p_hi), and p_hi V + p_lo V run as two mmas
// on the same ldmatrix.trans fragments of V (the C layout of the scores is
// the A layout of the second product).  So the kernel differs from the
// plain version by f32 summation order and rounding only, as the TPU
// kernel's f32 p @ v does; l sums the f32 p.  The split makes the real mma
// count 1.5x the operations above (and hd 120 pads to 128 in Q K^T):
// about 5.9e11, 0.60 ms at the bf16 peak, which mma.sync, without wgmma,
// reaches only in part.
//
// The f32 instance (flash_attention_kernel): a plain SIMT kernel on the
// CUDA cores.  One block of 128 threads takes 64 query rows of one (b, h);
// Q^T stays in shared memory, and each 64-key tile of K^T and V is staged
// there in turn.  A thread
// owns 4 rows x 8 keys of the score tile (32 FMAs per 3 shared loads) and
// 4 rows x hd/8 columns of acc; m and l live in registers, row maxima and
// sums go through 8-lane shuffles, and P goes through shared memory (over
// K^T, which it no longer needs) to the P V product.  hd is padded to D =
// 32, 64, 96 or 128 with zeros.  Tiles come in through 16-byte loads,
// eight in flight per thread.
//
// Determinism: no atomics and no split over keys.  The order of every sum
// is fixed by the tile sizes alone (one fmaf chain per score and per acc
// element in f32; a fixed sequence of mmas in bf16), and the shuffle
// reductions give every lane of a row the same value, so the output is
// bit-identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "tensor_core.cuh"

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kThreads = 128;  // 16 row groups (ty) x 8 key/column groups (tx)
// Row stride of the transposed tiles: a multiple of 4 floats keeps float4
// reads aligned, and 68 = 4 (mod 32) lets the transposing stores below hit
// 32 different banks.
constexpr int kStride = 68;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// Tile loader.  Copies rows [r0, r0 + 64) of a (S, hd) f32 slice into
// shared memory, with zeros for rows >= S: transposed (t[d * kStride + r],
// for Q scaled by 1/sqrt(hd), and K) or row-major (t[r * (D + 4) + d], for
// V), in 16-byte loads.  Consecutive lanes take consecutive rows, so the
// transposed stores hit consecutive banks and the row-major float4 stores,
// with their row stride of D + 4 = 4 (mod 32) floats, hit 8 distinct
// 16-byte bank groups per quarter warp.  Columns hd..D-1 are not written:
// the kernel zeroes those rows of Q^T and K^T once, and V's are never
// read into a stored output.
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

template <typename T, int D, bool kTransposed>
__device__ __forceinline__ void load_tile(const T* __restrict__ src, float* __restrict__ t,
                                          int r0, int s, int hd, float scale, int tid) {
  constexpr int kN = 16 / sizeof(T);
  const int n = 64 * (hd / kN);
#pragma unroll 8
  for (int e = tid; e < n; e += kThreads) {
    const int r = e & 63, c = (e >> 6) * kN;
    const int row = r0 + r;
    float f[kN];
    if (row < s) {
      unpack16(__ldg(reinterpret_cast<const uint4*>(src + (size_t)row * hd + c)), f);
    } else {
#pragma unroll
      for (int j = 0; j < kN; ++j) f[j] = 0.0f;
    }
    if (kTransposed) {
#pragma unroll
      for (int j = 0; j < kN; ++j) t[(c + j) * kStride + r] = f[j] * scale;
    } else {
#pragma unroll
      for (int j = 0; j < kN; j += 4) {
        *reinterpret_cast<float4*>(t + r * (D + 4) + c + j) =
            make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
      }
    }
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)D * kStride + (size_t)(D > kBK ? D : kBK) * kStride +
                          (size_t)kBK * (D + 4));
}

// The key of score column j (0..7) of thread column group tx.
__device__ __forceinline__ int key_of(int tx, int j) { return (j < 4 ? 0 : 32) + tx * 4 + (j & 3); }

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int s, int hd, int group, int window, float scale) {
  static_assert(D % 32 == 0 && D <= 128, "D is hd padded to a multiple of 32, at most 128");
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);    // Q^T, scaled: [D][kStride]
  float* kpt = qt + D * kStride;                  // K^T, then P^T: [max(D, 64)][kStride]
  float* vs = kpt + (D > kBK ? D : kBK) * kStride;  // V: [kBK][D + 4]

  const int tid = threadIdx.x;
  const int tx = tid & 7;   // keys tx*4 + {0..3, 32..35}; columns tx*4 + 32 c + {0..3}
  const int ty = tid >> 3;  // rows ty*4 + {0..3}
  const int nq = (s + kBQ - 1) / kBQ;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kBQ;  // longest rows first
  const size_t head = (size_t)blockIdx.y * s * hd;
  const size_t kv_head = (size_t)(blockIdx.y / group) * s * hd;  // GQA: KV read in place

  for (int e = tid; e < (D - hd) * kStride; e += kThreads) {
    qt[hd * kStride + e] = 0.0f;   // the padding rows d >= hd of Q^T and K^T;
    kpt[hd * kStride + e] = 0.0f;  // P^T later leaves only finite values there
  }
  load_tile<T, D, true>(q + head, qt, q0, s, hd, scale, tid);

  constexpr int kCols = D / 8;
  float acc[4][kCols];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  const int q_last = q0 + kBQ - 1;
  for (int k0 = 0; k0 <= q_last && k0 < s; k0 += kBK) {
    if (window > 0 && q0 - (k0 + kBK - 1) >= window) continue;  // uniform over the block
    __syncthreads();  // the previous tile's P^T and V are read
    load_tile<T, D, true>(k + kv_head, kpt, k0, s, hd, 1.0f, tid);
    load_tile<T, D, false>(v + kv_head, vs, k0, s, hd, 1.0f, tid);
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.0f;
    }
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * kStride + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(kpt + d * kStride + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(kpt + d * kStride + 32 + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(av[i], bv[j], sc[i][j]);
      }
    }

    // Online softmax, row by row; the 8 lanes of a row group hold its keys.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      unsigned ok = 0;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kp = k0 + key_of(tx, j);
        if (kp <= qp && kp < s && (window <= 0 || qp - kp < window)) {
          ok |= 1u << j;
          mx = fmaxf(mx, sc[i][j]);
        }
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        sc[i][j] = (ok >> j & 1u) ? expf(sc[i][j] - m_new) : 0.0f;
        sum += sc[i][j];
      }
#pragma unroll
      for (int off = 1; off < 8; off <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // every thread is done with K^T before P^T overwrites it
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      *reinterpret_cast<float4*>(kpt + key_of(tx, j) * kStride + ty * 4) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 p4 = *reinterpret_cast<const float4*>(kpt + kk * kStride + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int cg = 0; cg < D / 32; ++cg) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + kk * (D + 4) + cg * 32 + tx * 4);
        const float vv4[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][cg * 4 + c] = fmaf(pv[i], vv4[c], acc[i][cg * 4 + c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int cg = 0; cg < D / 32; ++cg) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = cg * 32 + tx * 4 + c;
        if (d < hd) store(out + head + (size_t)row * hd + d, acc[i][cg * 4 + c] / denom);
      }
    }
  }
}

template <typename T, int D>
int launch_padded(const void* q, const void* k, const void* v, void* out, int bh, int s,
                  int hd, int group, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // Above 48 KB of dynamic shared memory only after opting in (per device,
  // so at every launch: a host-side call of about a microsecond).
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, hd, group, window, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------------------ bf16: mma

constexpr int kRows = 64;  // query rows per block
constexpr int kWarps = 4;  // 16 rows each
constexpr int kKeys = 64;   // keys per KV tile
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Shape {
  static constexpr int D = (HD + 15) / 16 * 16;  // depth of Q K^T, zero padded
  static constexpr int KS = D / 16;              // its k-steps
  static constexpr int NT = HD / 8;              // 8-column n-tiles of P V
  static constexpr int NC = D / 8;               // 16-byte chunks loaded per row
  static constexpr int SC = D <= 64 ? 8 : 16;    // chunks per shared row (the XOR spans 8)
  static constexpr unsigned kTile = kKeys * SC * 16;  // bytes of one K or V stage
  static constexpr size_t kSmem = (size_t)kRows * SC * 16 + 4 * (size_t)kTile;
};

// Byte offset of 16-byte chunk c of row r in a swizzled tile.
template <int SC>
__device__ __forceinline__ unsigned swz(int r, int c) {
  return (unsigned)((r * SC + (c ^ (r & 7))) * 16);
}

// Rows [r0, r0 + ROWS) of an (S, hd) bf16 slice into the swizzled tile at
// `dst` by cp.async: zeros for rows >= S and for chunks past hd.
template <int ROWS, int NC, int SC>
__device__ __forceinline__ void copy_tile(unsigned dst, const __nv_bfloat16* __restrict__ src,
                                          int r0, int s, int hd, int tid) {
  constexpr int kN = ROWS * NC;
#pragma unroll
  for (int i = 0; i < (kN + kWarps * 32 - 1) / (kWarps * 32); ++i) {
    const int e = tid + i * kWarps * 32;
    if (kN % (kWarps * 32) != 0 && e >= kN) break;
    const int r = e / NC, c = e % NC;
    const bool ok = r0 + r < s && c * 8 < hd;
    tc::cp_async16(dst + swz<SC>(r, c), ok ? src + (size_t)(r0 + r) * hd + c * 8 : src, ok);
  }
}

// p as p_hi + p_lo, both packed bf16 pairs: p - bf16(p) is exact in f32.
__device__ __forceinline__ void split(float x, float y, unsigned& hi, unsigned& lo) {
  hi = tc::pack_bf16(x, y);
  lo = tc::pack_bf16(x - tc::low_bf16(hi), y - tc::high_bf16(hi));
}

// One warp's 16 rows against one 64-key tile (K at `sk`, V at `sv`): the
// lane's rows are qr and qr + 8, its score columns 8 j + 2 (lane % 4) + {0, 1}.
template <int HD, bool kMasked>
__device__ __forceinline__ void attend_tile(const unsigned (&qa)[Shape<HD>::KS][4], unsigned sk,
                                            unsigned sv, int lane, int k0, int qr, int s,
                                            int window, float scale_log2,
                                            float (&acc)[Shape<HD>::NT][4], float (&m)[2],
                                            float (&l)[2]) {
  using Sh = Shape<HD>;
  const int r8 = lane & 7;
  float sc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
  }
#pragma unroll
  for (int kk = 0; kk < Sh::KS; ++kk) {
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // keys 16 np .. 16 np + 15
      unsigned b[4];
      tc::ldmatrix_x4(b, sk + swz<Sh::SC>(np * 16 + r8 + (lane >> 4) * 8,
                                          kk * 2 + ((lane >> 3) & 1)));
      tc::mma_bf16(sc[2 * np], qa[kk], b[0], b[1]);
      tc::mma_bf16(sc[2 * np + 1], qa[kk], b[2], b[3]);
    }
  }

  // Scores in log2 units; a masked pair is -1e30 for the max and p = 0.
  unsigned ok = 0xffffffffu;
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[j][e] * scale_log2;
      if (kMasked) {
        const int qp = qr + (e >> 1) * 8;
        const int kp = k0 + j * 8 + (lane & 3) * 2 + (e & 1);
        if (!(kp <= qp && kp < s && (window <= 0 || qp - kp < window))) {
          ok &= ~(1u << (j * 4 + e));
          x = kNegInf;
        }
      }
      sc[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
  float corr[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = tc::ex2(m[i] - m_new);
    m[i] = m_new;
  }
  float rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p =
          (!kMasked || (ok >> (j * 4 + e) & 1u)) ? tc::ex2(sc[j][e] - m[e >> 1]) : 0.0f;
      sc[j][e] = p;
      rs[e >> 1] += p;
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + rs[i];  // this lane's share of l
#pragma unroll
  for (int n = 0; n < Sh::NT; ++n) {
    acc[n][0] *= corr[0];
    acc[n][1] *= corr[0];
    acc[n][2] *= corr[1];
    acc[n][3] *= corr[1];
  }

  // acc += P V, P = P_hi + P_lo, over the tile's 4 k-steps of 16 keys.
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    unsigned hi[4], lo[4];
    split(sc[2 * kk][0], sc[2 * kk][1], hi[0], lo[0]);
    split(sc[2 * kk][2], sc[2 * kk][3], hi[1], lo[1]);
    split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], hi[2], lo[2]);
    split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], hi[3], lo[3]);
    const int row = kk * 16 + r8 + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int np = 0; np < Sh::NT / 2; ++np) {  // columns 16 np .. 16 np + 15
      unsigned b[4];
      tc::ldmatrix_x4_trans(b, sv + swz<Sh::SC>(row, np * 2 + (lane >> 4)));
      tc::mma_bf16(acc[2 * np], hi, b[0], b[1]);
      tc::mma_bf16(acc[2 * np], lo, b[0], b[1]);
      tc::mma_bf16(acc[2 * np + 1], hi, b[2], b[3]);
      tc::mma_bf16(acc[2 * np + 1], lo, b[2], b[3]);
    }
    if (Sh::NT % 2) {  // a last 8 columns (hd 120: 112..119)
      unsigned b[2];
      tc::ldmatrix_x2_trans(b, sv + swz<Sh::SC>(row, Sh::NT - 1));
      tc::mma_bf16(acc[Sh::NT - 1], hi, b[0], b[1]);
      tc::mma_bf16(acc[Sh::NT - 1], lo, b[0], b[1]);
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32, 2)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                           int s, int hd, int group, int window, float scale_log2) {
  using Sh = Shape<HD>;
  extern __shared__ uint4 smem[];
  const unsigned sq = tc::smem_addr(smem);                   // Q: [64][SC chunks]
  const unsigned sk = sq + kRows * Sh::SC * 16;              // K: 2 stages of [64][SC]
  const unsigned sv = sk + 2 * Sh::kTile;                    // V: 2 stages of [64][SC]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nq = (s + kRows - 1) / kRows;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kRows;  // longest rows first
  const size_t head = (size_t)blockIdx.y * s * hd;
  const size_t kv_head = (size_t)(blockIdx.y / group) * s * hd;  // GQA: KV read in place
  const __nv_bfloat16* kh = k + kv_head;
  const __nv_bfloat16* vh = v + kv_head;

  // KV tiles t_begin .. t_end - 1: not right of the last row, not left of
  // the first row's window (the block-level skip).
  const int t_end = min((s + kKeys - 1) / kKeys, (q0 + kRows - 1) / kKeys + 1);
  const int t_begin =
      (window > 0 && q0 - window - (kKeys - 1) >= 0) ? (q0 - window - (kKeys - 1)) / kKeys + 1 : 0;

  copy_tile<kRows, Sh::NC, Sh::SC>(sq, q + head, q0, s, hd, tid);
  tc::cp_async_commit();
  copy_tile<kKeys, Sh::NC, Sh::SC>(sk, kh, t_begin * kKeys, s, hd, tid);
  copy_tile<kKeys, Sh::NC, Sh::SC>(sv, vh, t_begin * kKeys, s, hd, tid);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();  // Q has landed
  __syncthreads();

  const int r8 = lane & 7;
  unsigned qa[Sh::KS][4];
#pragma unroll
  for (int kk = 0; kk < Sh::KS; ++kk) {
    tc::ldmatrix_x4(qa[kk], sq + swz<Sh::SC>(warp * 16 + r8 + ((lane >> 3) & 1) * 8,
                                             kk * 2 + (lane >> 4)));
  }

  float acc[Sh::NT][4];
#pragma unroll
  for (int n = 0; n < Sh::NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};
  const int qw = q0 + warp * 16;      // the warp's first row
  const int qr = qw + (lane >> 2);    // the lane's rows qr and qr + 8

  for (int t = t_begin; t < t_end; ++t) {
    const unsigned stage = ((t - t_begin) & 1) * Sh::kTile;
    tc::cp_async_wait<0>();  // tile t has landed ...
    __syncthreads();         // ... for every thread, and tile t - 1 is read
    if (t + 1 < t_end) {
      copy_tile<kKeys, Sh::NC, Sh::SC>(sk + (Sh::kTile - stage), kh, (t + 1) * kKeys, s, hd, tid);
      copy_tile<kKeys, Sh::NC, Sh::SC>(sv + (Sh::kTile - stage), vh, (t + 1) * kKeys, s, hd, tid);
    }
    tc::cp_async_commit();
    const int k0 = t * kKeys;
    // Warp-uniform: skip a tile wholly masked for the warp's rows (or rows
    // all past S); test pairs only on a tile that crosses its diagonal or
    // window edge.
    if (qw >= s || k0 > qw + 15 || (window > 0 && qw - (k0 + kKeys - 1) >= window)) continue;
    if (k0 + kKeys - 1 <= qw && (window <= 0 || qw + 15 - k0 < window)) {
      attend_tile<HD, false>(qa, sk + stage, sv + stage, lane, k0, qr, s, window, scale_log2,
                             acc, m, l);
    } else {
      attend_tile<HD, true>(qa, sk + stage, sv + stage, lane, k0, qr, s, window, scale_log2,
                            acc, m, l);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {  // l over the quad: every lane gets the same sum
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qr + i * 8;
    if (row >= s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    __nv_bfloat16* o = out + head + (size_t)row * hd;
#pragma unroll
    for (int n = 0; n < Sh::NT; ++n) {
      const int col = n * 8 + (lane & 3) * 2;
      if (col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(o + col) =
            __floats2bfloat162_rn(acc[n][2 * i] / denom, acc[n][2 * i + 1] / denom);
      }
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, void* out, int bh, int s, int hd,
               int group, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = Shape<HD>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_mma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kRows - 1) / kRows, bh);
  flash_attention_mma_kernel<HD><<<grid, kWarps * 32, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), s, hd, group,
      window, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s, int hd,
           int group, int window, float scale, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  if ((hd * sizeof(T)) % 16 != 0 || !aligned(q) || !aligned(k) || !aligned(v) || group < 1 ||
      bh % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (sizeof(T) == 2) {  // bf16: the tensor-core kernel at the next instance of hd
    if (hd <= 32) return launch_mma<32>(q, k, v, out, bh, s, hd, group, window, scale, st);
    if (hd <= 64) return launch_mma<64>(q, k, v, out, bh, s, hd, group, window, scale, st);
    if (hd <= 80) return launch_mma<80>(q, k, v, out, bh, s, hd, group, window, scale, st);
    if (hd <= 96) return launch_mma<96>(q, k, v, out, bh, s, hd, group, window, scale, st);
    if (hd <= 120) return launch_mma<120>(q, k, v, out, bh, s, hd, group, window, scale, st);
    return launch_mma<128>(q, k, v, out, bh, s, hd, group, window, scale, st);
  } else {
    if (hd <= 32) return launch_padded<T, 32>(q, k, v, out, bh, s, hd, group, window, scale, st);
    if (hd <= 64) return launch_padded<T, 64>(q, k, v, out, bh, s, hd, group, window, scale, st);
    if (hd <= 96) return launch_padded<T, 96>(q, k, v, out, bh, s, hd, group, window, scale, st);
    return launch_padded<T, 128>(q, k, v, out, bh, s, hd, group, window, scale, st);
  }
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers, 16-byte aligned:
// q and out (B*H, S, hd), k and v (B*H_kv, S, hd), row-major, with group =
// H / H_kv >= 1 dividing B*H; 1 <= hd <= 128 with hd * sizeof(T) a
// multiple of 16 (else cudaErrorInvalidValue, nothing launched); 1 <= B*H
// <= 65535; window <= 0 means no window; scale is 1/sqrt(hd).  The launch
// goes on `stream` and does not synchronise.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int bh, int s, int hd, int group, int window, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, out, bh, s, hd, group, window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int bh, int s, int hd, int group, int window, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, bh, s, hd, group, window, scale, stream);
}
