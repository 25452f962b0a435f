// flash_attention: causal, optionally sliding-window, attention for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_pallas, body _flash_kernel).  q, k and v are (B, H, S, hd),
// row-major, of one type (f32 or bf16), with the KV heads already repeated
// to H; the output is (B, H, S, hd) in that type.  As in the TPU kernel the
// inputs are widened to f32, q is multiplied by 1/sqrt(hd) before the dot,
// an online softmax (m, l, acc) runs over KV tiles, a masked score is
// -1e30, and the output is acc / max(l, 1e-30), cast once at the end.
//
// Masks and skipping: key kp counts for query qp when kp <= qp, kp < S and,
// with a window, qp - kp < window.  A KV tile is skipped whole when it lies
// right of every row of the query tile (k0 > q0 + 63) or, with a window,
// left of every row's window (q0 - (k0 + 63) >= window): the TPU kernel's
// two conditions at this kernel's tile sizes.  A masked element adds
// exactly 0 to l and acc (the TPU kernel gets the same sums, since every
// row it finishes has seen its own key).  Rows past S load as 0, so any
// S >= 1 runs, with no alignment fallback.
//
// What bounds it on an H100 SXM: operations.  At the full-width
// H2O-Danube3-4B shape (1, 32, 8192, 120), window 4096, the unmasked pairs
// need 4 * hd * 32 * 25,167,872 = 3.87e11 operations; this kernel computes
// in f32 on the CUDA cores, whose 67 TFLOP/s make that 5.8 ms (0.39 ms at
// the bf16 tensor-core rate, which a kernel that computes in f32 cannot
// reach).  What the design does about it: a plain SIMT kernel, right first
// and fast later.  One block of 128 threads takes 64 query rows of one
// (b, h); Q^T stays in shared memory, and each 64-key tile of K^T and V is
// staged there in turn.  A thread owns 4 rows x 8 keys of the score tile
// (32 FMAs per 3 shared loads) and 4 rows x hd/8 columns of acc; m and l
// live in registers, row maxima and sums go through 8-lane shuffles, and P
// goes through shared memory (over K^T, which it no longer needs) to the
// P V product.  hd is padded to D = 32, 64, 96 or 128 with zeros.  Tiles
// come in through 16-byte loads, eight in flight per thread, so a row of
// hd values must be a whole number of 16-byte chunks (hd a multiple of 4
// in f32, of 8 in bf16: every head_dim of the repo's configs, 64, 80, 120
// and 128) and q, k, v 16-byte aligned; the launch refuses anything else.
// Query tiles run longest first.  No tensor cores, no TMA, no
// overlap of a tile's loads with the previous tile's math: those are later
// work.
//
// Determinism: no atomics and no split over keys.  Each score is one fmaf
// chain over d in order, each acc element one chain over the keys in
// order, and the shuffle reductions give every lane the same value, so the
// output is bit-identical from run to run.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as the plain version
}

// Tile loader.  Copies rows [r0, r0 + 64) of a (S, hd) slice into shared
// memory, widened to f32, with zeros for rows >= S: transposed
// (t[d * kStride + r], for Q scaled by 1/sqrt(hd), and K) or row-major
// (t[r * (D + 4) + d], for V), in 16-byte loads (4 f32 or 8 bf16).
// Consecutive lanes take consecutive rows, so the transposed stores hit
// consecutive banks and the row-major float4 stores, with their row stride
// of D + 4 = 4 (mod 32) floats, hit 8 distinct 16-byte bank groups per
// quarter warp.  Columns hd..D-1 are not written: the kernel zeroes those
// rows of Q^T and K^T once, and V's are never read into a stored output.
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack16(const uint4 raw, float (&f)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its f32
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
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
                       int s, int hd, int window, float scale) {
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
    load_tile<T, D, true>(k + head, kpt, k0, s, hd, 1.0f, tid);
    load_tile<T, D, false>(v + head, vs, k0, s, hd, 1.0f, tid);
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
                  int hd, int window, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  // Above 48 KB of dynamic shared memory only after opting in (per device,
  // so at every launch: a host-side call of about a microsecond).
  const cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((s + kBQ - 1) / kBQ, bh);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), s, hd, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int bh, int s, int hd,
           int window, float scale, void* stream) {
  const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  if ((hd * sizeof(T)) % 16 != 0 || !aligned(q) || !aligned(k) || !aligned(v)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) return launch_padded<T, 32>(q, k, v, out, bh, s, hd, window, scale, st);
  if (hd <= 64) return launch_padded<T, 64>(q, k, v, out, bh, s, hd, window, scale, st);
  if (hd <= 96) return launch_padded<T, 96>(q, k, v, out, bh, s, hd, window, scale, st);
  return launch_padded<T, 128>(q, k, v, out, bh, s, hd, window, scale, st);
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers to (B*H, S, hd)
// row-major tensors, 16-byte aligned; 1 <= hd <= 128 with hd * sizeof(T)
// a multiple of 16 (else cudaErrorInvalidValue, nothing launched);
// 1 <= B*H <= 65535; window <= 0 means no window; scale is 1/sqrt(hd).  The launch goes on `stream` and does
// not synchronise.  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_f32(const void* q, const void* k, const void* v, void* out,
                                   int bh, int s, int hd, int window, float scale,
                                   void* stream) {
  return launch<float>(q, k, v, out, bh, s, hd, window, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k, const void* v, void* out,
                                    int bh, int s, int hd, int window, float scale,
                                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, out, bh, s, hd, window, scale, stream);
}
