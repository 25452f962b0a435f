// ssm_scan: the Mamba2 chunked selective-state-space scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan/kernel.py
// (ssm_scan_pallas, body _ssm_kernel).  Inputs: x (B, S, H, dh) and B, C
// (B, S, ds) of one type (f32 or bf16), dt (B, S, H) f32 (softplus'd) and
// a (H,) f32 (negative).  Outputs: y (B, S, H, dh) in x's type and the
// final state h (B, H, dh, ds) in f32; the state starts at 0.  For one
// (b, h) and one chunk of c steps, with la the inclusive in-chunk
// cumulative sum of a * dt and g(u) = exp(clip(u, -60, 0)):
//
//   y[t]  = g(la_t) C_t . h  +  sum_{s<=t} (C_t . B_s) g(la_t - la_s) dt_s x_s
//   h    <- g(la_last) h  +  sum_s g(la_last - la_s) dt_s x_s (x) B_s
//
// Everything is summed in f32 and y is rounded once to its type.
//
// The TPU grid is (B, H, chunks) with the chunk axis sequential and the
// state in VMEM scratch.  Here nothing carries between blocks, and only
// the state update is sequential: a chunk's state sum and its output
// given the state at its start are independent of the other chunks.  So
// one call runs three kernels on the stream:
//
//   1. states: each chunk's state sum S_c = sum_s g(la_last - la_s) dt_s
//      x_s (x) B_s and its decay g(la_last), into scratch (f32).
//   2. carry, one thread per state element and (b, h), in chunk order:
//      h <- g h + S_c (one fmaf), the final state to h_out, and the state
//      at each chunk's start over S_c (f32 instance) or, as its two bf16
//      pieces, into a second scratch (bf16 instance); it loads 8 chunks'
//      S_c ahead of their updates.
//   3. outputs: y from the state at the chunk's start.
//
// Every kernel forms la in one fixed order: warp 0's lanes each sum a run
// of steps in order (each a * dt rounded first), and a shuffle scan adds
// the runs (chunk_la); kernels 1 and 3 of both instances run it, so they
// see the same la.  Any c that is a multiple of 16 up to 256 runs (partial
// tiles read 0 and are masked), ds up to 64, any dh.
//
// The bf16 instance runs on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators).  x, B and C are bf16, so their products
// are exact; each f32 factor enters as bf16 pieces, v = p0 + p1 + ...
// with p0 = bf16(v), p1 = bf16(v - p0), ...: each subtraction is exact,
// so P pieces keep 8 P significant bits of v and every product is exact
// in f32.  The state sum's w_s B_s takes kStatePieces = 3 (all 24 bits:
// with two, 2^-16 relative, the final state misses its bar where |la| is
// small); y's factors, the masked scores and the state h, take
// kOutPieces = 2 (y is rounded to bf16 and held to 2^-7 of itself).  The
// tensor cores' accumulator does not round to nearest (gram.cuh), so it
// only ever sums one short run from zero, the pieces smallest first, and
// the runs are added in f32: kRun = 16 keys (or state columns) in kernel
// 1 and the inter-chunk term, kKeyRun = 64 keys (8 mmas) in kernel 3's
// product with x, where runs of 16 were slower.
//   Kernel 1 (ssm_state_mma_kernel): one block of 4 warps per (b, h,
//   chunk, 192 rows of dh).  Per 64-key tile the block forms the pieces
//   of w_s B_s (w_s = g(la_last - la_s) dt_s) once, into shared memory;
//   warp w owns the 16-row m-tiles w, w + 4, w + 8 of x^T (ldmatrix.trans
//   of the x tile) and all ds columns.
//   Kernel 3 (ssm_output_mma_kernel<NT>): one block of 4 warps per (b, h,
//   chunk, 64 query rows, 8 NT columns of dh), NT = 4, 10 or 20, so every
//   head size of the repo's configs (160, 80, 128, 64) is one tile; warp
//   w owns 16 query rows and all the tile's columns, and the C rows' mma
//   fragments stay in registers.  The inter-chunk term C_q h^T comes
//   first, from h's pieces (cp.async, ldmatrix), times g(la_t).  Then, per
//   64-key tile up to the diagonal, the scores C_q B_k^T are computed ONCE
//   for all columns of the head (the SIMT instance recomputes them per 32
//   columns), scaled by g(la_t - la_s) dt_s in registers with exactly 0
//   above the diagonal, split, and multiplied with the x tile
//   (ldmatrix.trans) straight from the mma accumulators (the C layout of
//   the scores is the A layout of the product).  Its decays take the
//   special-function unit's 2^x (relative error about 2^-22 + |u| 2^-24,
//   inside the bar's 2^-20 max|la|).  A warp skips the 16-key runs past
//   its last row.  Key tiles come through a ring of two cp.async stages;
//   the second stage reuses h's space once the inter-chunk term is done.
//
// The f32 instance keeps the SIMT kernels (ssm_state_kernel,
// ssm_output_kernel): blocks over 32 rows of the state (32 of dh), scores
// C_q B_k^T recomputed in each of the ceil(dh / 32) blocks of a head, all
// on the CUDA cores in f32.
//
// What bounds it on an H100 SXM: at (1, 8192, 32, 160), ds 64, chunk 256,
// counting the causal half of the two c^2 products and C B^T once per
// (b, chunk), the call needs 21.7 GFLOP and moves 172 MB in bf16: 0.051 ms
// at HBM rate.  The bf16 instance's real tensor-core work, with its
// pieces, C B^T per head and the causal tiles of 64, is about 2.1x those
// operations (46 GFLOP, 0.047 ms at 989 TFLOP/s), and its scratch (the
// states, 42 MB in f32, and h's pieces, 42 MB, each written and read
// once) adds 168 MB of HBM traffic (0.050 ms).  It reaches neither: mma.sync with few warps an SM
// (kernels 1 and 3 hold 220 and 240 registers a thread) waits on its
// latencies: chip_smoke.py measured 0.575 ms on an H100 80GB HBM3 at
// 700 W, of which kernel 3 0.401, kernel 1 0.132 and the carry 0.028 (the
// SIMT kernels took 3.078 ms, 2.60 of it in their kernel 3, which
// recomputed C B^T for every 32 columns of dh).
// The f32 instance computes at the 67 TFLOP/s CUDA-core peak: 0.32 ms
// (measured 2.663 ms).
//
// Determinism: no atomics, and every sum has a fixed order (the state sum
// over the steps, the carry over the chunks, each y element over the state
// then the keys; in bf16 a fixed sequence of mmas and f32 adds), so y and
// h are bit-identical from launch to launch.
//
// Non-finite values: a NaN in x, B, C or dt reaches every output it
// enters (a NaN or inf factor's pieces are NaN; an inf in x, B or C gives
// inf or NaN, as in the plain version).  A masked score is selected as 0,
// never multiplied, so a NaN in B or C stays in its own rows and columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kDT = 32;          // state rows (of dh) per block
constexpr int kQT = 64;          // query rows per tile
constexpr int kKT = 64;          // keys per tile
constexpr int kMaxChunk = 256;
constexpr int kMaxDS = 64;
// Row stride of the transposed tiles: a multiple of 4 floats keeps the
// float4 reads aligned.
constexpr int kPad = kQT + 4;

// The bf16 instance.
constexpr int kStatePieces = 3;  // bf16 pieces of kernel 1's f32 factor, w_s B_s
constexpr int kOutPieces = 2;    // bf16 pieces of kernel 3's f32 factors, the scores and h
constexpr int kRun = 16;         // keys (state columns) one mma accumulator sums from zero
constexpr int kKeyRun = 64;      // keys kernel 3's P x sums in one accumulator run: a key tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMmaThreads = 128; // 4 warps
constexpr int kStateD = 192;     // rows of dh per kernel-1 block: 12 m-tiles, 3 per warp
// Row strides (bf16 elements) of shared tiles read by ldmatrix: an odd
// number of 16-byte chunks, so the 8 rows of a read hit 8 bank groups.
constexpr int kSP = kMaxDS + 8;      // B, C and piece tiles: [64][ds]
constexpr int kXW = kStateD + 8;     // kernel 1's x tile: [64 keys][192]
static_assert(kRun == 16 && kKeyRun == kKT, "a run is one mma k-step, or one key tile");

struct Steps {
  float la[kMaxChunk];        // inclusive cumsum of a * dt
  float dt[kMaxChunk];
};

struct StateSmem {
  Steps st;
  float w[kMaxChunk];         // g(la_last - la_s) dt_s
  float x[kKT * kDT];         // x key tile, [s][d]
  float b[kKT * kMaxDS];      // B key tile, [s][p]
};

struct OutSmem {
  Steps st;
  float x[kKT * kDT];         // x key tile, [s][d]
  float bt[kMaxDS * kPad];    // B key tile, transposed: [p][s]
  float ct[kMaxDS * kPad];    // C query tile, transposed: [p][t]
  float sc[kKT * kPad];       // masked scores, transposed: [s][t]
  float ht[kMaxDS * kDT];     // the state at the chunk's start, transposed: [p][d]
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  // A bf16 is the high half of its f32.
  return __uint_as_float(static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
                         << 16);
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as the plain version
}

__device__ __forceinline__ float decay(float u) { return expf(fminf(fmaxf(u, -60.0f), 0.0f)); }

// Loads the chunk's dt (b, h, steps c0..c0+chunk-1) and forms la.  Lane l
// of warp 0 sums steps [l per, (l + 1) per) in order, each a * dt rounded
// first as the reference's log_a; a shuffle scan then adds the sums of the
// lanes before it.  Called by all kN threads of the block; ends with a
// barrier.
template <int kN>
__device__ __forceinline__ void chunk_la(Steps& st, const float* __restrict__ dtb, int c0,
                                         int chunk, int H, float ah, int tid) {
  for (int s = tid; s < chunk; s += kN) st.dt[s] = __ldg(dtb + (size_t)(c0 + s) * H);
  __syncthreads();
  if (tid < 32) {
    const int per = (chunk + 31) >> 5;
    const int lo = min(chunk, tid * per), hi = min(chunk, lo + per);
    float run = 0.0f;
    for (int s = lo; s < hi; ++s) {
      run = __fadd_rn(run, __fmul_rn(ah, st.dt[s]));
      st.la[s] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl = __fadd_rn(incl, v);
    }
    const float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid > 0) {
      for (int s = lo; s < hi; ++s) st.la[s] = __fadd_rn(before, st.la[s]);
    }
  }
  __syncthreads();
}

// ------------------------------------------------------------ f32: SIMT

// Rows s0..s0+ns-1 of x's 32-column tile at d0 (nd valid columns) into
// t[s][d], zeros elsewhere.
template <typename T>
__device__ __forceinline__ void load_x(float* __restrict__ t, const T* __restrict__ xb,
                                       size_t step, int s0, int ns, int nd, int tid) {
  for (int e = tid; e < kKT * kDT; e += kThreads) {
    const int s = e >> 5, d = e & 31;
    t[e] = (s < ns && d < nd) ? load(xb + (size_t)(s0 + s) * step + d) : 0.0f;
  }
}

// f32 kernel 1: the chunk's state sum and decay.  Thread (ty, tx) owns state
// rows 2 ty.. and columns 4 tx.. of the block's 32 x ds tile.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const T* __restrict__ bm,
                 float* __restrict__ states, float* __restrict__ decays,
                 int S, int H, int dh, int ds, int chunk) {
  __shared__ __align__(16) StateSmem sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int d0 = blockIdx.x * kDT, hh = blockIdx.y;
  const int nc = S / chunk, bb = blockIdx.z / nc, ci = blockIdx.z - bb * nc, c0 = ci * chunk;
  const int nd = min(kDT, dh - d0);
  const size_t step = (size_t)H * dh;
  const T* xb = x + (size_t)bb * S * step + (size_t)hh * dh + d0;
  const T* bmb = bm + (size_t)bb * S * ds;

  chunk_la<kThreads>(sm.st, dt + (size_t)bb * S * H + hh, c0, chunk, H, a[hh], tid);
  const float la_last = sm.st.la[chunk - 1];
  for (int s = tid; s < chunk; s += kThreads) {
    sm.w[s] = decay(la_last - sm.st.la[s]) * sm.st.dt[s];
  }
  if (blockIdx.x == 0 && tid == 0) decays[(size_t)(bb * H + hh) * nc + ci] = decay(la_last);

  float acc[2][4] = {};
  for (int s0 = 0; s0 < chunk; s0 += kKT) {
    const int ns = min(kKT, chunk - s0);
    __syncthreads();  // the previous tile is consumed, w is written
    load_x(sm.x, xb, step, c0 + s0, ns, nd, tid);
    for (int e = tid; e < kKT * ds; e += kThreads) {
      const int s = e / ds, p = e - s * ds;
      sm.b[s * kMaxDS + p] = s < ns ? load(bmb + (size_t)(c0 + s0 + s) * ds + p) : 0.0f;
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      const float w = sm.w[s0 + s];
      const float2 xv = *reinterpret_cast<const float2*>(&sm.x[s * kDT + ty * 2]);
      const float4 bv = *reinterpret_cast<const float4*>(&sm.b[s * kMaxDS + tx * 4]);
      const float xw[2] = {xv.x * w, xv.y * w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(xw[r], b4[k], acc[r][k]);
    }
  }
  float* out = states + ((size_t)(bb * H + hh) * nc + ci) * dh * ds;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int d = ty * 2 + r, p = tx * 4 + k;
      if (d < nd && p < ds) out[(size_t)(d0 + d) * ds + p] = acc[r][k];
    }
}

// f32 kernel 3: the chunk's output from the state at its start.  Scores:
// rows 4 ty.., keys 4 tx..; output: rows 4 ty.., columns 2 tx..
template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
ssm_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                  const float* __restrict__ a, const T* __restrict__ bm,
                  const T* __restrict__ cm, const float* __restrict__ states,
                  T* __restrict__ y, int S, int H, int dh, int ds, int chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int d0 = blockIdx.x * kDT, hh = blockIdx.y;
  const int nc = S / chunk, bb = blockIdx.z / nc, ci = blockIdx.z - bb * nc, c0 = ci * chunk;
  const int nd = min(kDT, dh - d0);
  const size_t step = (size_t)H * dh;
  const T* xb = x + (size_t)bb * S * step + (size_t)hh * dh + d0;
  T* yb = y + (size_t)bb * S * step + (size_t)hh * dh + d0;
  const T* bmb = bm + (size_t)bb * S * ds;
  const T* cmb = cm + (size_t)bb * S * ds;

  const float* h0 = states + ((size_t)(bb * H + hh) * nc + ci) * dh * ds + (size_t)d0 * ds;
  for (int e = tid; e < kMaxDS * kDT; e += kThreads) {
    const int p = e >> 5, d = e & 31;
    sm.ht[e] = (p < ds && d < nd) ? h0[(size_t)d * ds + p] : 0.0f;
  }
  chunk_la<kThreads>(sm.st, dt + (size_t)bb * S * H + hh, c0, chunk, H, a[hh], tid);
  const float* la = sm.st.la;

  const int nq = (chunk + kQT - 1) / kQT;
  for (int qi = 0; qi < nq; ++qi) {
    const int t0 = qi * kQT;
    const int nt = min(kQT, chunk - t0);
    for (int e = tid; e < kQT * ds; e += kThreads) {
      const int t = e / ds, p = e - t * ds;
      sm.ct[p * kPad + t] = t < nt ? load(cmb + (size_t)(c0 + t0 + t) * ds + p) : 0.0f;
    }
    __syncthreads();

    // The inter-chunk term: g(la_t) C_t . h.
    float acc[4][2];
    {
      float sum[4][2] = {};
      for (int p = 0; p < ds; ++p) {
        const float4 cv = *reinterpret_cast<const float4*>(&sm.ct[p * kPad + ty * 4]);
        const float2 hv = *reinterpret_cast<const float2*>(&sm.ht[p * kDT + tx * 2]);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sum[i][0] = fmaf(c4[i], hv.x, sum[i][0]);
          sum[i][1] = fmaf(c4[i], hv.y, sum[i][1]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int t = t0 + ty * 4 + i;
        const float g = t < chunk ? decay(la[t]) : 0.0f;
        acc[i][0] = g * sum[i][0];
        acc[i][1] = g * sum[i][1];
      }
    }

    for (int kj = 0; kj <= qi; ++kj) {
      const int s0 = kj * kKT;
      const int ns = min(kKT, chunk - s0);
      load_x(sm.x, xb, step, c0 + s0, ns, nd, tid);
      for (int e = tid; e < kKT * ds; e += kThreads) {
        const int s = e / ds, p = e - s * ds;
        sm.bt[p * kPad + s] = s < ns ? load(bmb + (size_t)(c0 + s0 + s) * ds + p) : 0.0f;
      }
      __syncthreads();

      // Scores (C_q B_k^T) for rows 4 ty.., keys 4 tx..
      float sc[4][4] = {};
#pragma unroll 4
      for (int p = 0; p < ds; ++p) {
        const float4 cv = *reinterpret_cast<const float4*>(&sm.ct[p * kPad + ty * 4]);
        const float4 bv = *reinterpret_cast<const float4*>(&sm.bt[p * kPad + tx * 4]);
        const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
        const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(c4[i], b4[j], sc[i][j]);
      }
      // Times the decay and dt_s; exactly 0 above the diagonal.
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int s = s0 + tx * 4 + j;
        float v[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + ty * 4 + i;
          v[i] = (s <= t && t < chunk) ? sc[i][j] * decay(la[t] - la[s]) * sm.st.dt[s] : 0.0f;
        }
        *reinterpret_cast<float4*>(&sm.sc[(tx * 4 + j) * kPad + ty * 4]) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
      __syncthreads();

      // y += S x over this tile's keys, in key order.
      for (int s = 0; s < ns; ++s) {
        const float4 sv = *reinterpret_cast<const float4*>(&sm.sc[s * kPad + ty * 4]);
        const float2 xv = *reinterpret_cast<const float2*>(&sm.x[s * kDT + tx * 2]);
        const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(s4[i], xv.x, acc[i][0]);
          acc[i][1] = fmaf(s4[i], xv.y, acc[i][1]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = t0 + ty * 4 + i;
      if (t >= chunk) continue;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int d = tx * 2 + j;
        if (d < nd) store(yb + (size_t)(c0 + t) * step + d, acc[i][j]);
      }
    }
  }
}

// Kernel 2 (both instances): h <- g_c h + S_c over the chunks in order,
// and the final state to h_out.  One thread per state element of one
// (b, h); the S_c of the next kCarryAhead chunks are loaded before they
// are updated, so their loads overlap.  The state at each chunk's start
// goes over S_c in f32 (the f32 instance), or, as its kOutPieces bf16
// pieces, to `pieces` (B, H, chunks, kOutPieces, dh, ds) for kernel 3's
// tensor cores (the bf16 instance).
constexpr int kCarryAhead = 8;

template <bool kPieced>
__global__ void __launch_bounds__(kThreads)
ssm_carry_kernel(float* __restrict__ states, const float* __restrict__ decays,
                 float* __restrict__ h_out, __nv_bfloat16* __restrict__ pieces, int nc,
                 int per_slice, int blocks_per_slice) {
  const size_t slice = blockIdx.x / blocks_per_slice;
  const int e = (blockIdx.x - (int)slice * blocks_per_slice) * kThreads + threadIdx.x;
  if (e >= per_slice) return;
  float* st = states + slice * nc * per_slice + e;
  __nv_bfloat16* pc = pieces + slice * nc * kOutPieces * per_slice + e;
  const float* g = decays + slice * nc;
  float h = 0.0f;
  for (int c0 = 0; c0 < nc; c0 += kCarryAhead) {
    float s[kCarryAhead];
#pragma unroll
    for (int i = 0; i < kCarryAhead; ++i) {
      if (c0 + i < nc) s[i] = st[(size_t)(c0 + i) * per_slice];
    }
#pragma unroll
    for (int i = 0; i < kCarryAhead; ++i) {
      if (c0 + i < nc) {
        if constexpr (kPieced) {
          float r = h;
#pragma unroll
          for (int q = 0; q < kOutPieces; ++q) {
            const __nv_bfloat16 v = __float2bfloat16(r);
            pc[((size_t)(c0 + i) * kOutPieces + q) * per_slice] = v;
            r -= __bfloat162float(v);
          }
        } else {
          st[(size_t)(c0 + i) * per_slice] = h;
        }
        h = fmaf(g[c0 + i], h, s[i]);
      }
    }
  }
  h_out[slice * per_slice + e] = h;
}

// ------------------------------------------------------------ bf16: mma

// v as P bf16 pieces, for two values at once: p[i] packs piece i of x
// (low half) and of y.  v - (p0 + ... + p(i-1)) is exact in f32, so the
// pieces sum to v to 2^-8P |v| (exactly for P = 3); a NaN or inf v
// gives NaN pieces after the first.
template <int P>
__device__ __forceinline__ void split(float x, float y, uint32_t (&p)[P]) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    p[i] = tc::pack_bf16(x, y);
    x -= tc::low_bf16(p[i]);
    y -= tc::high_bf16(p[i]);
  }
}

// d = the sum of the products of A's pieces with B, smallest piece
// first, from zero: one accumulator run.
template <int P>
__device__ __forceinline__ void mma_pieces_a(float (&d)[4], const uint32_t (&a)[P][4], uint32_t b0,
                                             uint32_t b1) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
#pragma unroll
  for (int i = P - 1; i >= 0; --i) tc::mma_bf16(d, a[i], b0, b1);
}

// The same with B in pieces and A exact.
template <int P>
__device__ __forceinline__ void mma_pieces_b(float (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b0)[P], const uint32_t (&b1)[P]) {
  d[0] = d[1] = d[2] = d[3] = 0.0f;
#pragma unroll
  for (int i = P - 1; i >= 0; --i) tc::mma_bf16(d, a, b0[i], b1[i]);
}

// g(u) = exp(clip(u, -60, 0)) by the special-function unit's 2^x, for
// kernel 3's scores and inter-chunk term: relative error about 2^-22 plus
// |u| 2^-24 (the rounding of u log2 e), within the bar's 2^-20 max|la|.
__device__ __forceinline__ float decay_fast(float u) {
  return tc::ex2(fminf(fmaxf(u, -60.0f), 0.0f) * kLog2e);
}

__device__ __forceinline__ void add4(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// The ROWS x cols tile at src (row stride ld elements) into shared memory
// at dst (row stride dstride): element (r, c) for r < nr and c < nc, zero
// elsewhere.  With vec, every row start is 16-byte aligned and nc and
// cols are whole 16-byte chunks: 16-byte cp.async copies.  Otherwise
// (odd dh or ds) element by element.  E is the element's storage type
// (unsigned short for bf16).
template <typename E>
__device__ __forceinline__ void load_tile(E* dst, int dstride, const E* __restrict__ src,
                                          size_t ld, int rows, int cols, int nr, int nc, bool vec,
                                          int tid) {
  constexpr int kV = 16 / sizeof(E);
  if (vec) {
    const int per_row = cols / kV;
    for (int i = tid; i < rows * per_row; i += kMmaThreads) {
      const int r = i / per_row, c = (i - r * per_row) * kV;
      const bool ok = r < nr && c < nc;
      tc::cp_async16(tc::smem_addr(dst + r * dstride + c), ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = tid; i < rows * cols; i += kMmaThreads) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dstride + c] = (r < nr && c < nc) ? src[r * ld + c] : E(0);
    }
  }
}

// vec flags: bit 0, x's rows (dh % 8 == 0); bit 1, the rows of B, C and
// h's pieces (ds % 8 == 0); each with 16-byte aligned pointers.
constexpr int kVecX = 1, kVecBC = 2;

struct StateMmaSmem {
  Steps st;
  float w[kMaxChunk];                       // g(la_last - la_s) dt_s
  unsigned short b[2][kKT * kSP];           // B key tiles, [s][p]
  unsigned short x[2][kKT * kXW];           // x key tiles, [s][d]
  unsigned short piece[kStatePieces][kKT * kSP];  // pieces of w_s B[s][p]
};

// Kernel 1, bf16: S_c[d][p] = sum_s x[s][d] (w_s B[s][p]) as x^T (exact)
// times the pieces of w B, over runs of 16 keys.
__global__ void __launch_bounds__(kMmaThreads, 2)
ssm_state_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
                     float* __restrict__ states, float* __restrict__ decays, int S, int H, int dh,
                     int ds, int chunk, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateMmaSmem& sm = *reinterpret_cast<StateMmaSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = blockIdx.x * kStateD, hh = blockIdx.y;
  const int nc = S / chunk, bb = blockIdx.z / nc, ci = blockIdx.z - bb * nc, c0 = ci * chunk;
  const int nd = min(kStateD, dh - d0);
  const int dsp = (ds + 15) & ~15;  // ds padded to whole mma k-steps / n-tile pairs
  const size_t step = (size_t)H * dh;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) +
                             ((size_t)bb * S + c0) * step + (size_t)hh * dh + d0;
  const unsigned short* bmb =
      reinterpret_cast<const unsigned short*>(bm) + ((size_t)bb * S + c0) * ds;
  const int tiles = (chunk + kKT - 1) / kKT;

  auto issue = [&](int kt) {
    const int s0 = kt * kKT, ns = min(kKT, chunk - s0);
    load_tile(sm.b[kt & 1], kSP, bmb + (size_t)s0 * ds, ds, kKT, dsp, ns, ds, vec & kVecBC, tid);
    load_tile(sm.x[kt & 1], kXW, xb + (size_t)s0 * step, step, kKT, kStateD, ns, nd, vec & kVecX,
              tid);
  };
  issue(0);
  tc::cp_async_commit();
  chunk_la<kMmaThreads>(sm.st, dt + (size_t)bb * S * H + hh, c0, chunk, H, a[hh], tid);
  const float la_last = sm.st.la[chunk - 1];
  for (int s = tid; s < chunk; s += kMmaThreads) {
    sm.w[s] = decay(la_last - sm.st.la[s]) * sm.st.dt[s];
  }
  if (blockIdx.x == 0 && tid == 0) decays[(size_t)(bb * H + hh) * nc + ci] = decay(la_last);

  float acc[3][8][4];
#pragma unroll
  for (int mi = 0; mi < 3; ++mi) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nt][e] = 0.0f;
    }
  }
  const int mtiles = (nd + 15) >> 4;
  const int pairs = dsp >> 4;  // pairs of 8-column n-tiles of the state
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) issue(kt + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile kt has landed ...
    __syncthreads();         // ... for every thread; w is written
    const int s0 = kt * kKT;
    const unsigned short* bt = sm.b[kt & 1];
    for (int e = tid; e < kKT * kMaxDS / 2; e += kMmaThreads) {
      const int s = e / (kMaxDS / 2), p = e % (kMaxDS / 2) * 2;
      if (p >= dsp) continue;
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(bt + s * kSP + p);
      const float wv = s0 + s < chunk ? sm.w[s0 + s] : 0.0f;
      uint32_t pc[kStatePieces];
      split(wv * tc::low_bf16(raw), wv * tc::high_bf16(raw), pc);
#pragma unroll
      for (int i = 0; i < kStatePieces; ++i) {
        *reinterpret_cast<uint32_t*>(&sm.piece[i][s * kSP + p]) = pc[i];
      }
    }
    __syncthreads();
    const unsigned short* xt = sm.x[kt & 1];
    const int steps = min(kKT, chunk - s0) / kRun;
    for (int kk = 0; kk < steps; ++kk) {
      // B fragments (16 keys x 8 state columns) of every piece and n-tile.
      uint32_t bp[8][2][kStatePieces];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (j < pairs) {
#pragma unroll
          for (int i = 0; i < kStatePieces; ++i) {
            uint32_t r[4];
            tc::ldmatrix_x4_trans(
                r, tc::smem_addr(&sm.piece[i][(kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kSP +
                                              j * 16 + (lane >> 4) * 8]));
            bp[2 * j][0][i] = r[0];
            bp[2 * j][1][i] = r[1];
            bp[2 * j + 1][0][i] = r[2];
            bp[2 * j + 1][1][i] = r[3];
          }
        }
      }
#pragma unroll
      for (int mi = 0; mi < 3; ++mi) {
        const int m = warp + 4 * mi;
        if (m < mtiles) {
          // A fragment of x^T: rows d = 16 m.., columns s = 16 kk..
          uint32_t af[4];
          const int row = kk * 16 + (lane & 7) + (lane >> 4) * 8;
          tc::ldmatrix_x4_trans(af, tc::smem_addr(xt + row * kXW + m * 16 + ((lane >> 3) & 1) * 8));
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (nt < 2 * pairs) {
              float d[4];
              mma_pieces_b(d, af, bp[nt][0], bp[nt][1]);
              add4(acc[mi][nt], d);
            }
          }
        }
      }
    }
    __syncthreads();  // tile kt and the pieces are read before they are overwritten
  }

  float* out = states + ((size_t)(bb * H + hh) * nc + ci) * dh * ds;
#pragma unroll
  for (int mi = 0; mi < 3; ++mi) {
    const int m = warp + 4 * mi;
    if (m >= mtiles) continue;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const int d = d0 + m * 16 + (lane >> 2) + h2 * 8;
        const int p = nt * 8 + (lane & 3) * 2;
        if (d < dh && p + 1 < ds && (ds & 1) == 0) {
          *reinterpret_cast<float2*>(out + (size_t)d * ds + p) =
              make_float2(acc[mi][nt][2 * h2], acc[mi][nt][2 * h2 + 1]);
        } else if (d < dh) {
          if (p < ds) out[(size_t)d * ds + p] = acc[mi][nt][2 * h2];
          if (p + 1 < ds) out[(size_t)d * ds + p + 1] = acc[mi][nt][2 * h2 + 1];
        }
      }
    }
  }
}

// Kernel 3's shared memory, for 8 NT columns of dh per block: the steps,
// the C query tile [64][kSP], stage 0 of the key ring (B [64][kSP], x
// [64][XS]), and a region that holds h's pieces ([kOutPieces][DT][kSP])
// for the inter-chunk term and then stage 1.
template <int NT>
struct OutMma {
  static_assert(NT % 2 == 0, "n-tiles go in pairs");
  static constexpr int DT = 8 * NT;
  static constexpr int XS = DT + 8;       // NT + 1 chunks a row: odd
  static constexpr size_t kTileB = (size_t)kKT * kSP * 2;
  static constexpr size_t kStage = kTileB + (size_t)kKT * XS * 2;
  static constexpr size_t kHTile = (size_t)DT * kSP * 2;
  static constexpr size_t kH = kOutPieces * kHTile;
  static constexpr size_t kRegion = kStage > kH ? kStage : kH;
  static constexpr size_t kC = (size_t)kQT * kSP * 2;
  static constexpr size_t kSmem = sizeof(Steps) + kC + kStage + kRegion;
};

// Kernel 3, bf16.
template <int NT>
__global__ void __launch_bounds__(kMmaThreads, 2)
ssm_output_mma_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
                      const __nv_bfloat16* __restrict__ cm, const __nv_bfloat16* __restrict__ hp,
                      __nv_bfloat16* __restrict__ y, int S, int H, int dh, int ds, int chunk,
                      int vec) {
  using L = OutMma<NT>;
  constexpr int P = kOutPieces;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Steps& st = *reinterpret_cast<Steps*>(smem_raw);
  unsigned short* cs = reinterpret_cast<unsigned short*>(smem_raw + sizeof(Steps));
  unsigned char* stage0 = smem_raw + sizeof(Steps) + L::kC;
  unsigned char* region = stage0 + L::kStage;
  unsigned short* hs = reinterpret_cast<unsigned short*>(region);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nqt = (chunk + kQT - 1) / kQT;
  const int qi = nqt - 1 - (int)(blockIdx.x % nqt);  // longest rows first
  const int d0 = (int)(blockIdx.x / nqt) * L::DT;
  const int hh = blockIdx.y;
  const int nc = S / chunk, bb = blockIdx.z / nc, ci = blockIdx.z - bb * nc, c0 = ci * chunk;
  const int t0 = qi * kQT;
  const int nd = min(L::DT, dh - d0);
  const int dsp = (ds + 15) & ~15;
  const int ksteps = dsp >> 4;
  const size_t step = (size_t)H * dh;
  const size_t row0 = ((size_t)bb * S + c0) * step + (size_t)hh * dh + d0;
  const unsigned short* xb = reinterpret_cast<const unsigned short*>(x) + row0;
  const size_t bc0 = ((size_t)bb * S + c0) * ds;
  const unsigned short* bmb = reinterpret_cast<const unsigned short*>(bm) + bc0;
  const unsigned short* cmb = reinterpret_cast<const unsigned short*>(cm) + bc0;
  const unsigned short* hpb = reinterpret_cast<const unsigned short*>(hp) +
                              ((size_t)(bb * H + hh) * nc + ci) * P * dh * ds + (size_t)d0 * ds;

  auto stage_b = [&](int i) {
    return reinterpret_cast<unsigned short*>(i ? region : stage0);
  };
  auto stage_x = [&](int i) {
    return reinterpret_cast<unsigned short*>((i ? region : stage0) + L::kTileB);
  };
  auto issue = [&](int kt) {
    const int s0 = kt * kKT, ns = min(kKT, chunk - s0);
    load_tile(stage_b(kt & 1), kSP, bmb + (size_t)s0 * ds, ds, kKT, dsp, ns, ds, vec & kVecBC, tid);
    load_tile(stage_x(kt & 1), L::XS, xb + (size_t)s0 * step, step, kKT, L::DT, ns, nd,
              vec & kVecX, tid);
  };
  load_tile(cs, kSP, cmb + (size_t)t0 * ds, ds, kQT, dsp, min(kQT, chunk - t0), ds, vec & kVecBC,
            tid);
#pragma unroll
  for (int i = 0; i < P; ++i) {
    load_tile(hs + i * L::DT * kSP, kSP, hpb + (size_t)i * dh * ds, ds, L::DT, dsp, nd, ds,
              vec & kVecBC, tid);
  }
  tc::cp_async_commit();
  issue(0);
  tc::cp_async_commit();
  chunk_la<kMmaThreads>(st, dt + (size_t)bb * S * H + hh, c0, chunk, H, a[hh], tid);
  tc::cp_async_wait<1>();  // C and h have landed ...
  __syncthreads();         // ... for every thread

  const int qw = t0 + warp * 16;       // the warp's first row (in the chunk)
  const bool active = qw < chunk;      // warp-uniform: rows past the chunk do nothing
  const int r8 = lane & 7, tq = lane & 3;
  const int qr = qw + (lane >> 2);     // the lane's rows qr and qr + 8
  const float la_q[2] = {qr < chunk ? st.la[qr] : 0.0f, qr + 8 < chunk ? st.la[qr + 8] : 0.0f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  uint32_t ca[4][4];  // the warp's C rows: A fragments over ds
  if (active) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < ksteps) {
        tc::ldmatrix_x4(ca[kk], tc::smem_addr(cs + (warp * 16 + (lane & 15)) * kSP + kk * 16 +
                                              (lane >> 4) * 8));
      }
    }
    // The inter-chunk term g(la_t) C_t . h: B[p][d] = h[d][p], in pieces,
    // over runs of 16 state columns.
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk >= ksteps) continue;
        uint32_t b[P][4];
#pragma unroll
        for (int i = 0; i < P; ++i) {
          tc::ldmatrix_x4(b[i], tc::smem_addr(hs + i * L::DT * kSP +
                                              (np * 16 + r8 + (lane >> 4) * 8) * kSP + kk * 16 +
                                              ((lane >> 3) & 1) * 8));
        }
        float d[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          d[h][0] = d[h][1] = d[h][2] = d[h][3] = 0.0f;
#pragma unroll
          for (int i = P - 1; i >= 0; --i) tc::mma_bf16(d[h], ca[kk], b[i][2 * h], b[i][2 * h + 1]);
        }
        add4(acc[2 * np], d[0]);
        add4(acc[2 * np + 1], d[1]);
      }
    }
    const float g0 = qr < chunk ? decay_fast(la_q[0]) : 0.0f;
    const float g1 = qr + 8 < chunk ? decay_fast(la_q[1]) : 0.0f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= g0;
      acc[n][1] *= g0;
      acc[n][2] *= g1;
      acc[n][3] *= g1;
    }
  }
  __syncthreads();  // h is read: its region becomes stage 1

  for (int kj = 0; kj <= qi; ++kj) {
    if (kj < qi) issue(kj + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile kj has landed ...
    __syncthreads();         // ... for every thread, and tile kj - 1 is read
    const int k0 = kj * kKT;
    if (active) {
      const unsigned short* bt = stage_b(kj & 1);
      const unsigned short* xt = stage_x(kj & 1);
      // Scores C_q B_k^T: the lane's rows qr, qr + 8, keys k0 + 8 j + 2 tq +
      // {0, 1}; 16-key runs past the warp's last row stay 0.
      float sc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (k0 + np * kRun > qw + 15) continue;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (kk < ksteps) {
            uint32_t b[4];
            tc::ldmatrix_x4(b, tc::smem_addr(bt + (np * 16 + r8 + (lane >> 4) * 8) * kSP +
                                             kk * 16 + ((lane >> 3) & 1) * 8));
            tc::mma_bf16(sc[2 * np], ca[kk], b[0], b[1]);
            tc::mma_bf16(sc[2 * np + 1], ca[kk], b[2], b[3]);
          }
        }
      }
      // Times the decay and dt_s; exactly 0 above the diagonal (selected,
      // not multiplied) and past the chunk.  Then the pieces, as the A
      // fragments of the product with x (the C layout of two score n-tiles
      // is the A layout of one 16-key run).
      uint32_t pa[kKT / kRun][P][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int s = k0 + j * 8 + 2 * tq;
        const float2 la_s = *reinterpret_cast<const float2*>(&st.la[s]);
        const float2 dt_s = *reinterpret_cast<const float2*>(&st.dt[s]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = qr + (e >> 1) * 8;
          const float ls = (e & 1) ? la_s.y : la_s.x, ds_ = (e & 1) ? dt_s.y : dt_s.x;
          sc[j][e] = (s + (e & 1) <= t && t < chunk)
                         ? sc[j][e] * decay_fast(la_q[e >> 1] - ls) * ds_ : 0.0f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < kKT / kRun; ++kk) {
        uint32_t q0[P], q1[P], q2[P], q3[P];
        split(sc[2 * kk][0], sc[2 * kk][1], q0);
        split(sc[2 * kk][2], sc[2 * kk][3], q1);
        split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], q2);
        split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], q3);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          pa[kk][i][0] = q0[i];
          pa[kk][i][1] = q1[i];
          pa[kk][i][2] = q2[i];
          pa[kk][i][3] = q3[i];
        }
      }
      // y += P x, one accumulator run per column pair over the tile's 16-key
      // steps in key order (the pieces smallest first), from zero, then
      // added in f32; steps past the warp's last row add nothing and are
      // skipped.
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        float d0[4] = {0.0f, 0.0f, 0.0f, 0.0f}, d1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int kk = 0; kk < kKT / kRun; ++kk) {
          if (k0 + kk * kRun > qw + 15) continue;
          uint32_t b[4];
          const int row = kk * 16 + r8 + ((lane >> 3) & 1) * 8;
          tc::ldmatrix_x4_trans(b, tc::smem_addr(xt + row * L::XS + np * 16 + (lane >> 4) * 8));
#pragma unroll
          for (int i = P - 1; i >= 0; --i) {
            tc::mma_bf16(d0, pa[kk][i], b[0], b[1]);
            tc::mma_bf16(d1, pa[kk][i], b[2], b[3]);
          }
        }
        add4(acc[2 * np], d0);
        add4(acc[2 * np + 1], d1);
      }
    }
    __syncthreads();  // tile kj is read before the next issue overwrites its stage
  }

  if (!active) return;
  __nv_bfloat16* yb = y + row0;
  const bool pairs = (dh & 1) == 0;  // (row, even column) is then 4-byte aligned
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = qr + i * 8;
    if (t >= chunk) continue;
    __nv_bfloat16* yr = yb + (size_t)t * step;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * tq;
      if (pairs && d + 1 < nd) {
        *reinterpret_cast<__nv_bfloat162*>(yr + d) =
            __floats2bfloat162_rn(acc[n][2 * i], acc[n][2 * i + 1]);
      } else {
        if (d < nd) yr[d] = __float2bfloat16(acc[n][2 * i]);
        if (d + 1 < nd) yr[d + 1] = __float2bfloat16(acc[n][2 * i + 1]);
      }
    }
  }
}

template <int NT>
int launch_output_mma(const void* x, const void* dt, const void* a, const void* bm,
                      const void* cm, const void* hp, void* y, int B, int S, int H, int dh,
                      int ds, int chunk, int vec, cudaStream_t s) {
  using L = OutMma<NT>;
  const auto kernel = ssm_output_mma_kernel<NT>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nc = S / chunk;
  const dim3 grid(((chunk + kQT - 1) / kQT) * ((dh + L::DT - 1) / L::DT), H, B * nc);
  kernel<<<grid, kMmaThreads, L::kSmem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(a), static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), static_cast<const __nv_bfloat16*>(hp),
      static_cast<__nv_bfloat16*>(y), S, H, dh, ds, chunk, vec);
  return static_cast<int>(cudaGetLastError());
}

template <bool kPieced>
int launch_carry(float* states, const float* decays, float* h_out, void* pieces, int B, int H,
                 int nc, int dh, int ds, cudaStream_t s) {
  const int per_slice = dh * ds;
  const int blocks = (per_slice + kThreads - 1) / kThreads;
  ssm_carry_kernel<kPieced><<<(unsigned)(B * H) * blocks, kThreads, 0, s>>>(
      states, decays, h_out, static_cast<__nv_bfloat16*>(pieces), nc, per_slice, blocks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           void* y, void* h_out, void* states, void* decays, void* pieces, int B, int S, int H,
           int dh, int ds, int chunk, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh < 1 || ds < 1 || ds > kMaxDS || chunk < 16 ||
      chunk > kMaxChunk || chunk % 16 != 0 || S % chunk != 0 || H > 65535 ||
      (long long)B * (S / chunk) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = S / chunk;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  float* st = static_cast<float*>(states);
  float* dc = static_cast<float*>(decays);
  float* ho = static_cast<float*>(h_out);
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    const int out_smem = static_cast<int>(sizeof(OutSmem));
    err = cudaFuncSetAttribute(ssm_output_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int tiles = (dh + kDT - 1) / kDT;
    const T* xt = static_cast<const T*>(x);
    const T* bt = static_cast<const T*>(bm);
    ssm_state_kernel<T><<<dim3(tiles, H, B * nc), kThreads, 0, s>>>(xt, dtf, af, bt, st, dc, S,
                                                                     H, dh, ds, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int rc = launch_carry<false>(st, dc, ho, nullptr, B, H, nc, dh, ds, s);
    if (rc != 0) return rc;
    ssm_output_kernel<T><<<dim3(tiles, H, B * nc), kThreads, out_smem, s>>>(
        xt, dtf, af, bt, static_cast<const T*>(cm), st, static_cast<T*>(y), S, H, dh, ds, chunk);
    return static_cast<int>(cudaGetLastError());
  } else {
    const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
    const int vec = (aligned(x) && dh % 8 == 0 ? kVecX : 0) |
                    (aligned(bm) && aligned(cm) && aligned(pieces) && ds % 8 == 0 ? kVecBC : 0);
    const int state_smem = static_cast<int>(sizeof(StateMmaSmem));
    err = cudaFuncSetAttribute(ssm_state_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               state_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssm_state_mma_kernel<<<dim3((dh + kStateD - 1) / kStateD, H, B * nc), kMmaThreads, state_smem,
                           s>>>(static_cast<const __nv_bfloat16*>(x), dtf, af,
                                static_cast<const __nv_bfloat16*>(bm), st, dc, S, H, dh, ds,
                                chunk, vec);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int rc = launch_carry<true>(st, dc, ho, pieces, B, H, nc, dh, ds, s);
    if (rc != 0) return rc;
    // The narrowest column tile that covers dh (wider heads take several).
    if (dh <= 32) {
      return launch_output_mma<4>(x, dt, a, bm, cm, pieces, y, B, S, H, dh, ds, chunk, vec, s);
    }
    if (dh <= 80) {
      return launch_output_mma<10>(x, dt, a, bm, cm, pieces, y, B, S, H, dh, ds, chunk, vec, s);
    }
    return launch_output_mma<20>(x, dt, a, bm, cm, pieces, y, B, S, H, dh, ds, chunk, vec, s);
  }
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers: x, dt, a, B, C
// and y as above, h_out (B, H, dh, ds) f32, and the scratch the wrapper
// allocates: states (B, H, S / chunk, dh, ds) f32, decays (B, H, S /
// chunk) f32 and, for bf16 only, pieces (B, H, S / chunk, 2, dh, ds) bf16.
// The launches go on `stream` and do not synchronise.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" {

int ssm_scan_f32(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                 void* y, void* h_out, void* states, void* decays, void* pieces, int B, int S,
                 int H, int dh, int ds, int chunk, void* stream) {
  return launch<float>(x, dt, a, bm, cm, y, h_out, states, decays, pieces, B, S, H, dh, ds,
                       chunk, stream);
}

int ssm_scan_bf16(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                  void* y, void* h_out, void* states, void* decays, void* pieces, int B, int S,
                  int H, int dh, int ds, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, h_out, states, decays, pieces, B, S, H, dh,
                               ds, chunk, stream);
}

}  // extern "C"
