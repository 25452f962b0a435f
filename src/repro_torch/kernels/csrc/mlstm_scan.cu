// mlstm_scan: the chunked, stabilized mLSTM (xLSTM's matrix memory) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_scan/kernel.py
// (mlstm_scan_pallas, body _mlstm_kernel).  Inputs: q, k (B, S, H, dk) and
// v (B, S, H, dv) of one type (f32 or bf16), the gate preactivations
// i_pre, f_pre (B, S, H) f32.  Outputs: y (B, S, H, dv) in q's type and
// the final state C (B, H, dk, dv), n (B, H, dk), m (B, H) in f32; the
// state starts at C = 0, n = 0, m = -1e30.  For one (b, h) and one chunk
// of c steps, with q scaled by 1/sqrt(dk), lf = logsigmoid(f_pre) and F
// the inclusive in-chunk cumulative sum of lf:
//
//   d[t, s] = F_t - F_s + i_s  (s <= t)
//   m_t     = max(max_s d[t, s], F_t + m_prev, -1e30)
//   y_t     = (sum_s (q_t . k_s) e^{d - m_t} v_s + e^{F_t + m_prev - m_t} q_t C_prev)
//             / max(|same with v -> 1 and C -> n|, e^{-m_t})
//   m      <- max(m_prev + F_last, max_s s_log),  s_log = F_last - F_s + i_s
//   C      <- e^{m_prev + F_last - m} C + sum_s e^{s_log - m} k_s v_s^T  (n: v -> 1)
//
// Everything is computed in f32 and y is rounded once to its type.
//
// The TPU grid is (B, H, chunks) with the chunk axis sequential and the
// (dk, dv) state in VMEM.  Here the state alone is 256 KB at dk = dv =
// 256, more than a block's shared memory, and B * H is 4 at xLSTM-350M's
// shape, so one block per head would fill 4 of 132 SMs.  Only the state
// update is sequential, so one call runs three kernels on the stream:
//
//   1. states, one block per (b, h, chunk, 64 columns of dv): the chunk's
//      own state C_c = sum_s e^{s_log - m_c} k_s v_s^T with m_c = max_s
//      s_log (and n_c in the first column tile), F_last and m_c, into
//      scratch.
//   2. carry, one block per (b, h, 1024 state entries), in chunk order:
//      m <- max(m + F_last, m_c), C <- e^{m_old + F_last - m} C +
//      e^{m_c - m} C_c (both exponents <= 0, the same update as the
//      reference's in exact arithmetic); writes the state at each chunk's
//      start over C_c, m at each chunk's start, and the final C, n, m.
//   3. outputs, one block per (b, h, chunk, 64 query rows, 64 columns of
//      dv): y from the state at the chunk's start.  Rows tile by 64 and
//      keys by 64 (a c x c f32 score tile at c = 256 is 256 KB); tiles
//      above the diagonal are skipped and exactly 0 is written above it
//      (no exp of a masked entry, so no -inf - -inf); dk is summed in
//      slices of 32.  m_t and the denominator do not depend on the
//      column tile; each of the ceil(dv / 64) column tiles of a row tile
//      recomputes them with the q . k scores (4x the score work at dk =
//      dv = 256, about 1.5x the call's operations) rather than have a
//      fourth pass write the scores to memory for the others to read.
//      That keeps 2048 blocks in flight at the headline.
//
// Chunks that are multiples of 16 up to 256 run (partial tiles read 0
// and are masked), dk and dv up to 256 each.  Padded steps (i = -1e9,
// f = +1e9: logsigmoid(1e9) = 0 exactly) add nothing to the state; a
// padded row has q = 0, so its y is 0 / max(0, e^{-m_t}) = 0, as in the
// plain version.
//
// What bounds it on an H100 SXM: at (1, 8192, 4, 256), chunk 256, the
// call needs 12.9 GFLOP (the causal half of q k^T and of the scores'
// product with v, q C_prev and the state's k^T v) and moves about 67 MB
// in bf16: 0.020 ms at HBM rate, 0.19 ms at the 67 TFLOP/s f32 CUDA-core
// peak these kernels compute at.  Plain SIMT kernels: no tensor cores, no
// TMA, no overlap of a tile's loads with the previous tile's math.
//
// Determinism: no atomics; F is formed in one fixed order (warp 0's lanes
// each sum a run of steps in order, a shuffle scan adds the runs; kernels
// 1 and 3 run the same code); every sum is one chain in a fixed order,
// so y, C, n and m are bit-identical from launch to launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;
constexpr int kMaxDim = 256;     // dk and dv
constexpr int kCols = 64;        // dv columns per block (kernels 1 and 3)
constexpr int kRows = 64;        // query rows per block (kernel 3)
constexpr int kKeys = 64;        // keys per tile (kernel 3)
constexpr int kSlice = 32;       // dk summed in slices of 32 (kernel 3)
constexpr int kSteps = 32;       // steps per tile of kernel 1
constexpr int kPerCarry = 4;     // state entries per thread of kernel 2
// Row stride of the transposed tiles: a multiple of 4 floats keeps the
// float4 reads aligned.
constexpr int kPad = kRows + 4;
constexpr float kNegBig = -1e30f;

struct Gates {
  float li[kMaxChunk];   // i_pre
  float F[kMaxChunk];    // inclusive cumsum of logsigmoid(f_pre)
};

struct StateSmem {
  Gates g;
  float w[kMaxChunk];              // e^{s_log - m_c}
  float k[kSteps * kMaxDim];       // k step tile, [s][d]
  float v[kSteps * kCols];         // w_s v step tile, [s][j]
  float red[kThreads / 32];
};

struct OutSmem {
  Gates g;
  float mrow[kRows];               // m_t of the block's rows
  float winter[kRows];             // e^{F_t + m_prev - m_t}
  float nprev[kSlice];             // a slice of n at the chunk's start
  float qt[kSlice * kPad];         // q slice, transposed: [d][t]
  float kt[kSlice * kPad];         // k slice, transposed: [d][s]; or C slice [d][j]
  float sc[kKeys * kPad];          // weighted scores, transposed: [s][t]
  float v[kKeys * kCols];          // v key tile, [s][j]
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

// logsigmoid(x) = min(x, 0) - log1p(e^{-|x|}): no overflow for either
// sign, and exactly 0 at x = 1e9 (the padding's forget gate).
__device__ __forceinline__ float logsigmoid(float x) {
  return fminf(x, 0.0f) - log1pf(expf(-fabsf(x)));
}

// Loads the chunk's gates (b, h, steps c0..c0+chunk-1) and forms F.  Lane
// l of warp 0 sums steps [l per, (l + 1) per) in order; a shuffle scan
// then adds the sums of the lanes before it.  Called by every thread;
// ends with a barrier.
__device__ __forceinline__ void chunk_gates(Gates& g, const float* __restrict__ ib,
                                            const float* __restrict__ fb, int c0, int chunk,
                                            int H, int tid) {
  for (int s = tid; s < chunk; s += kThreads) {
    g.li[s] = __ldg(ib + (size_t)(c0 + s) * H);
    g.F[s] = logsigmoid(__ldg(fb + (size_t)(c0 + s) * H));
  }
  __syncthreads();
  if (tid < 32) {
    const int per = (chunk + 31) >> 5;
    const int lo = min(chunk, tid * per), hi = min(chunk, lo + per);
    float run = 0.0f;
    for (int s = lo; s < hi; ++s) {
      run = __fadd_rn(run, g.F[s]);
      g.F[s] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, off);
      if (tid >= off) incl = __fadd_rn(incl, v);
    }
    const float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (tid > 0) {
      for (int s = lo; s < hi; ++s) g.F[s] = __fadd_rn(before, g.F[s]);
    }
  }
  __syncthreads();
}

// Kernel 1: the chunk's own state.  Thread (ty, tx) owns state rows
// ty + 16 r (r < 16) and columns 4 tx.. of the block's dk x 64 tile; in
// the first column tile, thread d < dk also sums n_c[d].
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_state_kernel(const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ ip, const float* __restrict__ fp,
                   float* __restrict__ states, float* __restrict__ f_last,
                   float* __restrict__ m_loc, int S, int H, int dk, int dv, int chunk) {
  __shared__ __align__(16) StateSmem sm;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int j0 = blockIdx.x * kCols;
  const int nc = S / chunk;
  const int bhc = blockIdx.y;                 // (b * H + h) * nc + ci
  const int bh = bhc / nc, ci = bhc - bh * nc, bb = bh / H, hh = bh - bb * H;
  const int c0 = ci * chunk;
  const int nj = min(kCols, dv - j0);
  const T* kb = k + ((size_t)bb * S * H + hh) * dk;
  const T* vb = v + ((size_t)bb * S * H + hh) * dv + j0;
  const size_t kstep = (size_t)H * dk, vstep = (size_t)H * dv;

  chunk_gates(sm.g, ip + (size_t)bb * S * H + hh, fp + (size_t)bb * S * H + hh, c0, chunk, H,
              tid);
  const float fl = sm.g.F[chunk - 1];
  // m_c = max_s s_log; a max is exact in any order.
  float s_log = -CUDART_INF_F;
  if (tid < chunk) s_log = __fadd_rn(__fsub_rn(fl, sm.g.F[tid]), sm.g.li[tid]);
  float mx = s_log;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((tid & 31) == 0) sm.red[tid >> 5] = mx;
  __syncthreads();
  float mc = sm.red[0];
#pragma unroll
  for (int i = 1; i < kThreads / 32; ++i) mc = fmaxf(mc, sm.red[i]);
  if (tid < chunk) sm.w[tid] = expf(s_log - mc);
  if (blockIdx.x == 0 && tid == 0) {
    f_last[bhc] = fl;
    m_loc[bhc] = mc;
  }

  const bool with_n = blockIdx.x == 0 && tid < dk;
  float acc[16][4] = {};
  float nacc = 0.0f;
  for (int s0 = 0; s0 < chunk; s0 += kSteps) {
    const int ns = min(kSteps, chunk - s0);
    __syncthreads();  // the previous tile is consumed, w is written
    for (int e = tid; e < kSteps * kMaxDim; e += kThreads) {
      const int s = e / kMaxDim, d = e - s * kMaxDim;
      sm.k[e] = (s < ns && d < dk) ? load(kb + (size_t)(c0 + s0 + s) * kstep + d) : 0.0f;
    }
    for (int e = tid; e < kSteps * kCols; e += kThreads) {
      const int s = e / kCols, j = e - s * kCols;
      sm.v[e] = (s < ns && j < nj) ? sm.w[s0 + s] * load(vb + (size_t)(c0 + s0 + s) * vstep + j)
                                   : 0.0f;
    }
    __syncthreads();
    for (int s = 0; s < ns; ++s) {
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[s * kCols + tx * 4]);
      const float* kr = &sm.k[s * kMaxDim];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float kd = kr[ty + 16 * r];
        acc[r][0] = fmaf(kd, vv.x, acc[r][0]);
        acc[r][1] = fmaf(kd, vv.y, acc[r][1]);
        acc[r][2] = fmaf(kd, vv.z, acc[r][2]);
        acc[r][3] = fmaf(kd, vv.w, acc[r][3]);
      }
      if (with_n) nacc = fmaf(sm.w[s0 + s], kr[tid], nacc);
    }
  }
  float* out = states + (size_t)bhc * ((size_t)dk * dv + dk);
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int d = ty + 16 * r;
    if (d >= dk) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx * 4 + c;
      if (j < nj) out[(size_t)d * dv + j0 + j] = acc[r][c];
    }
  }
  if (with_n) out[(size_t)dk * dv + tid] = nacc;
}

// Kernel 2: the carry over the chunks in order.  Entries e < dk dv of a
// slice are C's, the dk after them n's.
__global__ void __launch_bounds__(kThreads)
mlstm_carry_kernel(float* __restrict__ states, const float* __restrict__ f_last,
                   const float* __restrict__ m_loc, float* __restrict__ m_start,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, int nc, int dk, int dv) {
  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const size_t cells = (size_t)dk * dv, entries = cells + dk;
  const size_t e0 = (size_t)blockIdx.x * kThreads * kPerCarry + tid;
  const bool lead = blockIdx.x == 0 && tid == 0;
  float cur[kPerCarry] = {};
  float m = kNegBig;
  for (int ci = 0; ci < nc; ++ci) {
    const size_t slot = (size_t)bh * nc + ci;
    const float fl = f_last[slot], mc = m_loc[slot];
    const float mo = __fadd_rn(m, fl);
    const float mn = fmaxf(mo, mc);
    const float a = expf(__fsub_rn(mo, mn));
    const float bq = expf(__fsub_rn(mc, mn));
    if (lead) m_start[slot] = m;
    float* st = states + slot * entries;
#pragma unroll
    for (int i = 0; i < kPerCarry; ++i) {
      const size_t e = e0 + (size_t)i * kThreads;
      if (e < entries) {
        const float s = st[e];
        st[e] = cur[i];
        cur[i] = fmaf(a, cur[i], bq * s);
      }
    }
    m = mn;
  }
#pragma unroll
  for (int i = 0; i < kPerCarry; ++i) {
    const size_t e = e0 + (size_t)i * kThreads;
    if (e < cells) {
      c_out[(size_t)bh * cells + e] = cur[i];
    } else if (e < entries) {
      n_out[(size_t)bh * dk + (e - cells)] = cur[i];
    }
  }
  if (lead) m_out[bh] = m;
}

// Kernel 3: the chunk's output from the state at its start.  Thread (ty,
// tx) owns rows 4 ty.. and, for the scores, keys 4 tx..; for y, columns
// 4 tx..
template <typename T>
__global__ void __launch_bounds__(kThreads)
mlstm_output_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ ip, const float* __restrict__ fp,
                    const float* __restrict__ states, const float* __restrict__ m_start,
                    T* __restrict__ y, int B, int S, int H, int dk, int dv, int chunk,
                    float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  OutSmem& sm = *reinterpret_cast<OutSmem*>(smem_raw);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int nc = S / chunk;
  const int ndv = (dv + kCols - 1) / kCols;
  const int nrt = (chunk + kRows - 1) / kRows;
  // Row tiles with the most key tiles come first, so they start first.
  const int jt = blockIdx.x % ndv;
  const int rest = blockIdx.x / ndv;
  const int bhc = rest % (B * H * nc);
  const int qi = nrt - 1 - rest / (B * H * nc);
  const int bh = bhc / nc, ci = bhc - bh * nc, bb = bh / H, hh = bh - bb * H;
  const int c0 = ci * chunk, t0 = qi * kRows, j0 = jt * kCols;
  const int nt = min(kRows, chunk - t0), nj = min(kCols, dv - j0);
  const size_t kstep = (size_t)H * dk, vstep = (size_t)H * dv;
  const T* qb = q + ((size_t)bb * S * H + hh) * dk;
  const T* kb = k + ((size_t)bb * S * H + hh) * dk;
  const T* vb = v + ((size_t)bb * S * H + hh) * dv + j0;
  T* yb = y + ((size_t)bb * S * H + hh) * dv + j0;
  const float* c_prev = states + (size_t)bhc * ((size_t)dk * dv + dk);
  const float* n_prev = c_prev + (size_t)dk * dv;
  const float m_prev = m_start[bhc];

  chunk_gates(sm.g, ip + (size_t)bb * S * H + hh, fp + (size_t)bb * S * H + hh, c0, chunk, H,
              tid);
  const float* F = sm.g.F;
  const float* li = sm.g.li;
  if (tid < nt) {
    const int t = t0 + tid;
    float mx = -CUDART_INF_F;
    for (int s = 0; s <= t; ++s) mx = fmaxf(mx, __fadd_rn(__fsub_rn(F[t], F[s]), li[s]));
    const float inter = __fadd_rn(F[t], m_prev);
    const float mt = fmaxf(fmaxf(mx, inter), kNegBig);
    sm.mrow[tid] = mt;
    sm.winter[tid] = expf(__fsub_rn(inter, mt));
  }

  // The q slice d0..d0+31 of the block's rows, scaled, into qt[d][t].
  auto load_q = [&](int d0) {
    for (int e = tid; e < kRows * kSlice; e += kThreads) {
      const int t = e >> 5, d = e & 31;
      sm.qt[d * kPad + t] = (t < nt && d0 + d < dk)
                                ? load(qb + (size_t)(c0 + t0 + t) * kstep + d0 + d) * scale
                                : 0.0f;
    }
  };

  // The inter-chunk terms q_t C_prev and q_t . n_prev.
  float acc[4][4] = {};
  float den[4] = {};
  for (int d0 = 0; d0 < dk; d0 += kSlice) {
    __syncthreads();  // the previous slice is consumed
    load_q(d0);
    for (int e = tid; e < kSlice * kCols; e += kThreads) {
      const int d = e >> 6, j = e & 63;
      sm.kt[d * kPad + j] = (d0 + d < dk && j < nj) ? c_prev[(size_t)(d0 + d) * dv + j0 + j]
                                                    : 0.0f;
    }
    if (tid < kSlice) sm.nprev[tid] = d0 + tid < dk ? n_prev[d0 + tid] : 0.0f;
    __syncthreads();
#pragma unroll 8
    for (int d = 0; d < kSlice; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(&sm.qt[d * kPad + ty * 4]);
      const float4 cv = *reinterpret_cast<const float4*>(&sm.kt[d * kPad + tx * 4]);
      const float nd = sm.nprev[d];
      const float q4[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(q4[i], cv.x, acc[i][0]);
        acc[i][1] = fmaf(q4[i], cv.y, acc[i][1]);
        acc[i][2] = fmaf(q4[i], cv.z, acc[i][2]);
        acc[i][3] = fmaf(q4[i], cv.w, acc[i][3]);
        den[i] = fmaf(q4[i], nd, den[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float w = r < nt ? sm.winter[r] : 0.0f;
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] *= w;
    den[i] *= w;
  }

  for (int kj = 0; kj <= qi; ++kj) {
    const int s0 = kj * kKeys;
    const int ns = min(kKeys, chunk - s0);
    // Scores q_t . k_s for rows 4 ty.., keys 4 tx.., over dk in slices.
    float sc[4][4] = {};
    for (int d0 = 0; d0 < dk; d0 += kSlice) {
      __syncthreads();
      load_q(d0);
      for (int e = tid; e < kKeys * kSlice; e += kThreads) {
        const int s = e >> 5, d = e & 31;
        sm.kt[d * kPad + s] =
            (s < ns && d0 + d < dk) ? load(kb + (size_t)(c0 + s0 + s) * kstep + d0 + d) : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int d = 0; d < kSlice; ++d) {
        const float4 qv = *reinterpret_cast<const float4*>(&sm.qt[d * kPad + ty * 4]);
        const float4 kv = *reinterpret_cast<const float4*>(&sm.kt[d * kPad + tx * 4]);
        const float q4[4] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          sc[i][0] = fmaf(q4[i], kv.x, sc[i][0]);
          sc[i][1] = fmaf(q4[i], kv.y, sc[i][1]);
          sc[i][2] = fmaf(q4[i], kv.z, sc[i][2]);
          sc[i][3] = fmaf(q4[i], kv.w, sc[i][3]);
        }
      }
    }
    // Times e^{d - m_t}; exactly 0 above the diagonal and past the chunk.
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = s0 + tx * 4 + c;
      float w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i, t = t0 + r;
        w[i] = (s <= t && r < nt && s < chunk)
                   ? sc[i][c] * expf(__fsub_rn(__fadd_rn(__fsub_rn(F[t], F[s]), li[s]),
                                               sm.mrow[r]))
                   : 0.0f;
      }
      *reinterpret_cast<float4*>(&sm.sc[(tx * 4 + c) * kPad + ty * 4]) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    for (int e = tid; e < kKeys * kCols; e += kThreads) {
      const int s = e >> 6, j = e & 63;
      sm.v[e] = (s < ns && j < nj) ? load(vb + (size_t)(c0 + s0 + s) * vstep + j) : 0.0f;
    }
    __syncthreads();

    // y += scores v and den += sum of the scores, over this tile's keys in order.
    for (int s = 0; s < ns; ++s) {
      const float4 sv = *reinterpret_cast<const float4*>(&sm.sc[s * kPad + ty * 4]);
      const float4 vv = *reinterpret_cast<const float4*>(&sm.v[s * kCols + tx * 4]);
      const float s4[4] = {sv.x, sv.y, sv.z, sv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(s4[i], vv.x, acc[i][0]);
        acc[i][1] = fmaf(s4[i], vv.y, acc[i][1]);
        acc[i][2] = fmaf(s4[i], vv.z, acc[i][2]);
        acc[i][3] = fmaf(s4[i], vv.w, acc[i][3]);
        den[i] = __fadd_rn(den[i], s4[i]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (r >= nt) continue;
    const float dd = fmaxf(fabsf(den[i]), expf(-sm.mrow[r]));
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = tx * 4 + c;
      if (j < nj) store(yb + (size_t)(c0 + t0 + r) * vstep + j, acc[i][c] / dd);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ip, const void* fp, void* y,
           void* c_out, void* n_out, void* m_out, void* states, void* scalars, int B, int S,
           int H, int dk, int dv, int chunk, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim ||
      chunk < 16 || chunk > kMaxChunk || chunk % 16 != 0 || S % chunk != 0 ||
      (long long)B * H * (S / chunk) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = S / chunk;
  const int slots = B * H * nc;
  const int out_smem = static_cast<int>(sizeof(OutSmem));
  cudaError_t err = cudaFuncSetAttribute(mlstm_output_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const float* ipf = static_cast<const float*>(ip);
  const float* fpf = static_cast<const float*>(fp);
  float* st = static_cast<float*>(states);
  float* f_last = static_cast<float*>(scalars);
  float* m_loc = f_last + slots;
  float* m_start = m_loc + slots;
  const int ndv = (dv + kCols - 1) / kCols;
  mlstm_state_kernel<T><<<dim3(ndv, slots), kThreads, 0, s>>>(kt, vt, ipf, fpf, st, f_last,
                                                              m_loc, S, H, dk, dv, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const long long entries = (long long)dk * dv + dk;
  const int carry_blocks = static_cast<int>((entries + kThreads * kPerCarry - 1) /
                                            (kThreads * kPerCarry));
  mlstm_carry_kernel<<<dim3(carry_blocks, B * H), kThreads, 0, s>>>(
      st, f_last, m_loc, m_start, static_cast<float*>(c_out), static_cast<float*>(n_out),
      static_cast<float*>(m_out), nc, dk, dv);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int nrt = (chunk + kRows - 1) / kRows;
  mlstm_output_kernel<T><<<dim3(nrt * slots * ndv), kThreads, out_smem, s>>>(
      qt, kt, vt, ipf, fpf, st, m_start, static_cast<T*>(y), B, S, H, dk, dv, chunk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mlstm_scan_f32(const void* q, const void* k, const void* v, const void* ip, const void* fp,
                   void* y, void* c_out, void* n_out, void* m_out, void* states, void* scalars,
                   int B, int S, int H, int dk, int dv, int chunk, float scale, void* stream) {
  return launch<float>(q, k, v, ip, fp, y, c_out, n_out, m_out, states, scalars, B, S, H, dk,
                       dv, chunk, scale, stream);
}

int mlstm_scan_bf16(const void* q, const void* k, const void* v, const void* ip, const void* fp,
                    void* y, void* c_out, void* n_out, void* m_out, void* states, void* scalars,
                    int B, int S, int H, int dk, int dv, int chunk, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, ip, fp, y, c_out, n_out, m_out, states, scalars, B, S,
                               H, dk, dv, chunk, scale, stream);
}

}  // extern "C"
