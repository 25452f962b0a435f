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
// Everything is computed in f32 and y is rounded once to its type.
//
// The TPU grid is (B, H, chunks) with the chunk axis sequential and the
// state in VMEM scratch.  Here nothing carries between blocks, and only
// the state update is sequential: a chunk's state sum and its output
// given the state at its start are independent of the other chunks.  So
// one call runs three kernels on the stream, each over tiles of 32 rows of
// the state (32 of dh: y[:, d] needs only x[:, d] and h[d, :]):
//
//   1. states, one block per (b, h, chunk, 32 rows): the chunk's state sum
//      S_c = sum_s g(la_last - la_s) dt_s x_s (x) B_s and its decay
//      g(la_last), into scratch.
//   2. carry, one block per (b, h, 32 rows), in chunk order: writes the
//      state at each chunk's start over S_c (h <- g h + S_c) and the final
//      state to h_out.
//   3. outputs, one block per (b, h, chunk, 32 rows): y from the state at
//      the chunk's start.
//
// At Zamba2-2.7B's shape (1, 8192, 32, 160), chunk 256, kernels 1 and 3
// have 5 * 32 * 32 = 5120 blocks, kernel 2 has 160.  Kernel 3 recomputes
// the chunk's C B^T products in each of the ceil(dh / 32) blocks of a
// head, which do not depend on d.
//
// Every kernel forms la in one fixed order: warp 0's lanes each sum a run
// of steps in order (each a * dt rounded first), and a shuffle scan adds
// the runs; kernels 1 and 3 run the same code, so they see the same la.
// Kernel 3 tiles the query rows by 64 (the full c x c f32 score tile at
// c = 256 would be 256 KB), starts each row tile from the inter-chunk
// term, and walks the key tiles of 64 up to the diagonal only: scores
// C_q B_k^T (a thread owns 4 x 4), times the decay and dt_s, with exactly
// 0 written for s > t (no exp of a clipped positive difference), go
// through shared memory to the product with x's key tile (a thread owns 4
// rows x 2 columns of y).  Any c that is a multiple of 16 up to 256 runs
// (partial tiles read 0 and are masked), ds up to 64, any dh.  Kernel 3's
// shared memory is 70,656 bytes, so three blocks fit an SM.
//
// What bounds it on an H100 SXM: at (1, 8192, 32, 160), ds 64, chunk 256,
// counting the causal half of the two c^2 products and C B^T once per
// (b, chunk), the call needs 21.7 GFLOP and moves 172 MB in bf16: 0.051 ms
// at HBM rate, 0.32 ms at the 67 TFLOP/s f32 CUDA-core peak these kernels
// compute at.  The scratch (the states, 42 MB in f32, written and read
// twice) adds about 0.05 ms of HBM traffic.  Plain SIMT kernels: no
// tensor cores, no TMA, no overlap of a tile's loads with the previous
// tile's math.
//
// Determinism: no atomics, and every sum is one chain in a fixed order
// (the state sum over the steps in order, the carry over the chunks in
// order, each y element over the state then the keys in order), so y and
// h are bit-identical from launch to launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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
// lanes before it.  Called by every thread; ends with a barrier.
__device__ __forceinline__ void chunk_la(Steps& st, const float* __restrict__ dtb, int c0,
                                         int chunk, int H, float ah, int tid) {
  for (int s = tid; s < chunk; s += kThreads) st.dt[s] = __ldg(dtb + (size_t)(c0 + s) * H);
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

// Kernel 1: the chunk's state sum and decay.  Thread (ty, tx) owns state
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

  chunk_la(sm.st, dt + (size_t)bb * S * H + hh, c0, chunk, H, a[hh], tid);
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

// Kernel 2: h <- g_c h + S_c over the chunks in order, writing the state
// at each chunk's start over S_c and the final state to h_out.  Each
// thread owns up to 8 entries of the block's 32 x ds tile.
__global__ void __launch_bounds__(kThreads)
ssm_carry_kernel(float* __restrict__ states, const float* __restrict__ decays,
                 float* __restrict__ h_out, int nc, int H, int dh, int ds) {
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * kDT, hh = blockIdx.y, bb = blockIdx.z;
  const int rows = min(kDT, dh - d0) * ds;
  const size_t slice = (size_t)(bb * H + hh);
  constexpr int kPer = kDT * kMaxDS / kThreads;
  float h[kPer] = {};
  for (int ci = 0; ci < nc; ++ci) {
    float* st = states + (slice * nc + ci) * dh * ds + (size_t)d0 * ds;
    const float g = decays[slice * nc + ci];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < rows) {
        const float s = st[e];
        st[e] = h[i];
        h[i] = fmaf(g, h[i], s);
      }
    }
  }
  float* out = h_out + slice * dh * ds + (size_t)d0 * ds;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int e = tid + i * kThreads;
    if (e < rows) out[e] = h[i];
  }
}

// Kernel 3: the chunk's output from the state at its start.  Scores:
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
  chunk_la(sm.st, dt + (size_t)bb * S * H + hh, c0, chunk, H, a[hh], tid);
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

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
           void* y, void* h_out, void* states, void* decays, int B, int S, int H, int dh,
           int ds, int chunk, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dh < 1 || ds < 1 || ds > kMaxDS || chunk < 16 ||
      chunk > kMaxChunk || chunk % 16 != 0 || S % chunk != 0 || H > 65535 ||
      (long long)B * (S / chunk) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = S / chunk;
  const int out_smem = static_cast<int>(sizeof(OutSmem));
  cudaError_t err = cudaFuncSetAttribute(ssm_output_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, out_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (dh + kDT - 1) / kDT;
  const T* xt = static_cast<const T*>(x);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const T* bt = static_cast<const T*>(bm);
  float* st = static_cast<float*>(states);
  float* dc = static_cast<float*>(decays);
  ssm_state_kernel<T><<<dim3(tiles, H, B * nc), kThreads, 0, s>>>(xt, dtf, af, bt, st, dc, S, H,
                                                                   dh, ds, chunk);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssm_carry_kernel<<<dim3(tiles, H, B), kThreads, 0, s>>>(st, dc, static_cast<float*>(h_out),
                                                          nc, H, dh, ds);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  ssm_output_kernel<T><<<dim3(tiles, H, B * nc), kThreads, out_smem, s>>>(
      xt, dtf, af, bt, static_cast<const T*>(cm), st, static_cast<T*>(y), S, H, dh, ds, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int ssm_scan_f32(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                 void* y, void* h_out, void* states, void* decays, int B, int S, int H, int dh,
                 int ds, int chunk, void* stream) {
  return launch<float>(x, dt, a, bm, cm, y, h_out, states, decays, B, S, H, dh, ds, chunk,
                       stream);
}

int ssm_scan_bf16(const void* x, const void* dt, const void* a, const void* bm, const void* cm,
                  void* y, void* h_out, void* states, void* decays, int B, int S, int H, int dh,
                  int ds, int chunk, void* stream) {
  return launch<__nv_bfloat16>(x, dt, a, bm, cm, y, h_out, states, decays, B, S, H, dh, ds,
                               chunk, stream);
}

}  // extern "C"
