// mlstm_scan: the chunked, stabilized mLSTM (xLSTM's matrix memory) for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mlstm_scan/kernel.py
// (mlstm_scan_pallas, body _mlstm_kernel).  Inputs: q, k (B, S, H, dk) and
// v (B, S, H, dv) of one type (f32 or bf16), the gate preactivations
// i_pre, f_pre (B, S, H) f32.  Outputs: y (B, S, H, dv) in q's type and
// the final state C (B, H, dk, dv), n (B, H, dk), m (B, H) in f32; the
// state starts at C = 0, n = 0, m = -1e30.  For one (b, h) and one chunk
// of c steps, with the scale 1/sqrt(dk), lf = logsigmoid(f_pre) and F the
// inclusive in-chunk cumulative sum of lf:
//
//   d[t, s] = F_t - F_s + i_s  (s <= t)
//   m_t     = max(max_s d[t, s], F_t + m_prev, -1e30)
//   y_t     = scale (sum_s (q_t . k_s) e^{d - m_t} v_s
//                    + e^{F_t + m_prev - m_t} q_t C_prev)
//             / max(|same with v -> 1 and C -> n|, e^{-m_t})
//   m      <- max(m_prev + F_last, max_s s_log),  s_log = F_last - F_s + i_s
//   C      <- e^{m_prev + F_last - m} C + sum_s e^{s_log - m} k_s v_s^T  (n: v -> 1)
//
// Everything is summed in f32 and y is rounded once to its type.
//
// The TPU grid is (B, H, chunks) with the chunk axis sequential and the
// (dk, dv) state in VMEM.  Here the state alone is 256 KB at dk = dv =
// 256, more than a block's shared memory, and B * H is 4 at xLSTM-350M's
// shape, so one block per head would fill 4 of 132 SMs.  Only the state
// update is sequential, so one call runs three kernels on the stream:
//
//   1. states: each chunk's own state C_c = sum_s e^{s_log - m_c} k_s v_s^T
//      with m_c = max_s s_log, its n_c, F_last and m_c, into scratch.
//   2. carry, one thread per state entry of one (b, h), in chunk order:
//      m <- max(m + F_last, m_c), C <- e^{m_old + F_last - m} C +
//      e^{m_c - m} C_c (both exponents <= 0, the same update as the
//      reference's in exact arithmetic; one fmaf an entry); it loads
//      kCarryAhead chunks' C_c ahead of their updates, writes m at each
//      chunk's start and the final C, n, m, and the state at each chunk's
//      start: over C_c in f32 (f32 instance), or C as its kOutPieces bf16
//      pieces into a second scratch and n in f32 over C_c's n (bf16).
//   3. outputs: y from the state at the chunk's start.
//
// Every kernel forms F in one fixed order (chunk_gates: warp 0's lanes
// each sum a run of steps in order, a shuffle scan adds the runs), so
// kernels 1 and 3 of both instances see the same F.  Chunks that are
// multiples of 16 up to 256 run (partial tiles read 0 and are masked), dk
// and dv up to 256 each, at any alignment (rows that are not whole 16-byte
// chunks are copied element by element).  Padded steps (i = -1e9, f =
// +1e9: logsigmoid(1e9) = 0 exactly) add nothing to the state; a padded
// row has q = 0, so its y is 0 / max(0, e^{-m_t}) = 0, as in the plain
// version.
//
// The bf16 instance runs on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 accumulators, tensor_core.cuh).  q, k and v are bf16, so
// q . k and the products with v are exact; the scale, 1/sqrt(dk) (not a
// power of two at dk = 33 or 128), multiplies the f32 sums, not q.  Each
// f32 factor enters as bf16 pieces, x = p0 + p1 + ... with p0 = bf16(x),
// p1 = bf16(x - p0), ...: each subtraction is exact, so P pieces keep 8 P
// significant bits of x and every product is exact in f32.  The state
// sum's w_s k_s (w_s = e^{s_log - m_c}) takes kStatePieces = 3, all of the
// f32 product the plain version forms (with two, 2^-16 relative, the state
// misses its bar when one weighted step makes an entry); y's factors, the
// weighted scores and the carried state C, take kOutPieces = 2 (y is
// rounded to bf16 and held to 2^-7 of itself).  The tensor cores'
// accumulator does not round to nearest (gram.cuh), so it only ever sums
// one short run from zero, the pieces smallest first, and the runs are
// added in f32: kRun = 16 keys in kernel 1, kDkRun = 64 of dk in the scores
// q . k and the inter-chunk term q C_prev, kKeyRun = 32 keys (a key tile)
// in the scores' product with v.  tests/test_torch_mlstm_split.py reads
// these constants and emulates the arithmetic on the CPU.
//   Kernel 1 (mlstm_state_mma_kernel<NP>): one block of 4 warps per (b, h,
//   chunk, 64 rows of dk, 16 NP columns of dv; NP = 8 at dv > 64); warp w
//   owns 16 rows of dk.  Per 64-key tile the block forms the pieces of w_s
//   k_s[d] in shared memory; their ldmatrix.trans is the A operand ((w
//   k)^T), v's the B.  Each 16-key k-step runs the 2 NP n-tiles' three
//   pieces as independent accumulator chains, so their mmas overlap.  The
//   first column block also sums n_c as one more n-tile whose B operand is
//   all ones.  Key tiles come through a ring of two cp.async stages; the
//   gates come by 4-byte cp.async beside the first tile.
//   Kernel 3 (mlstm_output_mma_kernel<NP>): one block of 4 warps per (b, h,
//   chunk, 64 query rows, 16 NP columns of dv), two blocks an SM (at most
//   255 registers, 88 KB of shared memory at dk = dv = 256); warp w owns 16
//   query rows: 2 NP accumulators of 4 and one run's as many again.  The
//   blocks of one (b, h, chunk) are launched side by side, so C_prev's
//   pieces and the key tiles they share come from L2.  q's tile stays in
//   shared memory and its A fragments are read where they are used: in
//   registers (64 more a thread, at dk = 256) they left room for neither
//   the run accumulators nor a second block.  A ring of two cp.async
//   stages brings first C_prev's pieces in slices of kCSlice rows of dk,
//   then the key tiles (k and v, kKT keys) up to the block's last row.  The
//   inter-chunk term q C_prev comes first, times scale e^{F_t + m_prev -
//   m_t}.  Then, per key tile, the scores q k^T are computed once for all
//   the block's columns (the SIMT instance recomputes them per 64 columns;
//   at dv = 256 the two column blocks of a row compute them twice), times
//   scale e^{d - m_t} in registers, selected as exactly 0 above the
//   diagonal and past the chunk, split, and multiplied with v
//   (ldmatrix.trans) straight from the accumulators (the C layout of the
//   scores is the A layout of the product); a warp skips the tiles past
//   its last row and the 16-key runs past it in P v.  dk is padded with
//   zeros to whole kDkRun runs and every inner loop has a fixed trip
//   count, so the compiler can put a k-step's ldmatrix reads ahead of its
//   mmas.  The weights take the special-function unit's 2^x (relative
//   error about 2^-22 + |u| 2^-24 for a weight e^u, u >= -88 where it is
//   not flushed to 0, inside the bar's 2^-20 max|F|).  m_t = max(F_t +
//   max_{s <= t} (i_s - F_s), F_t + m_prev, -1e30), the prefix max by one
//   warp's scan (another rounding of the same max: the bar's 2^-20 max|F|
//   takes it); q_t . n_prev in f32 by 2 threads a row; den sums, in order,
//   q_t . n_prev's term and each key tile's row sums of the f32 weighted
//   scores (the lanes of a quad combined by shuffles).  A NaN in i_pre or
//   f_pre reaches m, as torch.amax keeps it (max.NaN).
//
// The f32 instance keeps the SIMT kernels (mlstm_state_kernel,
// mlstm_output_kernel): blocks over 64 columns of dv, the q . k scores
// recomputed in each of the ceil(dv / 64) column blocks of a row tile, all
// on the CUDA cores in f32; its results are bit-identical to the earlier
// carry's (the same fmaf per entry).
//
// What bounds it on an H100 SXM: at (1, 8192, 4, 256), chunk 256, the
// call needs 12.9 GFLOP (the causal half of q k^T and of the scores'
// product with v, q C_prev, q . n_prev and the state's k^T v and n) and
// moves about 68 MB in bf16: 0.020 ms at HBM rate, 0.013 ms at the bf16
// tensor-core peak.  The bf16 instance's real tensor-core work, with its
// pieces (3 in the state sum, 2 in P v and q C_prev) and the scores
// computed by two column blocks over whole 32-key tiles, is about 31 GFLOP
// (0.032 ms at 989 TFLOP/s), and its scratch, each chunk's state (34 MB in
// f32) and the carried C's pieces (34 MB in bf16), each written once and
// read once, adds some 135 MB of HBM traffic (0.040 ms).  It reaches
// neither: chip_smoke.py (run 1, NVIDIA H100 80GB HBM3 at 700 W) measured
// 0.275 ms, of which kernel 3 0.163, kernel 1 0.058 and the carry 0.023
// (the earlier SIMT kernels, built in the same run: 1.727 ms, 1.015 +
// 0.289 + 0.251).  Kernel 3 is mma.sync at two blocks of four warps an SM
// waiting on its own latencies, the ring's barriers and, before its first
// product, the gates' scans and the row statistics.  The f32 instance
// computes at the 67 TFLOP/s CUDA-core peak: 0.19 ms (measured 1.517).
//
// Determinism: no atomics; every sum is a fixed sequence of fmaf, f32 adds
// and mmas, and the shuffle reductions give every lane of a quad the same
// value, so y, C, n and m are bit-identical from launch to launch.
//
// Non-finite values (bf16): a NaN in q, k, v, i_pre or f_pre reaches every
// output it enters (a NaN or inf factor's pieces are NaN); a masked score
// is selected as 0, never multiplied, so a NaN in q or k stays in its own
// rows and columns, where the plain version's 0 * NaN also spreads it to
// the rows before it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>
#include <cstdint>

#include "tensor_core.cuh"

namespace {

// The f32 instance.
constexpr int kThreads = 256;
constexpr int kMaxChunk = 256;
constexpr int kMaxDim = 256;     // dk and dv
constexpr int kCols = 64;        // dv columns per block (kernels 1 and 3)
constexpr int kRows = 64;        // query rows per block (kernel 3)
constexpr int kKeys = 64;        // keys per tile (kernel 3)
constexpr int kSlice = 32;       // dk summed in slices of 32 (kernel 3)
constexpr int kSteps = 32;       // steps per tile of kernel 1
// Row stride of the transposed tiles: a multiple of 4 floats keeps the
// float4 reads aligned.
constexpr int kPad = kRows + 4;
constexpr float kNegBig = -1e30f;

// The bf16 instance.
constexpr int kStatePieces = 3;  // bf16 pieces of kernel 1's f32 factor, w_s k_s
constexpr int kOutPieces = 2;    // bf16 pieces of kernel 3's f32 factors, the scores and C_prev
constexpr int kRun = 16;         // keys one kernel-1 accumulator sums from zero: one k-step
constexpr int kDkRun = 64;       // dk one accumulator sums from zero in q . k and q C_prev
constexpr int kKeyRun = 32;      // keys one accumulator sums from zero in P v: a key tile
constexpr int kKT = 32;          // keys per kernel-3 tile
constexpr int kCSlice = 32;      // rows of dk per kernel-3 slice of C_prev's pieces
constexpr int kQT = 64;          // query rows per kernel-3 block, 16 a warp
constexpr int kOutThreads = 128; // kernel 3: 4 warps
constexpr int kStateThreads = 128;  // kernel 1: 4 warps
constexpr int kStateKT = 64;     // keys per kernel-1 tile
constexpr int kStateD = 64;      // rows of dk per kernel-1 block, 16 a warp
constexpr int kMaxPairs = 8;     // n-tile pairs (16 columns of dv) of the widest bf16 blocks
constexpr int kOutStages = 2;    // stages of kernel 3's cp.async ring
constexpr float kLog2e = 1.4426950408889634f;
// Row strides (bf16 elements) of shared tiles read by ldmatrix: an odd
// number of 16-byte chunks, so the 8 rows of a read hit 8 bank groups.
constexpr int kKS1 = kStateD + 8;    // kernel 1's k and piece tiles: [64 keys][64 of dk]
constexpr int kVS1 = 16 * kMaxPairs + 8;  // kernel 1's v tile: [64 keys][<= 128 of dv]
static_assert(kRun == 16 && kKeyRun == kKT && kKT % 16 == 0 && kCSlice % 16 == 0 &&
                  kDkRun % kCSlice == 0,
              "a kernel-1 run is one k-step, a P v run one key tile, a dk run whole C slices");


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

// max(a, b), NaN if either is NaN (fmaxf would drop it), as torch.maximum
// and torch.amax keep a NaN.  Equal to fmaxf for other operands.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;\n" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// Forms F in place from logsigmoid(f_pre) in g.F: lane l of warp 0 sums
// steps [l per, (l + 1) per) in order; a shuffle scan then adds the sums
// of the lanes before it.  Called by all threads; ends with a barrier.
__device__ __forceinline__ void scan_gates(Gates& g, int chunk, int tid) {
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

// Loads the chunk's gates (b, h, steps c0..c0+chunk-1) and forms F.
// Called by all kN threads of the block; ends with a barrier.
template <int kN>
__device__ __forceinline__ void chunk_gates(Gates& g, const float* __restrict__ ib,
                                            const float* __restrict__ fb, int c0, int chunk,
                                            int H, int tid) {
  for (int s = tid; s < chunk; s += kN) {
    g.li[s] = __ldg(ib + (size_t)(c0 + s) * H);
    g.F[s] = logsigmoid(__ldg(fb + (size_t)(c0 + s) * H));
  }
  __syncthreads();
  scan_gates(g, chunk, tid);
}

// f32 kernel 1: the chunk's own state.  Thread (ty, tx) owns state rows
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

  chunk_gates<kThreads>(sm.g, ip + (size_t)bb * S * H + hh, fp + (size_t)bb * S * H + hh, c0,
                        chunk, H, tid);
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

// Kernel 2 (both instances): the carry over the chunks in order.  One
// thread per entry of one (b, h) state, the entries e < dk dv C's and the
// dk after them n's; the C_c of the next kCarryAhead chunks are loaded
// before they are updated, so their loads overlap.  The state at each
// chunk's start goes over C_c in f32 (the f32 instance); in the bf16
// instance C's goes, as its kOutPieces bf16 pieces, to `pieces` (B, H,
// chunks, kOutPieces, dk, dv) for kernel 3's tensor cores, and n's over
// C_c's n in f32.  m at each chunk's start goes to m_start.
constexpr int kCarryAhead = 8;

template <bool kPieced>
__global__ void __launch_bounds__(kThreads)
mlstm_carry_kernel(float* __restrict__ states, const float* __restrict__ f_last,
                   const float* __restrict__ m_loc, float* __restrict__ m_start,
                   float* __restrict__ c_out, float* __restrict__ n_out,
                   float* __restrict__ m_out, __nv_bfloat16* __restrict__ pieces, int nc,
                   int dk, int dv, int blocks_per_slice) {
  const int bh = blockIdx.x / blocks_per_slice;
  const int e = (blockIdx.x - bh * blocks_per_slice) * kThreads + threadIdx.x;
  const int cells = dk * dv, entries = cells + dk;
  if (e >= entries) return;
  float* st = states + (size_t)bh * nc * entries + e;
  const float* fl = f_last + (size_t)bh * nc;
  const float* ml = m_loc + (size_t)bh * nc;
  float cur = 0.0f;
  float m = kNegBig;
  for (int c0 = 0; c0 < nc; c0 += kCarryAhead) {
    float s[kCarryAhead];
#pragma unroll
    for (int i = 0; i < kCarryAhead; ++i) {
      if (c0 + i < nc) s[i] = st[(size_t)(c0 + i) * entries];
    }
#pragma unroll
    for (int i = 0; i < kCarryAhead; ++i) {
      const int ci = c0 + i;
      if (ci < nc) {
        const float mc = ml[ci];
        const float mo = __fadd_rn(m, fl[ci]);
        const float mn = max_nan(mo, mc);
        const float a = expf(__fsub_rn(mo, mn));
        const float bq = expf(__fsub_rn(mc, mn));
        if (e == 0) m_start[(size_t)bh * nc + ci] = m;
        if (kPieced && e < cells) {
          __nv_bfloat16* pc = pieces + ((size_t)bh * nc + ci) * kOutPieces * cells + e;
          float r = cur;
#pragma unroll
          for (int q = 0; q < kOutPieces; ++q) {
            const __nv_bfloat16 p = __float2bfloat16(r);
            pc[(size_t)q * cells] = p;
            r -= __bfloat162float(p);
          }
        } else {
          st[(size_t)ci * entries] = cur;
        }
        cur = fmaf(a, cur, bq * s[i]);
        m = mn;
      }
    }
  }
  if (e < cells) {
    c_out[(size_t)bh * cells + e] = cur;
  } else {
    n_out[(size_t)bh * dk + (e - cells)] = cur;
  }
  if (e == 0) m_out[bh] = m;
}

// f32 kernel 3: the chunk's output from the state at its start.  Thread (ty,
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

  chunk_gates<kThreads>(sm.g, ip + (size_t)bb * S * H + hh, fp + (size_t)bb * S * H + hh, c0,
                        chunk, H, tid);
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

// ------------------------------------------------------------ bf16: mma

// x and y as P bf16 pieces, two values at once: p[i] packs piece i of x
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

__device__ __forceinline__ void add4(float (&acc)[4], const float (&d)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += d[e];
}

// Two bf16 ones: the B operand of kernel 1's n-tile, whose products with
// w_s k_s sum n_c.
constexpr uint32_t kOnes = 0x3f803f80u;

// The rows x cols tile at src (row stride ld elements) into shared memory
// at dst (row stride dstride): element (r, c) for r < nr and c < nc, zero
// elsewhere, by the block's kN threads.  With vec, every row start is
// 16-byte aligned and nc and cols are whole 16-byte chunks: 16-byte
// cp.async copies.  Otherwise (dk or dv not a multiple of 8) element by
// element.
template <int kN>
__device__ __forceinline__ void load_tile(unsigned short* dst, int dstride,
                                          const unsigned short* __restrict__ src, size_t ld,
                                          int rows, int cols, int nr, int nc, bool vec, int tid) {
  if (vec) {
    // A row is at most 32 chunks (256 elements), so a pass of the kN
    // threads covers kN / per_row whole rows.
    const int per_row = cols / 8, rows_per_pass = kN / per_row;
    const int r0 = tid / per_row, c = (tid - r0 * per_row) * 8;
    if (r0 >= rows_per_pass) return;
    for (int r = r0; r < rows; r += rows_per_pass) {
      const bool ok = r < nr && c < nc;
      tc::cp_async16(tc::smem_addr(dst + r * dstride + c), ok ? src + r * ld + c : src, ok);
    }
  } else {
    for (int i = tid; i < rows * cols; i += kN) {
      const int r = i / cols, c = i - r * cols;
      dst[r * dstride + c] = (r < nr && c < nc) ? src[r * ld + c] : (unsigned short)0;
    }
  }
}

// The bf16 kernels' gates: i_pre and f_pre of the chunk's steps into g.li
// and g.F by 4-byte cp.async, in the caller's next commit group, so their
// latency overlaps the tiles' copies.
template <int kN>
__device__ __forceinline__ void fetch_gates(Gates& g, const float* __restrict__ ib,
                                            const float* __restrict__ fb, int c0, int chunk,
                                            int H, int tid) {
  for (int s = tid; s < chunk; s += kN) {
    tc::cp_async4(tc::smem_addr(&g.li[s]), ib + (size_t)(c0 + s) * H, true);
    tc::cp_async4(tc::smem_addr(&g.F[s]), fb + (size_t)(c0 + s) * H, true);
  }
}

// Once fetch_gates' copies have landed (wait and barrier): F as
// chunk_gates forms it.  Called by all kN threads; ends with a barrier.
template <int kN>
__device__ __forceinline__ void gates_landed(Gates& g, int chunk, int tid) {
  for (int s = tid; s < chunk; s += kN) g.F[s] = logsigmoid(g.F[s]);
  __syncthreads();
  scan_gates(g, chunk, tid);
}

// vec flags: bit 0, the rows of q and k (dk % 8 == 0); bit 1, the rows of
// v and of C's pieces (dv % 8 == 0); each with 16-byte aligned pointers.
constexpr int kVecK = 1, kVecV = 2;

struct StateMmaSmem {
  Gates g;
  float w[kMaxChunk];                                   // e^{s_log - m_c}
  float red[kStateThreads / 32];
  unsigned short k[2][kStateKT * kKS1];                 // k key tiles, [s][d]
  unsigned short v[2][kStateKT * kVS1];                 // v key tiles, [s][j]
  unsigned short piece[kStatePieces][kStateKT * kKS1];  // pieces of w_s k[s][d]
};

// Kernel 1, bf16: C_c[d][j] = sum_s (w_s k[s][d]) v[s][j] as the pieces of
// (w k)^T times v (exact), over runs of kRun keys; n_c likewise with v = 1.
template <int NP>
__global__ void __launch_bounds__(kStateThreads, 2)
mlstm_state_mma_kernel(const __nv_bfloat16* __restrict__ k, const __nv_bfloat16* __restrict__ v,
                       const float* __restrict__ ip, const float* __restrict__ fp,
                       float* __restrict__ states, float* __restrict__ f_last,
                       float* __restrict__ m_loc, int S, int H, int dk, int dv, int chunk,
                       int vec) {
  constexpr int kJ = 16 * NP;     // the block's columns of dv
  constexpr int kN1 = 2 * NP + 1;  // its n-tiles: v's and n_c's column of ones
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateMmaSmem& sm = *reinterpret_cast<StateMmaSmem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int d0 = blockIdx.x * kStateD, j0 = blockIdx.y * kJ;
  const int nc = S / chunk;
  const int bhc = blockIdx.z;                 // (b * H + h) * nc + ci
  const int bh = bhc / nc, ci = bhc - bh * nc, bb = bh / H, hh = bh - bb * H;
  const int c0 = ci * chunk;
  const int nd = min(kStateD, dk - d0), nj = min(kJ, dv - j0);
  const size_t kstep = (size_t)H * dk, vstep = (size_t)H * dv;
  const unsigned short* kb = reinterpret_cast<const unsigned short*>(k) +
                             ((size_t)bb * S + c0) * kstep + (size_t)hh * dk + d0;
  const unsigned short* vb = reinterpret_cast<const unsigned short*>(v) +
                             ((size_t)bb * S + c0) * vstep + (size_t)hh * dv + j0;
  const int tiles = (chunk + kStateKT - 1) / kStateKT;

  auto fetch = [&](int kt) {
    const int s0 = kt * kStateKT, ns = min(kStateKT, chunk - s0);
    load_tile<kStateThreads>(sm.k[kt & 1], kKS1, kb + (size_t)s0 * kstep, kstep, kStateKT,
                             kStateD, ns, nd, vec & kVecK, tid);
    load_tile<kStateThreads>(sm.v[kt & 1], kVS1, vb + (size_t)s0 * vstep, vstep, kStateKT,
                             kJ, ns, nj, vec & kVecV, tid);
  };
  fetch_gates<kStateThreads>(sm.g, ip + (size_t)bb * S * H + hh, fp + (size_t)bb * S * H + hh,
                             c0, chunk, H, tid);
  tc::cp_async_commit();
  fetch(0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();  // the gates have landed ...
  __syncthreads();         // ... for every thread
  gates_landed<kStateThreads>(sm.g, chunk, tid);
  const float fl = sm.g.F[chunk - 1];
  auto s_log = [&](int s) { return __fadd_rn(__fsub_rn(fl, sm.g.F[s]), sm.g.li[s]); };
  // m_c = max_s s_log; a max is exact in any order.
  float mx = -CUDART_INF_F;
  for (int s = tid; s < chunk; s += kStateThreads) mx = max_nan(mx, s_log(s));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = max_nan(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) sm.red[warp] = mx;
  __syncthreads();
  float mc = sm.red[0];
#pragma unroll
  for (int i = 1; i < kStateThreads / 32; ++i) mc = max_nan(mc, sm.red[i]);
  for (int s = tid; s < chunk; s += kStateThreads) sm.w[s] = expf(s_log(s) - mc);
  if (blockIdx.x == 0 && blockIdx.y == 0 && tid == 0) {
    f_last[bhc] = fl;
    m_loc[bhc] = mc;
  }

  const bool active = warp * 16 < nd;      // warp-uniform: its rows of dk exist
  const bool with_n = blockIdx.y == 0;     // block-uniform: the first column block sums n_c
  float acc[kN1 - 1][4];
  float nacc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int n = 0; n < kN1 - 1; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  }
  for (int kt = 0; kt < tiles; ++kt) {
    if (kt + 1 < tiles) fetch(kt + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();  // tile kt has landed ...
    __syncthreads();         // ... for every thread; w is written
    const int s0 = kt * kStateKT;
    const unsigned short* kt_s = sm.k[kt & 1];
    for (int e = tid; e < kStateKT * kStateD / 2; e += kStateThreads) {
      const int s = e / (kStateD / 2), d = e % (kStateD / 2) * 2;
      const uint32_t raw = *reinterpret_cast<const uint32_t*>(kt_s + s * kKS1 + d);
      const float wv = s0 + s < chunk ? sm.w[s0 + s] : 0.0f;
      uint32_t pc[kStatePieces];
      split(__fmul_rn(wv, tc::low_bf16(raw)), __fmul_rn(wv, tc::high_bf16(raw)), pc);
#pragma unroll
      for (int i = 0; i < kStatePieces; ++i) {
        *reinterpret_cast<uint32_t*>(&sm.piece[i][s * kKS1 + d]) = pc[i];
      }
    }
    __syncthreads();
    if (active) {
      const unsigned short* vt = sm.v[kt & 1];
      const int steps = min(kStateKT, chunk - s0) / kRun;
      for (int kk = 0; kk < steps; ++kk) {
        // A fragments of (w k)^T: rows d = 16 warp.., columns s = 16 kk..
        uint32_t a[kStatePieces][4];
        const int arow = kk * 16 + (lane & 7) + (lane >> 4) * 8;
#pragma unroll
        for (int i = 0; i < kStatePieces; ++i) {
          tc::ldmatrix_x4_trans(
              a[i], tc::smem_addr(&sm.piece[i][arow * kKS1 + warp * 16 + ((lane >> 3) & 1) * 8]));
        }
        // B fragments of v (16 keys x 8 columns) for every n-tile pair.
        const int brow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        uint32_t b[NP][4];
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          tc::ldmatrix_x4_trans(b[np], tc::smem_addr(vt + brow * kVS1 + np * 16 + (lane >> 4) * 8));
        }
        // One run of kRun keys per n-tile from zero, the pieces smallest
        // first; the n-tiles' runs are independent, so their mmas overlap.
        float d[kN1][4];
#pragma unroll
        for (int n = 0; n < kN1; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) d[n][e] = 0.0f;
        }
#pragma unroll
        for (int i = kStatePieces - 1; i >= 0; --i) {
#pragma unroll
          for (int np = 0; np < NP; ++np) {
            tc::mma_bf16(d[2 * np], a[i], b[np][0], b[np][1]);
            tc::mma_bf16(d[2 * np + 1], a[i], b[np][2], b[np][3]);
          }
          if (with_n) tc::mma_bf16(d[kN1 - 1], a[i], kOnes, kOnes);
        }
#pragma unroll
        for (int n = 0; n < 2 * NP; ++n) add4(acc[n], d[n]);
        if (with_n) add4(nacc, d[kN1 - 1]);
      }
    }
    __syncthreads();  // tile kt and the pieces are read before they are overwritten
  }

  if (!active) return;
  float* out = states + (size_t)bhc * ((size_t)dk * dv + dk);
  const bool pairs_ok = (dv & 1) == 0 && (dk & 1) == 0;  // (row, even column) 8-byte aligned
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int d = d0 + warp * 16 + (lane >> 2) + h2 * 8;
    if (d >= dk) continue;
    float* row = out + (size_t)d * dv + j0;
#pragma unroll
    for (int n = 0; n < kN1 - 1; ++n) {
      const int j = n * 8 + (lane & 3) * 2;
      if (pairs_ok && j + 1 < nj) {
        *reinterpret_cast<float2*>(row + j) = make_float2(acc[n][2 * h2], acc[n][2 * h2 + 1]);
      } else {
        if (j < nj) row[j] = acc[n][2 * h2];
        if (j + 1 < nj) row[j + 1] = acc[n][2 * h2 + 1];
      }
    }
    if (with_n && (lane & 3) == 0) out[(size_t)dk * dv + d] = nacc[2 * h2];
  }
}

// Kernel 3's shared memory: the head (gates and per-row values), the q
// tile [64][KS], and kOutStages stages, each holding a key tile (k [32][KS],
// v [32][VS]) or a slice of C_prev's pieces ([kOutPieces][32 of dk][VS]).
// KS is dk padded to a whole kDkRun (zeros past dk), VS the block's 16 NP
// columns, each plus 8: an odd number of 16-byte chunks, so ldmatrix reads
// hit 8 bank groups.
struct OutHead {
  Gates g;
  float pmax[kMaxChunk];  // max_{s' <= s} (i_s' - F_s')
  float mrow[kQT];        // m_t
  float winter[kQT];      // scale e^{F_t + m_prev - m_t}
  float den0[kQT];        // scale e^{F_t + m_prev - m_t} (q_t . n_prev)
  float nprev[kMaxDim];   // n at the chunk's start
};

struct OutLayout {
  int ks, vs;
  size_t q_bytes, k_bytes, stage_bytes, total;
  __host__ __device__ OutLayout(int dk, int np) {
    ks = (dk + kDkRun - 1) / kDkRun * kDkRun + 8;
    vs = 16 * np + 8;
    q_bytes = (size_t)kQT * ks * 2;
    k_bytes = (size_t)kKT * ks * 2;
    const size_t key = k_bytes + (size_t)kKT * vs * 2;
    const size_t cslice = (size_t)kOutPieces * kCSlice * vs * 2;
    stage_bytes = key > cslice ? key : cslice;
    total = sizeof(OutHead) + q_bytes + kOutStages * stage_bytes;
  }
};

// Kernel 3, bf16: one block of 4 warps per (b, h, chunk, 64 query rows,
// 16 NP columns of dv); warp w owns 16 rows.  A warp keeps its 64
// accumulators and one run's 64 more in registers and reads q's A
// fragments from shared memory where it needs them; every product loops
// over its n-tiles innermost, so a warp has up to 16 independent
// accumulator chains in flight.  Two blocks share an SM.
template <int NP>
__global__ void __launch_bounds__(kOutThreads, 2)
mlstm_output_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const float* __restrict__ ip,
                        const float* __restrict__ fp, const float* __restrict__ states,
                        const __nv_bfloat16* __restrict__ pieces,
                        const float* __restrict__ m_start, __nv_bfloat16* __restrict__ y, int S,
                        int H, int dk, int dv, int chunk, float scale, int vec) {
  constexpr int kPer = kOutThreads / kQT;  // threads a row in the row statistics
  constexpr int NT = 2 * NP;                // n-tiles of a warp's columns
  constexpr int kCols = 16 * NP;            // the block's columns of dv
  constexpr int P = kOutPieces;
  constexpr int kSliceRuns = kDkRun / kCSlice;  // slices of C_prev in one accumulator run
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const OutLayout L(dk, NP);
  OutHead& hd = *reinterpret_cast<OutHead*>(smem_raw);
  unsigned short* qs = reinterpret_cast<unsigned short*>(smem_raw + sizeof(OutHead));
  unsigned char* stages = smem_raw + sizeof(OutHead) + L.q_bytes;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nc = S / chunk;
  const int nrt = (chunk + kQT - 1) / kQT;
  const int ncg = (dv + kCols - 1) / kCols;
  // The blocks of one (b, h, chunk) are neighbours, longest rows first, so
  // they run at once and share C_prev's pieces and the key tiles in L2.
  const int bhc = blockIdx.x / (nrt * ncg);
  const int rem = blockIdx.x - bhc * (nrt * ncg);
  const int qi = nrt - 1 - rem / ncg;
  const int col0 = (rem % ncg) * kCols;  // the block's first column
  const int ncols = min(kCols, dv - col0);
  const int bh = bhc / nc, ci = bhc - bh * nc, bb = bh / H, hh = bh - bb * H;
  const int c0 = ci * chunk, t0 = qi * kQT;
  const int nt = min(kQT, chunk - t0);
  const int dkp = L.ks - 8;             // dk padded to whole accumulator runs
  const int nslices = dkp / kCSlice;
  const int ntiles = (t0 + nt - 1) / kKT + 1;  // key tiles up to the block's last row
  const size_t kstep = (size_t)H * dk, vstep = (size_t)H * dv, cells = (size_t)dk * dv;
  const size_t row0 = ((size_t)bb * S + c0) * H + hh;  // (b, chunk's first step, h)
  const unsigned short* qb = reinterpret_cast<const unsigned short*>(q) + row0 * dk;
  const unsigned short* kb = reinterpret_cast<const unsigned short*>(k) + row0 * dk;
  const unsigned short* vb = reinterpret_cast<const unsigned short*>(v) + row0 * dv + col0;
  const unsigned short* pb =
      reinterpret_cast<const unsigned short*>(pieces) + (size_t)bhc * P * cells + col0;
  const float* n_prev = states + (size_t)bhc * (cells + dk) + cells;
  const float m_prev = m_start[bhc];

  // Item it of the ring lands in stage it % kOutStages: C_prev's pieces,
  // rows kCSlice it.. of dk (it < nslices), else key tile it - nslices.
  auto stage = [&](int it) {
    return reinterpret_cast<unsigned short*>(stages + (it % kOutStages) * L.stage_bytes);
  };
  auto fetch = [&](int it) {
    unsigned short* dst = stage(it);
    if (it < nslices) {
      // Rows past dk (dk padded to whole runs) are zeros, read from nowhere.
      const int r0 = it * kCSlice, nr = max(0, min(kCSlice, dk - r0));
#pragma unroll
      for (int i = 0; i < P; ++i) {
        load_tile<kOutThreads>(dst + i * kCSlice * L.vs, L.vs,
                               nr > 0 ? pb + i * cells + (size_t)r0 * dv : pb, dv, kCSlice,
                               kCols, nr, ncols, vec & kVecV, tid);
      }
    } else {
      const int s0 = (it - nslices) * kKT, ns = min(kKT, chunk - s0);
      load_tile<kOutThreads>(dst, L.ks, kb + (size_t)s0 * kstep, kstep, kKT, dkp, ns, dk,
                             vec & kVecK, tid);
      load_tile<kOutThreads>(dst + L.k_bytes / 2, L.vs, vb + (size_t)s0 * vstep, vstep, kKT,
                             kCols, ns, ncols, vec & kVecV, tid);
    }
  };
  const int items = nslices + ntiles;
  // One step of the ring: item it + 1 in flight, item it landed for every
  // thread (the stage item it + 1 overwrites was read before the previous
  // step's closing barrier).
  auto ring = [&](int it) {
    if (it + 1 < items) fetch(it + 1);
    tc::cp_async_commit();
    tc::cp_async_wait<1>();
    __syncthreads();
  };

  load_tile<kOutThreads>(qs, L.ks, qb + (size_t)t0 * kstep, kstep, kQT, dkp, nt, dk, vec & kVecK,
                         tid);
  for (int d = tid; d < kMaxDim; d += kOutThreads) {
    tc::cp_async4(tc::smem_addr(&hd.nprev[d]), d < dk ? n_prev + d : n_prev, d < dk);
  }
  fetch_gates<kOutThreads>(hd.g, ip + (size_t)bb * S * H + hh, fp + (size_t)bb * S * H + hh, c0,
                           chunk, H, tid);
  tc::cp_async_commit();
  fetch(0);
  tc::cp_async_commit();
  tc::cp_async_wait<1>();  // q, n_prev and the gates have landed ...
  __syncthreads();         // ... for every thread
  gates_landed<kOutThreads>(hd.g, chunk, tid);
  // The prefix max of i_s - F_s: lane l of warp 0 takes a run of steps in
  // order, a shuffle scan takes the max of the runs before it.
  if (warp == 0) {
    const int per = (chunk + 31) >> 5;
    const int lo = min(chunk, lane * per), hi = min(chunk, lo + per);
    float run = -CUDART_INF_F;
    for (int s = lo; s < hi; ++s) {
      run = max_nan(run, __fsub_rn(hd.g.li[s], hd.g.F[s]));
      hd.pmax[s] = run;
    }
    float incl = run;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl = max_nan(incl, o);
    }
    const float before = __shfl_up_sync(0xffffffffu, incl, 1);
    if (lane > 0) {
      for (int s = lo; s < hi; ++s) hd.pmax[s] = max_nan(before, hd.pmax[s]);
    }
  }
  __syncthreads();  // the prefix max is written

  // Row statistics, kPer threads a row: m_t = max(F_t + max_{s <= t} (i_s
  // - F_s), F_t + m_prev, -1e30), scale e^{F_t + m_prev - m_t}, and den's
  // inter-chunk term.
  {
    const int r = tid / kPer, part = tid % kPer, t = t0 + r;
    float qn = 0.0f;
    if (t < chunk) {
      // Pairs of dk (zeros past dk in both), two chains.
      const uint32_t* q2 = reinterpret_cast<const uint32_t*>(qs + r * L.ks);
      const float2* n2 = reinterpret_cast<const float2*>(hd.nprev);
      float lo = 0.0f, hi = 0.0f;
#pragma unroll 4
      for (int e = part; e < dkp / 2; e += kPer) {
        const uint32_t qq = q2[e];
        const float2 nn = n2[e];
        lo = fmaf(tc::low_bf16(qq), nn.x, lo);
        hi = fmaf(tc::high_bf16(qq), nn.y, hi);
      }
      qn = lo + hi;
    }
#pragma unroll
    for (int off = 1; off < kPer; off <<= 1) qn += __shfl_xor_sync(0xffffffffu, qn, off);
    if (part == 0) {
      float mt = 0.0f, wi = 0.0f;
      if (t < chunk) {
        const float inter = __fadd_rn(hd.g.F[t], m_prev);
        mt = max_nan(max_nan(__fadd_rn(hd.g.F[t], hd.pmax[t]), inter), kNegBig);
        wi = scale * expf(__fsub_rn(inter, mt));
      }
      hd.mrow[r] = mt;
      hd.winter[r] = wi;
      hd.den0[r] = qn * wi;
    }
  }
  __syncthreads();  // the row statistics are written

  const int qw = t0 + warp * 16;        // the warp's first row (in the chunk)
  const bool active = qw < chunk;       // warp-uniform: rows past the chunk do nothing
  const int r8 = lane & 7, tq = lane & 3;
  const int qr = qw + (lane >> 2);      // the lane's rows qr and qr + 8
  // The A fragment of the warp's q rows at k-step kg (16 of dk).
  const unsigned short* qa_row = qs + (warp * 16 + (lane & 15)) * L.ks + (lane >> 4) * 8;
  auto q_frag = [&](uint32_t (&a)[4], int kg) {
    tc::ldmatrix_x4(a, tc::smem_addr(qa_row + kg * 16));
  };
  const float f_q[2] = {qr < chunk ? hd.g.F[qr] : 0.0f, qr + 8 < chunk ? hd.g.F[qr + 8] : 0.0f};
  const float m_q[2] = {hd.mrow[qr - t0], hd.mrow[qr + 8 - t0]};
  float den[2] = {hd.den0[qr - t0], hd.den0[qr + 8 - t0]};

  float acc[NT][4];
  float run[NT][4];  // one accumulator run per n-tile
#pragma unroll
  for (int n = 0; n < NT; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = run[n][e] = 0.0f;
  }

  // The inter-chunk term q_t C_prev: B[d][j] = C_prev[d][j] in pieces, one
  // accumulator run per kDkRun rows of dk (kSliceRuns slices).
  for (int sl = 0; sl < nslices; ++sl) {
    ring(sl);
    if (active) {
      const unsigned short* cs = stage(sl);
#pragma unroll
      for (int kk = 0; kk < kCSlice / 16; ++kk) {
        const int kg = sl * (kCSlice / 16) + kk;
        uint32_t a[4];
        q_frag(a, kg);
        const int row = kk * 16 + r8 + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int i = P - 1; i >= 0; --i) {
          const unsigned short* bi = cs + (i * kCSlice + row) * L.vs + (lane >> 4) * 8;
          uint32_t b[NP][4];
#pragma unroll
          for (int np = 0; np < NP; ++np) tc::ldmatrix_x4_trans(b[np], tc::smem_addr(bi + np * 16));
#pragma unroll
          for (int np = 0; np < NP; ++np) {
            tc::mma_bf16(run[2 * np], a, b[np][0], b[np][1]);
            tc::mma_bf16(run[2 * np + 1], a, b[np][2], b[np][3]);
          }
        }
      }
      if ((sl + 1) % kSliceRuns == 0 || sl + 1 == nslices) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          add4(acc[n], run[n]);
          run[n][0] = run[n][1] = run[n][2] = run[n][3] = 0.0f;
        }
      }
    }
    __syncthreads();  // the slice is read before the ring overwrites its stage
  }
  {
    const float w0 = hd.winter[qr - t0], w1 = hd.winter[qr + 8 - t0];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      acc[n][0] *= w0;
      acc[n][1] *= w0;
      acc[n][2] *= w1;
      acc[n][3] *= w1;
    }
  }

  for (int kj = 0; kj < ntiles; ++kj) {
    ring(nslices + kj);
    const int k0 = kj * kKT;
    // 16-key runs of the tile past the warp's last row add nothing.
    const int kruns = k0 > qw + 15 ? 0 : min(kKT / 16, (qw + 15 - k0) / 16 + 1);
    if (active && kruns > 0) {
      const unsigned short* ks_ = stage(nslices + kj);
      const unsigned short* vs_ = ks_ + L.k_bytes / 2;
      // Scores q_t . k_s: the lane's rows qr, qr + 8, keys k0 + 8 j + 2 tq +
      // {0, 1}, one accumulator run per kDkRun of dk.
      float sc[kKT / 8][4];
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[j][e] = 0.0f;
      }
      for (int r0 = 0; r0 < dkp / 16; r0 += kDkRun / 16) {
        float sr[kKT / 8][4] = {};
#pragma unroll
        for (int kk = 0; kk < kDkRun / 16; ++kk) {
          const int kg = r0 + kk;
          uint32_t a[4];
          q_frag(a, kg);
          uint32_t b[kKT / 16][4];
#pragma unroll
          for (int np = 0; np < kKT / 16; ++np) {
            tc::ldmatrix_x4(b[np], tc::smem_addr(ks_ + (np * 16 + r8 + (lane >> 4) * 8) * L.ks +
                                                 kg * 16 + ((lane >> 3) & 1) * 8));
          }
#pragma unroll
          for (int np = 0; np < kKT / 16; ++np) {
            tc::mma_bf16(sr[2 * np], a, b[np][0], b[np][1]);
            tc::mma_bf16(sr[2 * np + 1], a, b[np][2], b[np][3]);
          }
        }
#pragma unroll
        for (int j = 0; j < kKT / 8; ++j) add4(sc[j], sr[j]);
      }
      // Times scale e^{F_t - F_s + i_s - m_t}, exactly 0 (selected, not
      // multiplied) above the diagonal and past the chunk; the row sums go
      // to den.  Then the pieces, as the A fragments of the product with v
      // (the C layout of two score n-tiles is the A layout of one 16-key run).
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < kKT / 8; ++j) {
        const int s = k0 + j * 8 + 2 * tq;
        const float2 f_s = *reinterpret_cast<const float2*>(&hd.g.F[s]);
        const float2 i_s = *reinterpret_cast<const float2*>(&hd.g.li[s]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, t = qr + h * 8;
          const float fs = (e & 1) ? f_s.y : f_s.x, is = (e & 1) ? i_s.y : i_s.x;
          const float u = __fsub_rn(__fadd_rn(__fsub_rn(f_q[h], fs), is), m_q[h]);
          const float p = (s + (e & 1) <= t && t < chunk)
                              ? __fmul_rn(__fmul_rn(sc[j][e], scale), tc::ex2(u * kLog2e))
                              : 0.0f;
          sc[j][e] = p;
          rs[h] += p;
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        den[h] += rs[h];
      }
      uint32_t pa[kKT / 16][P][4];
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        uint32_t p0[P], p1[P], p2[P], p3[P];
        split(sc[2 * kk][0], sc[2 * kk][1], p0);
        split(sc[2 * kk][2], sc[2 * kk][3], p1);
        split(sc[2 * kk + 1][0], sc[2 * kk + 1][1], p2);
        split(sc[2 * kk + 1][2], sc[2 * kk + 1][3], p3);
#pragma unroll
        for (int i = 0; i < P; ++i) {
          pa[kk][i][0] = p0[i];
          pa[kk][i][1] = p1[i];
          pa[kk][i][2] = p2[i];
          pa[kk][i][3] = p3[i];
        }
      }
      // y += P v: one accumulator run per n-tile over the tile's 16-key
      // steps in key order (the pieces smallest first), from zero, then
      // added in f32.
#pragma unroll
      for (int kk = 0; kk < kKT / 16; ++kk) {
        if (kk >= kruns) break;
        const int row = kk * 16 + r8 + ((lane >> 3) & 1) * 8;
        uint32_t b[NP][4];
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          tc::ldmatrix_x4_trans(b[np], tc::smem_addr(vs_ + row * L.vs + np * 16 + (lane >> 4) * 8));
        }
#pragma unroll
        for (int i = P - 1; i >= 0; --i) {
#pragma unroll
          for (int np = 0; np < NP; ++np) {
            tc::mma_bf16(run[2 * np], pa[kk][i], b[np][0], b[np][1]);
            tc::mma_bf16(run[2 * np + 1], pa[kk][i], b[np][2], b[np][3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        add4(acc[n], run[n]);
        run[n][0] = run[n][1] = run[n][2] = run[n][3] = 0.0f;
      }
    }
    __syncthreads();  // tile kj is read before the ring overwrites its stage
  }

  if (!active) return;
  __nv_bfloat16* yb = y + row0 * dv + col0;
  const bool even = (dv & 1) == 0;  // (row, even column) is then 4-byte aligned
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = qr + h * 8;
    if (t >= chunk) continue;
    const float dd = fmaxf(fabsf(den[h]), expf(-m_q[h]));
    __nv_bfloat16* yr = yb + (size_t)t * vstep;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int j = n * 8 + 2 * tq;
      if (even && j + 1 < ncols) {
        *reinterpret_cast<__nv_bfloat162*>(yr + j) =
            __floats2bfloat162_rn(acc[n][2 * h] / dd, acc[n][2 * h + 1] / dd);
      } else {
        if (j < ncols) yr[j] = __float2bfloat16(acc[n][2 * h] / dd);
        if (j + 1 < ncols) yr[j + 1] = __float2bfloat16(acc[n][2 * h + 1] / dd);
      }
    }
  }
}
// The bf16 instance's three launches, with blocks of 16 NP columns of dv.
template <int NP>
int launch_bf16(const void* q, const void* k, const void* v, const float* ip, const float* fp,
                void* y, float* c_out, float* n_out, float* m_out, float* st, float* f_last,
                float* m_loc, float* m_start, __nv_bfloat16* pieces, int B, int S, int H, int dk,
                int dv, int chunk, float scale, int vec, cudaStream_t s) {
  const int nc = S / chunk, slots = B * H * nc;
  const int state_smem = static_cast<int>(sizeof(StateMmaSmem));
  cudaError_t err = cudaFuncSetAttribute(mlstm_state_mma_kernel<NP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, state_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid1((dk + kStateD - 1) / kStateD, (dv + 16 * NP - 1) / (16 * NP), slots);
  mlstm_state_mma_kernel<NP><<<grid1, kStateThreads, state_smem, s>>>(
      static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), ip, fp, st,
      f_last, m_loc, S, H, dk, dv, chunk, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int per_slice = (dk * dv + dk + kThreads - 1) / kThreads;
  mlstm_carry_kernel<true><<<B * H * per_slice, kThreads, 0, s>>>(
      st, f_last, m_loc, m_start, c_out, n_out, m_out, pieces, nc, dk, dv, per_slice);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const OutLayout L(dk, NP);
  err = cudaFuncSetAttribute(mlstm_output_mma_kernel<NP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = slots * ((chunk + kQT - 1) / kQT) * ((dv + 16 * NP - 1) / (16 * NP));
  mlstm_output_mma_kernel<NP><<<blocks, kOutThreads, L.total, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ip, fp, st, pieces, m_start,
      static_cast<__nv_bfloat16*>(y), S, H, dk, dv, chunk, scale, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* ip, const void* fp, void* y,
           void* c_out, void* n_out, void* m_out, void* states, void* scalars, void* pieces,
           int B, int S, int H, int dk, int dv, int chunk, float scale, void* stream) {
  if (B < 1 || S < 1 || H < 1 || dk < 1 || dk > kMaxDim || dv < 1 || dv > kMaxDim ||
      chunk < 16 || chunk > kMaxChunk || chunk % 16 != 0 || S % chunk != 0 ||
      (long long)B * H * (S / chunk) > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = S / chunk;
  const int slots = B * H * nc;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ipf = static_cast<const float*>(ip);
  const float* fpf = static_cast<const float*>(fp);
  float* st = static_cast<float*>(states);
  float* f_last = static_cast<float*>(scalars);
  float* m_loc = f_last + slots;
  float* m_start = m_loc + slots;
  const int entries = dk * dv + dk;
  const int per_slice = (entries + kThreads - 1) / kThreads;
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    const int out_smem = static_cast<int>(sizeof(OutSmem));
    err = cudaFuncSetAttribute(mlstm_output_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               out_smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const T* qt = static_cast<const T*>(q);
    const T* kt = static_cast<const T*>(k);
    const T* vt = static_cast<const T*>(v);
    const int ndv = (dv + kCols - 1) / kCols;
    mlstm_state_kernel<T><<<dim3(ndv, slots), kThreads, 0, s>>>(kt, vt, ipf, fpf, st, f_last,
                                                                m_loc, S, H, dk, dv, chunk);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    mlstm_carry_kernel<false><<<B * H * per_slice, kThreads, 0, s>>>(
        st, f_last, m_loc, m_start, static_cast<float*>(c_out), static_cast<float*>(n_out),
        static_cast<float*>(m_out), nullptr, nc, dk, dv, per_slice);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
    const int nrt = (chunk + kRows - 1) / kRows;
    mlstm_output_kernel<T><<<dim3(nrt * slots * ndv), kThreads, out_smem, s>>>(
        qt, kt, vt, ipf, fpf, st, m_start, static_cast<T*>(y), B, S, H, dk, dv, chunk, scale);
    return static_cast<int>(cudaGetLastError());
  } else {
    const auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
    const int vec = (aligned(q) && aligned(k) && dk % 8 == 0 ? kVecK : 0) |
                    (aligned(v) && aligned(pieces) && dv % 8 == 0 ? kVecV : 0);
    // Blocks of 16 NP columns of dv, NP the power of two up to 8 that
    // covers dv (blocks of 128 columns above).
    const int np = dv > 64 ? 8 : dv > 32 ? 4 : dv > 16 ? 2 : 1;
    const auto run = np == 8 ? launch_bf16<8> : np == 4 ? launch_bf16<4>
                   : np == 2 ? launch_bf16<2> : launch_bf16<1>;
    return run(q, k, v, ipf, fpf, y, static_cast<float*>(c_out), static_cast<float*>(n_out),
               static_cast<float*>(m_out), st, f_last, m_loc, m_start,
               static_cast<__nv_bfloat16*>(pieces), B, S, H, dk, dv, chunk, scale, vec, s);
  }
}

}  // namespace

// C interface for ctypes.  Pointers are device pointers: q, k, v, i_pre,
// f_pre and y as above, the final C, n, m, and the scratch the wrapper
// allocates: states (B, H, S / chunk, dk dv + dk) f32, scalars (3, B, H,
// S / chunk) f32 and, for bf16 only, pieces (B, H, S / chunk, 2, dk, dv)
// bf16.  The launches go on `stream` and do not synchronise.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" {

int mlstm_scan_f32(const void* q, const void* k, const void* v, const void* ip, const void* fp,
                   void* y, void* c_out, void* n_out, void* m_out, void* states, void* scalars,
                   void* pieces, int B, int S, int H, int dk, int dv, int chunk, float scale,
                   void* stream) {
  return launch<float>(q, k, v, ip, fp, y, c_out, n_out, m_out, states, scalars, pieces, B, S,
                       H, dk, dv, chunk, scale, stream);
}

int mlstm_scan_bf16(const void* q, const void* k, const void* v, const void* ip, const void* fp,
                    void* y, void* c_out, void* n_out, void* m_out, void* states, void* scalars,
                    void* pieces, int B, int S, int H, int dk, int dv, int chunk, float scale,
                    void* stream) {
  return launch<__nv_bfloat16>(q, k, v, ip, fp, y, c_out, n_out, m_out, states, scalars, pieces,
                               B, S, H, dk, dv, chunk, scale, stream);
}

}  // extern "C"
