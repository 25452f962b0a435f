// PTX wrappers for Hopper's (sm_90a) warp-level tensor-core path: 16- and
// 4-byte cp.async copies into shared memory with zero fill, ldmatrix
// (plain and transposed) from shared memory into mma fragments, the bf16
// mma m16n8k16 and the tf32 mma m16n8k8 with f32 accumulators, the split
// of an f32 value into two tf32 halves, and the special-function unit's
// 2^x.
//
// Fragment layouts of mma.m16n8k16.row.col (lane = 4 g + t):
//   A (16 x 16, 4 registers of 2 bf16): a0 = (row g, cols 2t, 2t+1),
//     a1 = (row g+8, cols 2t, 2t+1), a2 = (row g, cols 2t+8, 2t+9),
//     a3 = (row g+8, cols 2t+8, 2t+9);
//   B (16 x 8, 2 registers): b0 = (rows 2t, 2t+1, col g),
//     b1 = (rows 2t+8, 2t+9, col g);
//   C (16 x 8, 4 f32): c0, c1 = (row g, cols 2t, 2t+1),
//     c2, c3 = (row g+8, cols 2t, 2t+1).
// The lower column (A) or row (B) of a pair sits in the low 16 bits.  The
// C layout of two neighbouring n-tiles is the A layout of one k-step, so
// an accumulator feeds the next product without shared memory.
//
// Fragment layouts of mma.m16n8k8.row.col with tf32 operands (one value
// per register):
//   A (16 x 8): a0 = (row g, col t), a1 = (row g+8, col t),
//     a2 = (row g, col t+4), a3 = (row g+8, col t+4);
//   B (8 x 8): b0 = (row t, col g), b1 = (row t+4, col g);
//   C (16 x 8): as for m16n8k16.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>

namespace tc {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes (nothing is
// read from `src` then, but it must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, or 4 zero bytes, for rows that are not 16-byte aligned.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// Two matrices; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr)
               : "memory");
}

// c += a b: A 16 x 16 bf16 (row), B 16 x 8 bf16 (col), C f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b: A 16 x 8 tf32 (row), B 8 x 8 tf32 (col), C f32.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a b: as mma_tf32 from a zero accumulator.
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  const float z = 0.0f;
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(z));
}

// x rounded to tf32 (10 stored significand bits, nearest, ties away from
// zero), as the bits of an f32 whose low 13 bits are zero: the rounding
// of cvt.rna.tf32.f32 for finite x, in two integer operations (nvcc
// expands that cvt to a longer sequence on sm_90a).  Adding half of the
// last kept bit to the magnitude's bits carries into the exponent where
// it must.  A NaN's bits may carry into the sign (the card's NaN,
// 0x7fffffff, gives -0), so split_tf32 keeps NaN and inf by way of lo.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + e: hi = tf32(x), lo = tf32(x - hi) (the subtraction is
// exact in f32), |e| <= 2^-22 |x| for normal x.  For a NaN or an inf x,
// x - hi is the card's NaN, 0x7fffffff; clamped to 0x7fffefff first (no
// finite value's bits are as large, and a negative value's are negative
// as an int), it rounds to the NaN 0x7fffe000.  So lo is NaN, and every
// product lo_a hi_b + hi_a lo_b + hi_a hi_b that x enters is NaN: a NaN
// stays NaN, and an inf, whose product the plain version may leave inf,
// becomes NaN.  The clamp is one integer min.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  const int d = __float_as_int(x - __uint_as_float(hi));
  lo = (static_cast<uint32_t>(min(d, 0x7fffefff)) + 0x1000u) & 0xffffe000u;
}

// 2^x by the special-function unit: relative error about 2^-22, results
// below 2^-126 flushed to +0 (so 2^-1e30 is exactly 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 as one register of two bf16 (round to nearest even), x low.
__device__ __forceinline__ uint32_t pack_bf16(float x, float y) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The exact f32 value of the low / high bf16 of a packed register.
__device__ __forceinline__ float low_bf16(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float high_bf16(uint32_t r) { return __uint_as_float(r & 0xffff0000u); }

}  // namespace tc
