// PTX wrappers for Hopper's (sm_90a) warp-level tensor-core path: 16-byte
// cp.async copies into shared memory with zero fill, ldmatrix (plain and
// transposed) from shared memory into mma fragments, the bf16 mma
// m16n8k16 with f32 accumulators, and the special-function unit's 2^x.
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
