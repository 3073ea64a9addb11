// The TF32 tensor-core primitives shared by the flash kernels
// (flash_mma.cuh) and the LM head's GEMM tile loop (gemm_tc.cuh): the
// 3xTF32 split, mma.sync m16n8k8 and the cp.async copies.
//
// 3xTF32.  x = hi + lo with hi = tf32(x) (the rounding of cvt.rna.tf32.f32:
// to nearest, ties away, 10 mantissa bits) and lo = tf32(x - hi); a product
// a.b is taken as lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b), the small terms
// first, into one f32 accumulator.  The dropped lo.lo term is about 2^-22
// of the product, so the result is f32-grade (single-pass TF32 keeps about
// 2^-11).  This is the plan of PyTorch's f32 SDPA kernel (CUTLASS
// OpMultiplyAddFastF32).
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, for lane
// = 4 g + t (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g)   b1 (t + 4, g)           (row = k, col = n)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt_mma {

// cvt.rna.tf32.f32 x: adding half a unit of the 13 dropped bits to the
// magnitude bits and clearing them rounds to nearest with ties away from
// zero, the same bits as the conversion instruction (checked on the card:
// identical outputs), in two integer operations; the conversion instruction
// issues at a fraction of their rate and bound both flash kernels.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// A operand (4 values in fragment order) and B operand (2 values), split
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split(a0, hi[0], lo[0]);
    split(a1, hi[1], lo[1]);
    split(a2, hi[2], lo[2]);
    split(a3, hi[3], lo[3]);
  }
  __device__ __forceinline__ void set(const float (&a)[4]) {
    set(a[0], a[1], a[2], a[3]);
  }
};

struct FragB {
  uint32_t hi[2], lo[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split(b0, hi[0], lo[0]);
    split(b1, hi[1], lo[1]);
  }
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a.b in 3xTF32, the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a,
                                     const FragB& b) {
  mma(d, a.lo, b.hi);
  mma(d, a.hi, b.lo);
  mma(d, a.hi, b.hi);
}

// cp.async of 16 bytes to dst, of which the first `bytes` (0, 4, ..., 16)
// are read from src and the rest zero-filled
__device__ __forceinline__ void cp_async16_part(void* dst, const void* src,
                                                int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

// cp.async of 16, 8 or 4 bytes; a copy that is not `in` reads nothing and
// zero-fills its destination
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  cp_async16_part(dst, src, in ? 16 : 0);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 8 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace ptt_mma
