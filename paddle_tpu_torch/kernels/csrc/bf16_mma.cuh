// The bf16 tensor-core primitives shared by the bf16 flash kernels
// (flash_attention_bf16.cu) and the bf16 GEMM tile loop of the LM head
// (gemm_bf16.cuh): mma.sync m16n8k16 with f32 accumulators, ldmatrix
// fragment loads from shared memory, and packing f32 values into bf16
// pairs.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for
// lane = 4 g + t (g = lane >> 2, t = lane & 3); a register holds two bf16,
// the lower k (or column) index in its low half:
//   A (16 x 16, row): a0 (g, 2t..2t+1)   a1 (g+8, 2t..2t+1)
//                     a2 (g, 2t+8..+9)   a3 (g+8, 2t+8..+9)
//   B (16 x 8, col):  b0 (k 2t..2t+1, n g)   b1 (k 2t+8..+9, n g)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t+1)  c2 (g+8, 2t)  c3 (g+8, 2t+1)
// So two n8 C tiles side by side are, packed pairwise, the A fragment of
// a product whose k runs over their 16 columns: (c0 c1 | c2 c3) of the
// first tile are a0 | a1, of the second a2 | a3.  p and ds feed their
// products this way, from registers.
//
// ldmatrix.x4 reads four 8 x 8 matrices of bf16 from shared memory, one
// 16-byte row per lane address (lanes 8 i .. 8 i + 7 give matrix i's
// rows); lane l receives element (row g, columns 2t, 2t+1) of each matrix,
// or with .trans the transposed pair (rows 2t, 2t+1, column g).  The four
// loaders below cover the layouts a staged tile can have, named by its
// row and column index: [m][k] and [k][m] for A, [k][n] and [n][k] for B.
// Rows must start on 16 bytes: every tile's row length is a multiple of 8
// bf16, padded by 8 so that the 8 rows of one matrix fall in distinct bank
// groups.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt_bf16 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// A fragment of the 16 x 16 block at (m0, k0) of a tile S[m][k] (row
// stride ld): matrix i holds rows m0 + 8 (i & 1), columns k0 + 8 (i >> 1)
__device__ __forceinline__ void load_a_mk(uint32_t (&a)[4], const bf16* S,
                                          int ld, int m0, int k0, int lane) {
  const int r = lane & 7, i = lane >> 3;
  ldsm_x4(a, S + (m0 + r + 8 * (i & 1)) * ld + k0 + 8 * (i >> 1));
}

// the same from a tile S[k][m], transposed as it loads
__device__ __forceinline__ void load_a_km(uint32_t (&a)[4], const bf16* S,
                                          int ld, int m0, int k0, int lane) {
  const int r = lane & 7, i = lane >> 3;
  ldsm_x4_t(a, S + (k0 + r + 8 * (i >> 1)) * ld + m0 + 8 * (i & 1));
}

// B fragments of two n8 tiles, n0 and n0 + 8, over k0 .. k0 + 15 of a tile
// S[k][n]: b[0], b[1] the first tile's, b[2], b[3] the second's
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* S,
                                          int ld, int k0, int n0, int lane) {
  const int r = lane & 7, i = lane >> 3;
  ldsm_x4_t(b, S + (k0 + r + 8 * (i & 1)) * ld + n0 + 8 * (i >> 1));
}

// the same from a tile S[n][k]
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* S,
                                          int ld, int k0, int n0, int lane) {
  const int r = lane & 7, i = lane >> 3;
  ldsm_x4(b, S + (n0 + r + 8 * (i >> 1)) * ld + k0 + 8 * (i & 1));
}

// d += a . b, one m16n8k16 product with f32 accumulation
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16 (to nearest, ties to even) in one register, lo
// in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x by one MUFU.EX2 (ex2.approx.ftz, about 2 ulp); results below 2^-126
// flush to 0
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// the A fragment of the k16 block made of C tiles c (columns 0-7) and d
// (columns 8-15), rounded to bf16
__device__ __forceinline__ void a_from_c(uint32_t (&a)[4], const float (&c)[4],
                                         const float (&d)[4]) {
  a[0] = pack(c[0], c[1]);
  a[1] = pack(c[2], c[3]);
  a[2] = pack(d[0], d[1]);
  a[3] = pack(d[2], d[3]);
}

}  // namespace ptt_bf16
