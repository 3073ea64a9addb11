// Shared pieces of the flash-attention kernels (flash_attention_hdt.cu and
// flash_attention_hdt_bwd.cu): the 3xTF32 tensor-core product, the
// m16n8k8 fragment index maps, and the stride-chosen cp.async staging of a
// 64-token tile into shared memory.
//
// 3xTF32.  x = hi + lo with hi = tf32(x) (the rounding of cvt.rna.tf32.f32:
// to nearest, ties away, 10 mantissa bits) and lo = tf32(x - hi); a product
// a.b is taken as lo(a).hi(b) + hi(a).lo(b) + hi(a).hi(b), the small terms
// first, into one f32 accumulator.  The dropped lo.lo term is about 2^-22 of the product,
// so the result is f32-grade (single-pass TF32 keeps about 2^-11).  This is
// the plan of PyTorch's f32 SDPA kernel (CUTLASS OpMultiplyAddFastF32).
//
// Fragments of mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32, for lane
// = 4 g + t (g = lane >> 2, t = lane & 3):
//   A (16 x 8, row):  a0 (g, t)   a1 (g + 8, t)   a2 (g, t + 4)   a3 (g + 8, t + 4)
//   B (8 x 8, col):   b0 (t, g)   b1 (t + 4, g)           (row = k, col = n)
//   C (16 x 8):       c0 (g, 2t)  c1 (g, 2t + 1)  c2 (g + 8, 2t)  c3 (g + 8, 2t + 1)
// A C tile is used as the A operand of the next product without a shuffle
// by relabelling k within each 8-block on both sides: k slot t is column 2t
// and k slot t + 4 is column 2t + 1, so A = (c0, c2, c1, c3), and the B
// operand's rows are read as 2t and 2t + 1 instead of t and t + 4.
//
// Shared tiles are token rows, [64][D + 4] floats.  D + 4 = 4 (mod 32), so
// the fragment reads (row g, column t) and (row 2t or 2t + 1, column g) of a
// warp hit 32 different banks, and every row starts on 16 bytes.
//
// Staging.  Each operand comes with (batch, head, feature, token) element
// strides; the host picks its path once per call (stage_mode):
//   kVec16       feature stride 1 and 16-byte-aligned rows: 16-byte cp.async
//                along features ([B, H, T, d], [B, T, H, d] views, [N, 3E]);
//   kTokenFast   token stride 1 (the head-major [H, d, B*T]): 4-byte cp.async,
//                a warp on 8 tokens x 4 features, so every 32-byte sector it
//                reads is used whole and its shared writes are conflict-free;
//   kFeatureFast anything else (a view at an odd offset): 4-byte cp.async,
//                a warp on 32 features of one token.
// All three fill the same tile with the same values, so the arithmetic and
// the bits of the result do not depend on the layout.  Tokens at or past
// `tend` are zero-filled (cp.async with source size 0).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace ptt_flash {

constexpr int kTile = 64;   // tokens per tile, queries and keys
constexpr int kThreads = 128;  // 4 warps, 16 tile rows each
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// element strides of one operand: batch row, head, feature, token
struct Strides {
  long long b, h, d, t;
};

enum StageMode : int { kVec16 = 0, kTokenFast = 1, kFeatureFast = 2 };

inline int stage_mode(const void* base, const Strides& s) {
  const bool aligned = reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
                       s.b % 4 == 0 && s.h % 4 == 0 && s.t % 4 == 0;
  if (s.d == 1 && aligned) return kVec16;
  if (s.t == 1) return kTokenFast;
  return kFeatureFast;
}

template <int D>
struct Tile {
  static constexpr int LD = D + 4;          // token row in shared memory
  static constexpr int kFloats = kTile * LD;
};

// cvt.rna.tf32.f32 x: adding half a unit of the 13 dropped bits to the
// magnitude bits and clearing them rounds to nearest with ties away from
// zero, the same bits as the conversion instruction (checked on the card:
// identical outputs), in two integer operations; the conversion instruction
// issues at a fraction of their rate and bound both kernels.
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

// the values of an A fragment: rows (r, r + 8), columns (c + t, c + t + 4)
// of a token-row tile, times mul
template <int D>
__device__ __forceinline__ void load_a(float (&a)[4], const float* S, int r,
                                       int c, int t, float mul) {
  constexpr int LD = Tile<D>::LD;
  const float* p = S + r * LD + c + t;
  a[0] = p[0] * mul;
  a[1] = p[8 * LD] * mul;
  a[2] = p[4] * mul;
  a[3] = p[8 * LD + 4] * mul;
}

// B fragment for a product with the tile's rows as n: rows n0 + g, features
// (c + t, c + t + 4)
template <int D>
__device__ __forceinline__ void load_b_rows(FragB& b, const float* S, int n0,
                                            int c, int g, int t) {
  const float* row = S + (n0 + g) * Tile<D>::LD + c;
  b.set(row[t], row[t + 4]);
}

// B fragment for a product with the tile's rows as k, relabelled: rows
// (k0 + 2t, k0 + 2t + 1), feature f0 + g
template <int D>
__device__ __forceinline__ void load_b_cols(FragB& b, const float* S, int k0,
                                            int f0, int g, int t) {
  constexpr int LD = Tile<D>::LD;
  const float* p = S + (k0 + 2 * t) * LD + f0 + g;
  b.set(p[0], p[LD]);
}

// A operand from a C tile (relabelled k)
__device__ __forceinline__ void a_from_c(FragA& a, const float (&c)[4]) {
  a.set(c[0], c[2], c[1], c[3]);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
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

// S[r][j] <- base[feature j, token t0 + r] for t0 + r < tend, else 0:
// issues the tile's cp.async copies (the caller commits and waits).  The
// source addresses advance by pointer steps, so a copy costs no 64-bit
// multiply.
template <int D>
__device__ __forceinline__ void stage(float* S, const float* base,
                                      const Strides& s, int t0, int tend,
                                      int mode) {
  constexpr int LD = Tile<D>::LD, NW = kThreads / 32;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (mode == kVec16) {
    // a thread copies 16-byte chunk c of rows r0, r0 + RS, ...
    constexpr int CH = D / 4, RS = kThreads / CH;
    const int c = tid % CH, r0 = tid / CH;
    const float* src = base + (long long)(t0 + r0) * s.t + 4 * c;
    const long long step = RS * s.t;
#pragma unroll
    for (int r = r0; r < kTile; r += RS, src += step) {
      const bool in = t0 + r < tend;
      cp_async16(S + r * LD + 4 * c, in ? src : base, in);
    }
  } else if (mode == kTokenFast) {
    // a warp copies 8 tokens x 4 features per instruction: tokens
    // 8 w + (lane & 7) + 32 i, features (lane >> 3) + 4 j
    const long long fstep = 4 * s.d;
#pragma unroll
    for (int r = 8 * warp + (lane & 7); r < kTile; r += 8 * NW) {
      const bool in = t0 + r < tend;
      const float* src = base + (long long)(t0 + r) * s.t + (lane >> 3) * s.d;
      float* dst = S + r * LD + (lane >> 3);
#pragma unroll 4
      for (int f = 0; f < D; f += 4, src += fstep, dst += 4)
        cp_async4(dst, in ? src : base, in);
    }
  } else {
    // a warp copies 32 features of one token per instruction
    const float* src = base + (long long)(t0 + warp) * s.t + lane * s.d;
    const long long rstep = NW * s.t, fstep = 32 * s.d;
#pragma unroll 2
    for (int r = warp; r < kTile; r += NW, src += rstep) {
      const bool in = t0 + r < tend;
#pragma unroll
      for (int f = 0; f < D / 32; ++f)
        cp_async4(S + r * LD + 32 * f + lane, in ? src + f * fstep : base,
                  in);
    }
  }
}

}  // namespace ptt_flash
