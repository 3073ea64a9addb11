// Shared pieces of the flash-attention kernels (flash_attention_hdt.cu and
// flash_attention_hdt_bwd.cu): the m16n8k8 fragment reads of a token-row
// tile and the stride-chosen cp.async staging of a 64-token tile into
// shared memory.  The 3xTF32 split, mma.sync and the cp.async copies are
// in tf32_mma.cuh (shared with the LM head's GEMM), which also gives the
// fragment maps.
//
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

#include "tf32_mma.cuh"

namespace ptt_flash {

using namespace ptt_mma;

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
