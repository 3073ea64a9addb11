// The 3xTF32 tensor-core GEMM tile loop of the LM head (lm_head.cu).
//
// Operands are pre-split: each f32 element x is stored as the pair
// (hi, lo) = (tf32(x), tf32(x - tf32(x))) side by side (a float2), written
// once by a pre-pass (x, W) or by the epilogue that produces the operand
// (dlogits).  So the inner loop does no rounding: one 8-byte shared load
// gives both halves of a fragment value, and each k8 step is three
// mma.sync.m16n8k8 TF32 products per output tile, lo.hi, hi.lo, hi.hi, the
// small terms first (tf32_mma.cuh has the split and the fragment maps).
// The pairs move twice the bytes of f32; splitting each staged f32 tile in
// shared memory instead, after it lands, was slower (it leaves room for two
// stages, not three, and adds the split to the loop):
// tools/gemm_tc_variants.cu times both, PERF.md has the numbers.
//
// A CTA of 8 warps (2 along M x 4 along N) computes a kBM x kBN = 128 x 128
// tile of A . B, a 64 x 32 tile a warp (4 x 4 m16n8 accumulators, twice:
// see below), over k-tiles of kBK = 32.  The k-tiles are staged by
// cp.async into a ring of 2-4 stages in dynamic shared memory (as many as
// 227 KB hold: 3 here); a stage is issued kStages - 1 k-tiles ahead of its
// use, and one __syncthreads a k-tile both publishes the landed stage and
// frees the slot the next copy overwrites.  A CTA may run several output tiles along N (the
// LM-head forward walks its share of the vocabulary): the pipeline runs
// straight through them, and the caller's epilogue sees each tile's
// accumulators while the next tile's copies are in flight.
//
// The tensor cores add an mma's products to its accumulator with
// truncation (round toward zero), so a sum carried through every mma of a
// long k loop drifts by about half an ulp of itself per mma, always the
// same way: 192 such mma (D 512, three passes) put logits near 80 off by
// 4.4e-4.  So the products go, pass by pass, into an accumulator that is
// added after every k-tile (12 mma) to a second one by f32 adds, which
// round to nearest, and then zeroed: the truncation acts at the scale of
// kBK products only.  Each accumulator's three
// passes run over all of the warp's tiles before the next pass, so no
// product waits on the one before it.  The two accumulators take 128
// registers a thread, which is why a warp's tile is 64 x 32 and not
// 64 x 64.  The shape, the k-tile and the accumulation were chosen by
// timing variants of the loop (tools/gemm_tc_variants.cu, numbers
// in PERF.md): one accumulator through the whole k loop is about a tenth
// faster but misses f32 grade on large sums; a zero accumulator per k8
// step, added at once, is slower than this loop (its chains of three
// dependent mma and the adds need more than 255 registers).
//
// Each operand is contiguous along one index, with rows of `ld` pairs
// along the other; which index is contiguous is a template parameter
// (AK: A is k-contiguous, x or dlogits, else m-contiguous, x^T; BN: B is
// n-contiguous, W or dlogits, else k-contiguous, W^T).  A staged tile keeps
// the global layout: [rows][cols + 4] pairs with the contiguous index
// along the row.  cols + 4 = 4 (mod 16) pairs, so each half-warp's 8-byte
// fragment reads, (row g, col t) or (row t, col g), hit 16 different bank
// pairs, and every row starts on 16 bytes.  The copy path is chosen on the
// host from the operand's address and row length (operand()): 16-byte
// copies of two pairs where rows are 16-byte aligned, 8-byte copies of one
// pair otherwise (an odd D or V).  Pairs outside [M, N] and k outside
// [kb, ke) are zero-filled, so any shape works.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace ptt_gemm {

using namespace ptt_mma;

constexpr int kBM = 128, kBN = 128, kBK = 32;  // a CTA's tile, a k-tile
constexpr int kWM = 64, kWN = 32;              // a warp's tile
constexpr int kWarpsN = kBN / kWN;             // warps along N
constexpr int kThreads = 32 * (kBM / kWM) * kWarpsN;
constexpr int kMI = kWM / 16, kNJ = kWN / 8;   // a warp's m16 x n8 tiles
constexpr int kSmemMax = 232448;               // a CTA's shared memory

// A pre-split operand: pair (r, c) is p[r * ld + c], c the contiguous index
struct Operand {
  const float2* p;
  long long ld;
  int copy16;  // 16-byte copies (rows 16-byte aligned), else 8-byte
};

inline Operand operand(const float2* p, long long ld) {
  return Operand{p, ld,
                 reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 2 == 0};
}

// an R x C tile of pairs, C along the contiguous index
template <int R, int C>
struct Tile {
  static constexpr int kR = R, kC = C, kLD = C + 4;
  static constexpr int kPairs = R * kLD;
};

template <bool AK, bool BN>
struct Layout {
  using A = Tile<AK ? kBM : kBK, AK ? kBK : kBM>;
  using B = Tile<BN ? kBK : kBN, BN ? kBN : kBK>;
  static constexpr int kStagePairs = A::kPairs + B::kPairs;
  static constexpr int kFit = kSmemMax / (kStagePairs * 8);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmemBytes = kStages * kStagePairs * 8;
  static_assert(kStages >= 2, "a stage must fit twice");
};

// S[r][c] <- the pair p[(r0 + r) * ld + c0 + c] for r0 + r < rend and
// c0 + c < cend, else zero: issues this thread's cp.async copies.
template <class T>
__device__ __forceinline__ void stage(float2* S, const Operand& o, int r0,
                                      int rend, int c0, int cend) {
  const int tid = threadIdx.x;
  if (o.copy16) {
    constexpr int CH = T::kC / 2, RS = kThreads / CH;
    const int c = 2 * (tid % CH), gc = c0 + c;
    // pairs of this chunk inside the row: 2, 1 or 0
    const int n = cend - gc >= 2 ? 2 : (cend - gc == 1 ? 1 : 0);
#pragma unroll
    for (int i = 0; i < T::kR / RS; ++i) {
      const int r = tid / CH + i * RS, gr = r0 + r;
      const int bytes = gr < rend ? 8 * n : 0;
      cp_async16_part(S + r * T::kLD + c,
                      bytes ? o.p + (long long)gr * o.ld + gc : o.p, bytes);
    }
  } else {
    constexpr int RS = kThreads / T::kC;
    const int c = tid % T::kC, gc = c0 + c;
#pragma unroll
    for (int i = 0; i < T::kR / RS; ++i) {
      const int r = tid / T::kC + i * RS, gr = r0 + r;
      const bool in = gr < rend && gc < cend;
      cp_async8(S + r * T::kLD + c,
                in ? o.p + (long long)gr * o.ld + gc : o.p, in);
    }
  }
}

__device__ __forceinline__ void load_pair(uint32_t& hi, uint32_t& lo,
                                          const float2* p) {
  const float2 v = *p;
  hi = __float_as_uint(v.x);
  lo = __float_as_uint(v.y);
}

// Accumulator (i, j, e) of this thread is element (row, col) of its tile:
//   row = wm + 16 i + g + 8 (e >> 1),  col = wn + 8 j + 2 t + (e & 1)
// with wm = kWM (warp / kWarpsN), wn = kWN (warp % kWarpsN), g = lane >> 2,
// t = lane & 3.
struct Acc {
  float v[kMI][kNJ][4];
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc.v[i][j][e] = 0.f;
}

// part += the products of one staged k-tile (pair tiles As, Bs), pass by
// pass over the warp's accumulators: each gets lo.hi, hi.lo, hi.hi in that
// order (mma3's), with kMI kNJ - 1 independent products between two that
// share an accumulator
template <class TA, class TB, bool AK, bool BN>
__device__ __forceinline__ void ktile_products(Acc& part, const float2* As,
                                               const float2* Bs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 8) {
    FragA a[kMI];
    FragB b[kNJ];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      const int r = wm + 16 * i + g;
      if (AK) {
        const float2* p = As + r * TA::kLD + kk + t;
        load_pair(a[i].hi[0], a[i].lo[0], p);
        load_pair(a[i].hi[1], a[i].lo[1], p + 8 * TA::kLD);
        load_pair(a[i].hi[2], a[i].lo[2], p + 4);
        load_pair(a[i].hi[3], a[i].lo[3], p + 8 * TA::kLD + 4);
      } else {
        const float2* p = As + (kk + t) * TA::kLD + r;
        load_pair(a[i].hi[0], a[i].lo[0], p);
        load_pair(a[i].hi[1], a[i].lo[1], p + 8);
        load_pair(a[i].hi[2], a[i].lo[2], p + 4 * TA::kLD);
        load_pair(a[i].hi[3], a[i].lo[3], p + 4 * TA::kLD + 8);
      }
    }
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const int c = wn + 8 * j + g;
      if (BN) {
        const float2* p = Bs + (kk + t) * TB::kLD + c;
        load_pair(b[j].hi[0], b[j].lo[0], p);
        load_pair(b[j].hi[1], b[j].lo[1], p + 4 * TB::kLD);
      } else {
        const float2* p = Bs + c * TB::kLD + kk + t;
        load_pair(b[j].hi[0], b[j].lo[0], p);
        load_pair(b[j].hi[1], b[j].lo[1], p + 4);
      }
    }
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) mma(part.v[i][j], a[i].lo, b[j].hi);
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) mma(part.v[i][j], a[i].hi, b[j].lo);
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int j = 0; j < kNJ; ++j) mma(part.v[i][j], a[i].hi, b[j].hi);
  }
}

// acc += part by f32 adds (round to nearest); part = 0
__device__ __forceinline__ void flush(Acc& acc, Acc& part) {
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc.v[i][j][e] += part.v[i][j][e];
        part.v[i][j][e] = 0.f;
      }
}

// Runs the output tiles (m0, n0 + i kBN), i < count, of A [M, K] . B [K, N]
// over k in [kb, ke) and calls epi(acc, n) after each, n its first column.
// smem holds Layout<AK, BN>::kSmemBytes; it is free again on return.
template <bool AK, bool BN, class Epi>
__device__ __forceinline__ void run_tiles(const Operand A, const Operand B,
                                          int M, int N, int kb, int ke,
                                          int m0, int n0, int count,
                                          float2* smem, Epi&& epi) {
  using L = Layout<AK, BN>;
  using TA = typename L::A;
  using TB = typename L::B;
  constexpr int S = L::kStages;
  const int nk = (ke - kb + kBK - 1) / kBK;
  const int total = count * nk;

  // stage flat k-tile f (output tile f / nk, k-tile f % nk) into its slot
  auto issue = [&](int f) {
    float2* As = smem + (f % S) * L::kStagePairs;
    float2* Bs = As + TA::kPairs;
    const int tile = f / nk, k0 = kb + (f - tile * nk) * kBK;
    const int n = n0 + tile * kBN;
    if (AK)
      stage<TA>(As, A, m0, M, k0, ke);
    else
      stage<TA>(As, A, k0, ke, m0, M);
    if (BN)
      stage<TB>(Bs, B, k0, ke, n, N);
    else
      stage<TB>(Bs, B, n, N, k0, ke);
  };

  Acc acc, part;
  zero(acc);
  zero(part);
#pragma unroll
  for (int f = 0; f < S - 1; ++f) {
    if (f < total) issue(f);
    cp_commit();
  }
  for (int f = 0; f < total; ++f) {
    cp_wait<S - 2>();   // k-tile f has landed (this thread's copies)
    __syncthreads();    // ... every thread's; slot (f - 1) % S is free
    if (f + S - 1 < total) issue(f + S - 1);
    cp_commit();
    const float2* As = smem + (f % S) * L::kStagePairs;
    ktile_products<TA, TB, AK, BN>(part, As, As + TA::kPairs);
    flush(acc, part);
    if (f % nk == nk - 1) {   // the output tile's last k-tile
      epi(acc, n0 + (f / nk) * kBN);
      zero(acc);
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// cudaFuncSetAttribute for the dynamic shared memory of a kernel on the
// loop of Layout<AK, BN>
template <bool AK, bool BN, class K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<AK, BN>::kSmemBytes);
}

// dst[i] = (tf32(src[i]), tf32(src[i] - tf32(src[i]))) for i < n, grid
// strided: the pre-pass that writes an f32 operand as pairs
__device__ __forceinline__ void split_range(const float* __restrict__ src,
                                            float2* __restrict__ dst,
                                            long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    uint32_t hi, lo;
    split(src[i], hi, lo);
    dst[i] = make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
}

// the card's SM count (132 if it cannot be read)
inline int sm_count() {
  static int n = 0;
  if (n <= 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess || n <= 0)
      n = 132;
  }
  return n;
}

inline int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

// bytes rounded up to 256, so each workspace region starts aligned
inline long long align256(long long b) { return (b + 255) / 256 * 256; }

// blocks of 256 threads for a grid-strided elementwise pass over n values
inline int pass_blocks(long long n) {
  const long long most = 16LL * sm_count();
  return (int)(n / 256 + 1 < most ? n / 256 + 1 : most);
}

}  // namespace ptt_gemm
