// The bf16 tensor-core GEMM tile loop of the LM head under AMP
// (lm_head_bf16.cu): gemm_tc.cuh's loop with bf16 operands and one
// mma.sync m16n8k16 per product, no split and no pre-pass.
//
// A CTA of 8 warps (2 along M x 4 along N) computes a kBM x kBN = 128 x 128
// tile of A . B, a 64 x 32 tile a warp (gemm_tc.cuh's Acc: 4 x 4 m16n8
// accumulators), over k-tiles of kBK = 64.  The k-tiles are staged by
// cp.async into a ring of 3-4 stages in dynamic shared memory, issued
// kStages - 1 k-tiles ahead of their use, with one __syncthreads a k-tile,
// as in gemm_tc.cuh.  A CTA may run several output tiles along N; the
// caller's epilogue sees each tile's accumulators.
//
// The tensor cores truncate as they add products to an accumulator
// (gemm_tc.cuh), so as there the products of a k-tile (4 mma per
// accumulator) go into a second accumulator that is added to the first by
// f32 adds, which round to nearest, after every k-tile.
//
// Each operand is contiguous along one index with rows of `ld` elements
// along the other; which index is contiguous is a template parameter (AK:
// A is k-contiguous, x or dlogits, else m-contiguous, x^T; BN: B is
// n-contiguous, W or dlogits, else k-contiguous, W^T).  A staged tile keeps
// the global layout, [rows][cols + 8] bf16, and ldmatrix (bf16_mma.cuh)
// reads every fragment from it, .trans where the contiguous index is not
// the one the fragment pairs.  The copy path is chosen on the host from
// the operand's address and row length (operand()): 16-byte copies of 8
// elements where rows are 16-byte aligned, else element copies through
// registers (an odd D or V).  Elements outside [M, N] and k outside
// [kb, ke) are zero-filled, so any shape works.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "gemm_tc.cuh"

namespace ptt_gemm_bf16 {

using ptt_bf16::bf16;
using ptt_gemm::Acc;
using ptt_gemm::kBM;
using ptt_gemm::kBN;
using ptt_gemm::kMI;
using ptt_gemm::kNJ;
using ptt_gemm::kThreads;
using ptt_gemm::kWarpsN;
using ptt_gemm::kWM;
using ptt_gemm::kWN;

constexpr int kBK = 64;            // a k-tile
constexpr int kSmemMax = 232448;   // a CTA's shared memory

// A bf16 operand: element (r, c) is p[r * ld + c], c the contiguous index
struct Operand {
  const bf16* p;
  long long ld;
  int copy16;  // 16-byte copies (rows 16-byte aligned), else element copies
};

inline Operand operand(const bf16* p, long long ld) {
  return Operand{p, ld,
                 reinterpret_cast<uintptr_t>(p) % 16 == 0 && ld % 8 == 0};
}

// an R x C tile of bf16, C along the contiguous index
template <int R, int C>
struct Tile {
  static constexpr int kR = R, kC = C, kLD = C + 8;
  static constexpr int kElems = R * kLD;
};

template <bool AK, bool BN>
struct Layout {
  using A = Tile<AK ? kBM : kBK, AK ? kBK : kBM>;
  using B = Tile<BN ? kBK : kBN, BN ? kBN : kBK>;
  static constexpr int kStageElems = A::kElems + B::kElems;
  static constexpr int kFit = kSmemMax / (kStageElems * 2);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kSmemBytes = kStages * kStageElems * 2;
  static_assert(kStages >= 2, "a stage must fit twice");
};

// S[r][c] <- p[(r0 + r) * ld + c0 + c] for r0 + r < rend and c0 + c < cend,
// else zero: issues this thread's cp.async copies, or copies through
// registers where the operand's rows are not 16-byte aligned
template <class T>
__device__ __forceinline__ void stage(bf16* S, const Operand& o, int r0,
                                      int rend, int c0, int cend) {
  const int tid = threadIdx.x;
  const bf16 zero = __float2bfloat16_rn(0.f);
  if (o.copy16) {
    constexpr int CH = T::kC / 8, RS = kThreads / CH;
    const int c = 8 * (tid % CH), gc = c0 + c;
    const int n = cend - gc;   // elements of this chunk inside the row
#pragma unroll
    for (int i = 0; i < T::kR / RS; ++i) {
      const int r = tid / CH + i * RS, gr = r0 + r;
      bf16* dst = S + r * T::kLD + c;
      const bf16* src = o.p + (long long)gr * o.ld + gc;
      if (gr < rend && n >= 8) {
        ptt_mma::cp_async16(dst, src, true);
      } else if (gr >= rend || n <= 0) {
        ptt_mma::cp_async16(dst, o.p, false);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) dst[e] = e < n ? src[e] : zero;
      }
    }
  } else {
    for (int i = tid; i < T::kR * T::kC; i += kThreads) {
      const int r = i / T::kC, c = i % T::kC, gr = r0 + r, gc = c0 + c;
      S[r * T::kLD + c] = gr < rend && gc < cend
                              ? o.p[(long long)gr * o.ld + gc] : zero;
    }
  }
}

// part += the products of one staged k-tile (tiles As, Bs): kBK / 16 k16
// steps over the warp's kMI x kNJ accumulators
template <class TA, class TB, bool AK, bool BN>
__device__ __forceinline__ void ktile_products(Acc& part, const bf16* As,
                                               const bf16* Bs) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
#pragma unroll
  for (int kk = 0; kk < kBK; kk += 16) {
    uint32_t a[kMI][4], b[kNJ / 2][4];
#pragma unroll
    for (int i = 0; i < kMI; ++i) {
      if (AK)
        ptt_bf16::load_a_mk(a[i], As, TA::kLD, wm + 16 * i, kk, lane);
      else
        ptt_bf16::load_a_km(a[i], As, TA::kLD, wm + 16 * i, kk, lane);
    }
#pragma unroll
    for (int jp = 0; jp < kNJ / 2; ++jp) {
      if (BN)
        ptt_bf16::load_b_kn(b[jp], Bs, TB::kLD, kk, wn + 16 * jp, lane);
      else
        ptt_bf16::load_b_nk(b[jp], Bs, TB::kLD, kk, wn + 16 * jp, lane);
    }
#pragma unroll
    for (int i = 0; i < kMI; ++i)
#pragma unroll
      for (int jp = 0; jp < kNJ / 2; ++jp) {
        ptt_bf16::mma(part.v[i][2 * jp], a[i], b[jp][0], b[jp][1]);
        ptt_bf16::mma(part.v[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
      }
  }
}

// Runs the output tiles (m0, n0 + i kBN), i < count, of A [M, K] . B [K, N]
// over k in [kb, ke) and calls epi(acc, n) after each, n its first column.
// smem holds Layout<AK, BN>::kSmemBytes; it is free again on return.
template <bool AK, bool BN, class Epi>
__device__ __forceinline__ void run_tiles(const Operand A, const Operand B,
                                          int M, int N, int kb, int ke,
                                          int m0, int n0, int count,
                                          bf16* smem, Epi&& epi) {
  using L = Layout<AK, BN>;
  using TA = typename L::A;
  using TB = typename L::B;
  constexpr int S = L::kStages;
  const int nk = (ke - kb + kBK - 1) / kBK;
  const int total = count * nk;

  auto issue = [&](int f) {
    bf16* As = smem + (f % S) * L::kStageElems;
    bf16* Bs = As + TA::kElems;
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
  ptt_gemm::zero(acc);
  ptt_gemm::zero(part);
#pragma unroll
  for (int f = 0; f < S - 1; ++f) {
    if (f < total) issue(f);
    ptt_mma::cp_commit();
  }
  for (int f = 0; f < total; ++f) {
    ptt_mma::cp_wait<S - 2>();   // k-tile f has landed (this thread's)
    __syncthreads();             // ... every thread's; slot (f-1) % S free
    if (f + S - 1 < total) issue(f + S - 1);
    ptt_mma::cp_commit();
    const bf16* As = smem + (f % S) * L::kStageElems;
    ktile_products<TA, TB, AK, BN>(part, As, As + TA::kElems);
    ptt_gemm::flush(acc, part);
    if (f % nk == nk - 1) {   // the output tile's last k-tile
      epi(acc, n0 + (f / nk) * kBN);
      ptt_gemm::zero(acc);
    }
  }
  ptt_mma::cp_wait<0>();
  __syncthreads();
}

template <bool AK, bool BN, class K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              Layout<AK, BN>::kSmemBytes);
}

}  // namespace ptt_gemm_bf16
