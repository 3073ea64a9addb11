// Flash attention, forward and backward, in bf16 for Hopper (sm_90a), on
// the tensor cores: the kernels of the attention paths under
// FLAGS_amp_bf16.
//
// Replaces the Pallas TPU kernels
// paddle_tpu/kernels/flash_attention.py:_flash_fwd_hdt (body
// _fwd_kernel_hdt) and _flash_bwd_hdt (bodies _bwd_fused1_kernel_hdt,
// _bwd_fused_kernel_hdt, _bwd_dkv_kernel_hdt and _bwd_dq_kernel_hdt) as
// they run on bf16 q, k and v, which fused_mha hands them under AMP, and
// _flash_fwd (body _fwd_kernel) and _flash_bwd (bodies _bwd_fused1_kernel,
// _bwd_dkv_kernel and _bwd_dq_kernel) on the bf16 [B, H, T, d] views that
// fused_attention, the fused block's backward recompute and the bf16 block
// kernel (fused_block_bf16.cu) hand them.  For each head h and batch row
// b, with q' = bf16(q * bf16(scale)):
//   forward:  s = q' k^T (f32),  p = exp(s - m) (f32, m the running max),
//             o = bf16((sum bf16(p) v) / sum p),  lse = m + log sum p (f32)
//   backward: p = exp(s - lse),  ds = p * (do v^T - delta)   (f32)
//             dv = bf16(sum bf16(p)^T do),  dk = bf16(sum bf16(ds)^T q'),
//             dq = bf16(scale * sum bf16(ds) k)
// These are the Pallas kernel's roundings (flash_attention.py:529, :542,
// :586, :588, :615; in the [B, H, T, d] kernels :85, :108, :229, :237,
// :240, :267, :273); delta = rowsum(do * o) comes in f32 from the caller,
// taken before do is rounded to bf16 (:763-765, :329-331).  Masked: keys after the
// query (causal), keys >= kv_len, and the ragged tails of every tile.
// Every operand comes with (batch, head, feature, token) element strides.
//
// Bound on the H100 at B 32, H 8, T 512, d 64, causal: bytes.  The forward
// moves q, k, v and o in bf16 and lse in f32 once (67 MB, 0.020 ms at
// 3.35 TB/s); its work is 4 d FLOP per kept (query, key) pair, 8.607 GFLOP,
// 0.0087 ms at 989 TFLOP/s.  The backward moves q, k, v, do, dq, dk, dv in
// bf16 and lse, delta in f32 (134 MB, 0.040 ms); its least work is 10 d
// FLOP per kept pair, 21.517 GFLOP, 0.022 ms.
//
// Two forward kernels, chosen by the caller from the operands before the
// launch (kernels/flash_attention.py fwd_bf16_path; the C entry's path):
//   wgmma (flash_fwd_bf16_wg_kernel) where TMA can describe q, k, v and o
//     (wg_ok: 16-byte-aligned bases, all in token rows or all in feature
//     rows, the other strides multiples of 16 bytes, T % 8 == 0 in feature
//     rows), d 64 or 128;
//   sync (flash_fwd_bf16_kernel, below) on any operands.
// Two backward kernel pairs (dk/dv, then dq), chosen the same way
// (bwd_bf16_path): wgmma (flash_bwd_dkv_bf16_wg_kernel and
// flash_bwd_dq_bf16_wg_kernel, the section "the backward on wgmma") where
// TMA can describe q, k and v in one orientation and do, dq, dk and dv each
// in its own (bwd_wg_ok), d 64 or 128; sync (flash_bwd_dkv_bf16_kernel and
// flash_bwd_dq_bf16_kernel) on any operands.
//
// The wgmma forward, for Hopper's warpgroup tensor cores.  A persistent
// grid, one CTA per SM (min(work tiles, SMs)); a work tile is 128 queries
// of one (batch row, head), the tiles of a (batch row, head) side by side
// in the schedule (wg_work) so that CTAs running at one time read its k and
// v from the L2.  288 threads: two consumer warpgroups of 64 queries each
// and a producer warp whose lane 0 issues TMA loads (128-byte swizzle;
// 4-D tensor maps of (D, T, H, B) or (T, D, H, B), T its own dimension so
// that rows past a batch row's T arrive as zeros): q into two buffers
// (the next tile's q lands while this one runs), k and v blocks of 128
// keys (64 at d 128) into a ring of 4 stages (3 at d 128) guarded by
// full/empty mbarriers.  Each block is s = q' k^T (wgmma m64nNk16, both
// operands in shared memory) and o += bf16(p) v (wgmma with A = p from
// registers: the f32 accumulator of s packs pairwise into the bf16 A
// fragment, no shuffle); operands are read in their own layouts, the
// transpose bits set where one is MN-major (Tok).  A warpgroup issues
// this block's s and the previous block's p v back to back and runs this
// block's softmax while p v runs; the two warpgroups issue their products
// in turns (named barriers), so that one's softmax overlaps the other's
// products.  The online softmax is in f32 over each row's quad, its
// exponent one FMA and one ex2.approx; the first block of a tile and those
// that reach past the diagonal or kend are masked.  q' = bf16(q bf16(scale))
// is formed in shared memory (a fence.proxy.async before the wgmma reads
// it), or, where bf16(scale) is a power of two, folded into the exponent
// with the same bits (WgArgs).  o = acc / l is rounded once, staged by
// each warp and written by 16-byte stores along o's contiguous dimension.
// Cold at B 32, H 8, T 512, d 64, causal: see PERF.md §6 (about 0.04 ms
// against the sync kernel's 0.088, 2x its byte bound): the softmax
// (ex2 and its FMA, max and sum per score, 64 a thread a block) runs at
// about the rate of the products, and each of a CTA's eight tiles pays
// its first block's s and softmax and its epilogue unoverlapped.
//
// The sync forward and the backward: FlashAttention-2 on mma.sync m16n8k16
// bf16 with f32 accumulators (bf16_mma.cuh: fragments, ldmatrix, packing),
// one product per product: no split.  Triton is not used: the kernels need
// exact control of where p and ds are rounded and of the fragment layout
// that lets them feed the next product from registers.  A CTA is 4 warps, 16 tile rows a warp.
// Operand tiles are staged in one of two layouts, chosen per call on the
// host from the inputs' strides (Tiles<D, TR> below):
//   feature rows, [d][64 + 8] bf16, tokens along a row: the head-major
//     layout's own order (token stride 1).  Where rows are 16-byte aligned
//     (T a multiple of 8) a tile is copied by 16-byte cp.async, 8 tokens a
//     copy;
//   token rows, [64][d + 8] bf16, features along a row: taken when every
//     input has feature stride 1 ([B, H, T, d], the [B, T, H, d] views of
//     a [B, T, E] projection, the block's [N, 3E] q/k/v).  Where rows are
//     16-byte aligned (token, head and batch strides multiples of 8) a
//     tile is copied by 16-byte cp.async, 8 features a copy.
// Anything else (a ragged head-major T, a view 2 bytes off alignment, a
// layout with neither stride 1) is copied element by element through
// registers.  Both layouts hold the same values, and ldmatrix (.trans where
// the tile's rows are not the fragment's pairs) gives the same fragments
// from either, so the products and the bits of every result do not depend
// on the layout.  Outputs are written through their strides from
// registers, two neighbouring features by one 4-byte store where the
// feature stride is 1.
//   forward: one CTA per (64-query tile, batch row, head), the last tile
//     first.  The query tile is staged once, scaled to q' in shared
//     memory and kept as A fragments in registers; key and value tiles are
//     double-buffered by cp.async; per block of 64 keys (32 at d 128) s
//     stays in accumulators, the online softmax runs in f32 over the 4
//     lanes of a quad, and p, packed to bf16, is the A operand of p v.
//   backward, two kernels, no atomics, the same bits on every run:
//     dk/dv: one CTA per (64-key tile, batch row, head).  k and v stay in
//       shared memory while the CTA walks the query tiles from the causal
//       diagonal, (q, do, lse, delta) double-buffered; each staged q tile
//       is scaled to q' in place.  Per block of 16 queries s^T = k q'^T and
//       dp^T = v do^T land in accumulators, p^T and ds^T are formed there
//       and packed as the A operands of dv += p^T do and dk += ds^T q'.
//     dq: one CTA per (64-query tile, batch row, head); q' and do stay as
//       A fragments in registers while the CTA walks the key tiles, k and
//       v double-buffered; s and dp per block of 64 keys (32 at d 128),
//       ds packed as the A operand of dq += ds k.
// Shared memory (bf16 tiles of d x 72, or 64 x (d + 8)): forward 5 tiles,
// 46,080 bytes at d 64 and 92,160 (87,040 in token rows) at d 128;
// backward 6 tiles (+ 1 KB of lse and delta), 56,320 and 111,616 (105,472)
// bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_mma.cuh"
#include "gemm_tc.cuh"
#include "tf32_mma.cuh"
#include "tma_maps.cuh"
#include "wgmma_bf16.cuh"

namespace {

using ptt_bf16::bf16;
using ptt_mma::cp_async16;
using ptt_mma::cp_async4;
using ptt_mma::cp_commit;
using ptt_mma::cp_wait;

constexpr int kTile = 64;      // tokens per tile, queries and keys
constexpr int kThreads = 128;  // 4 warps, 16 tile rows each
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// element strides of one operand: batch row, head, feature, token
struct Strides {
  long long b, h, d, t;
};

// 16-byte copies in feature rows: token stride 1 and every feature row of
// every (batch row, head) starting on 16 bytes
inline int vec16_fr(const void* base, const Strides& s) {
  return s.t == 1 && reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
         s.b % 8 == 0 && s.h % 8 == 0 && s.d % 8 == 0;
}

// 16-byte copies in token rows: feature stride 1 and every token row of
// every (batch row, head) starting on 16 bytes
inline int vec16_tr(const void* base, const Strides& s) {
  return s.d == 1 && reinterpret_cast<uintptr_t>(base) % 16 == 0 &&
         s.b % 8 == 0 && s.h % 8 == 0 && s.t % 8 == 0;
}

// A staged 64-token tile of d features: feature rows [D][64 + 8] (TR
// false) or token rows [64][D + 8] (TR true), and the fragment loads the
// kernels take from it, named by what the fragment's indices are:
//   a_tf: an A fragment, m = tokens tok0.., k = features f0..
//   b_ft: a B fragment pair, k = features f0.., n = tokens tok0..
//   b_tf: a B fragment pair, k = tokens tok0.., n = features f0..
template <int D, bool TR>
struct Tiles {
  static constexpr int kLD = TR ? D + 8 : kTile + 8;
  static constexpr int kElems = TR ? kTile * kLD : D * kLD;
  __device__ __forceinline__ static void a_tf(uint32_t (&a)[4], const bf16* S,
                                              int tok0, int f0, int lane) {
    if (TR)
      ptt_bf16::load_a_mk(a, S, kLD, tok0, f0, lane);
    else
      ptt_bf16::load_a_km(a, S, kLD, tok0, f0, lane);
  }
  __device__ __forceinline__ static void b_ft(uint32_t (&b)[4], const bf16* S,
                                              int f0, int tok0, int lane) {
    if (TR)
      ptt_bf16::load_b_nk(b, S, kLD, f0, tok0, lane);
    else
      ptt_bf16::load_b_kn(b, S, kLD, f0, tok0, lane);
  }
  __device__ __forceinline__ static void b_tf(uint32_t (&b)[4], const bf16* S,
                                              int tok0, int f0, int lane) {
    if (TR)
      ptt_bf16::load_b_kn(b, S, kLD, tok0, f0, lane);
    else
      ptt_bf16::load_b_nk(b, S, kLD, tok0, f0, lane);
  }

  // S <- base[feature f, token t0 + r] for t0 + r < tend, else 0, r < 64:
  // issues the tile's cp.async copies (the caller commits and waits), or
  // copies through registers where it cannot (vec 0)
  __device__ __forceinline__ static void stage(bf16* S, const bf16* base,
                                               const Strides& s, int t0,
                                               int tend, int vec) {
    const bf16 zero = __float2bfloat16_rn(0.f);
    if (vec && TR) {
      constexpr int CH = D / 8;   // 16-byte chunks a token row
      for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
        const int r = i / CH, c = i % CH, tok = t0 + r;
        const bool in = tok < tend;
        ptt_mma::cp_async16(S + r * kLD + 8 * c,
                            in ? base + tok * s.t + 8 * c : base, in);
      }
    } else if (vec) {
      constexpr int CH = kTile / 8;   // 16-byte chunks a feature row
      for (int i = threadIdx.x; i < D * CH; i += kThreads) {
        const int f = i / CH, c = i % CH, tok = t0 + 8 * c;
        bf16* dst = S + f * kLD + 8 * c;
        const bf16* src = base + f * s.d + tok;
        if (tok + 8 <= tend) {
          ptt_mma::cp_async16(dst, src, true);
        } else if (tok >= tend) {
          ptt_mma::cp_async16(dst, base, false);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) dst[e] = tok + e < tend ? src[e] : zero;
        }
      }
    } else if (TR) {   // neighbouring threads on neighbouring features
      for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
        const int r = i / D, f = i % D, tok = t0 + r;
        S[r * kLD + f] = tok < tend ? base[f * s.d + tok * s.t] : zero;
      }
    } else {           // ... on neighbouring tokens
      for (int i = threadIdx.x; i < D * kTile; i += kThreads) {
        const int f = i / kTile, r = i % kTile, tok = t0 + r;
        S[f * kLD + r] = tok < tend ? base[f * s.d + tok * s.t] : zero;
      }
    }
  }

  // S <- bf16(S * sb) over a staged tile's 64 tokens: q' from q
  __device__ __forceinline__ static void scale(bf16* S, float sb) {
    for (int i = threadIdx.x; i < D * kTile; i += kThreads) {
      bf16& e = TR ? S[i / D * kLD + i % D] : S[i / kTile * kLD + i % kTile];
      e = __float2bfloat16_rn(__bfloat162float(e) * sb);
    }
  }
};

// p[0] <- bf16(v0), p[fs] <- bf16(v1): two neighbouring features of a
// row, by one 4-byte store where they are adjacent and aligned
__device__ __forceinline__ void store_pair(bf16* p, long long fs, float v0,
                                           float v1) {
  if (fs == 1 && reinterpret_cast<uintptr_t>(p) % 4 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v0, v1);
  } else {
    p[0] = __float2bfloat16_rn(v0);
    p[fs] = __float2bfloat16_rn(v1);
  }
}

// S[i] <- base[t0 + i] for t0 + i < tend, else 0 (f32 lse, delta rows)
__device__ __forceinline__ void stage_row(float* S, const float* base,
                                          int t0, int tend, int i) {
  const bool in = t0 + i < tend;
  cp_async4(S + i, in ? base + t0 + i : base, in);
}

// acc[f] (rows r0, r0 + 8 of the warp; features 8 f + 2t, + 1) times mul,
// rounded to bf16, through out's strides, for rows < T
template <int NF>
__device__ __forceinline__ void write_rows(bf16* out, const Strides& s,
                                           int b, int h, int T, int r0,
                                           int t, float mul0, float mul1,
                                           const float (&acc)[NF][4]) {
  bf16* base = out + b * s.b + h * s.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= T) continue;
    const float mul = half ? mul1 : mul0;
    bf16* p = base + row * s.t;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      store_pair(p + (8 * f + 2 * t) * s.d, s.d, mul * acc[f][2 * half],
                 mul * acc[f][2 * half + 1]);
  }
}

template <int D, bool TR>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const bf16* __restrict__ q,
                          const bf16* __restrict__ k,
                          const bf16* __restrict__ v, bf16* __restrict__ o,
                          float* __restrict__ lse, int H, int Tq, int Tk,
                          int kv_len, int causal, float scale, Strides qs,
                          Strides ks, Strides vs, Strides os, long long ls_b,
                          long long ls_h, int vq, int vk, int vv) {
  using Tl = Tiles<D, TR>;
  constexpr int TE = Tl::kElems, NF = D / 8, KF = D / 16;
  constexpr int KN = D == 64 ? 64 : 32, NJ = KN / 8;   // keys per block
  extern __shared__ float4 smem4[];
  bf16* sm = reinterpret_cast<bf16*>(smem4);  // stage s: k at 2s TE, v after
  bf16* Qs = sm + 4 * TE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int wr = 16 * warp;
  const int qr0 = q0 + wr + g, qr1 = qr0 + 8;

  const bf16* kh = k + b * ks.b + h * ks.h;
  const bf16* vh = v + b * vs.b + h * vs.h;
  int kend = min(Tk, kv_len);
  if (causal) kend = min(kend, q0 + kTile);
  const int ntiles = (kend + kTile - 1) / kTile;

  Tl::stage(Qs, q + b * qs.b + h * qs.h, qs, q0, Tq, vq);
  Tl::stage(sm, kh, ks, 0, kend, vk);
  Tl::stage(sm + TE, vh, vs, 0, kend, vv);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  Tl::scale(Qs, __bfloat162float(__float2bfloat16_rn(scale)));
  __syncthreads();
  uint32_t qf[KF][4];   // q' rows of the warp as A fragments, k = features
#pragma unroll
  for (int kk = 0; kk < KF; ++kk) Tl::a_tf(qf[kk], Qs, wr, 16 * kk, lane);

  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kTile;
    if (it + 1 < ntiles) {
      bf16* nb = sm + ((it + 1) & 1) * 2 * TE;
      Tl::stage(nb, kh, ks, k0 + kTile, kend, vk);
      Tl::stage(nb + TE, vh, vs, k0 + kTile, kend, vv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = sm + (it & 1) * 2 * TE;
    const bf16* Vs = Ks + TE;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += KN) {
      const int kb = k0 + c0;
      if (kb >= kend || (causal && kb > q0 + wr + 15)) continue;
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KF; ++kk)
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {   // s = q' k^T
          uint32_t bk[4];
          Tl::b_ft(bk, Ks, 16 * kk, c0 + 16 * jp, lane);
          ptt_bf16::mma(s[2 * jp], qf[kk], bk[0], bk[1]);
          ptt_bf16::mma(s[2 * jp + 1], qf[kk], bk[2], bk[3]);
        }

      if (kb + KN > kend || (causal && kb + KN - 1 > q0 + wr)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? qr0 : qr1;
            if (key >= kend || (causal && key > row)) s[j][e] = kNegInf;
          }
      }

      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0r = exp2f((m0 - mx0) * kLog2e);
      const float c1r = exp2f((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][0] = exp2f((s[j][0] - mx0) * kLog2e);
        s[j][1] = exp2f((s[j][1] - mx0) * kLog2e);
        s[j][2] = exp2f((s[j][2] - mx1) * kLog2e);
        s[j][3] = exp2f((s[j][3] - mx1) * kLog2e);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 = l0 * c0r + ps0;   // this lane's share; the quad's sum at the end
      l1 = l1 * c1r + ps1;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        acc[f][0] *= c0r;
        acc[f][1] *= c0r;
        acc[f][2] *= c1r;
        acc[f][3] *= c1r;
      }

      // o += bf16(p) v: k runs over the block's keys, 16 at a time
#pragma unroll
      for (int J = 0; J < NJ / 2; ++J) {
        uint32_t pa[4];
        ptt_bf16::a_from_c(pa, s[2 * J], s[2 * J + 1]);
#pragma unroll
        for (int fp = 0; fp < NF / 2; ++fp) {
          uint32_t bv[4];
          Tl::b_tf(bv, Vs, c0 + 16 * J, 16 * fp, lane);
          ptt_bf16::mma(acc[2 * fp], pa, bv[0], bv[1]);
          ptt_bf16::mma(acc[2 * fp + 1], pa, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  // o = acc / l, as the Pallas kernel divides before its one rounding
  bf16* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? qr1 : qr0;
    if (row >= Tq) continue;
    const float l = half ? l1 : l0;
    bf16* orow = oh + row * os.t;
#pragma unroll
    for (int f = 0; f < NF; ++f)
      store_pair(orow + (8 * f + 2 * t) * os.d, os.d, acc[f][2 * half] / l,
                 acc[f][2 * half + 1] / l);
    if (t == 0) lse[b * ls_b + h * ls_h + row] = (half ? m1 : m0) + logf(l);
  }
}

// ---- the forward on wgmma (sm_90a): TMA, an mbarrier ring, warpgroups ----

constexpr int kWgM = 128;   // queries a work tile, 64 a consumer warpgroup

template <int D>
struct WgCfg {
  static constexpr int kN = D == 64 ? 128 : 64;   // keys a block
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kQBytes = kWgM * D * 2;
  static constexpr int kBlockBytes = kN * D * 2;   // a k or a v block
  static constexpr int kStageBytes = 2 * kBlockBytes;
  // a warpgroup's o tile: [64][D + 8] (token rows) or [D][64 + 8]
  static constexpr int kEpiElems =
      64 * (D + 8) > D * (64 + 8) ? 64 * (D + 8) : D * (64 + 8);
  static constexpr int kEpiBytes = 2 * kEpiElems;
  static constexpr int kSmemBytes = 1024 + 2 * kQBytes +
                                    kStages * kStageBytes + 2 * kEpiBytes +
                                    8 * (2 * kStages + 4);
};

// A tile of R tokens x D features of one (batch row, head) in shared memory
// as TMA writes it with 128-byte swizzle: in token rows (TR, feature stride
// 1) D / 64 boxes of [R][64], a row per token; in feature rows (token stride
// 1) R / 64 boxes of [D][64], a row per feature.  Its wgmma descriptors by
// role, with the transpose bit each needs (1: the operand is MN-major):
//   a_tf: A, M = the 64 tokens from r0, K = features 16 j ..;
//   b_ft: B, K = features 16 j .., N = the R tokens;
//   b_tf: B, K = tokens 16 J .., N = the D features.
template <int D, int R, bool TR>
struct Tok {
  enum : int { kTA = !TR, kTFT = !TR, kTTF = TR };
  // tokens t0 .. t0 + R of (batch row b, head h): maps of dims (D, T, H, B)
  // in token rows, (T, D, H, B) in feature rows (wg_map)
  __device__ __forceinline__ static void load(uint32_t dst,
                                              const CUtensorMap* m,
                                              uint32_t bar, int t0, int h,
                                              int b) {
    if (TR) {
#pragma unroll
      for (int i = 0; i < D / 64; ++i)
        ptt_wg::tma_load4(dst + i * (R * 128), m, bar, 64 * i, t0, h, b);
    } else {
#pragma unroll
      for (int i = 0; i < R / 64; ++i)
        ptt_wg::tma_load4(dst + i * (D * 128), m, bar, t0 + 64 * i, 0, h, b);
    }
  }
  __device__ __forceinline__ static uint64_t a_tf(uint32_t t, int r0, int j) {
    if (TR)
      return ptt_wg::make_desc(
          t + (j >> 2) * (R * 128) + r0 * 128 + (j & 3) * 32, 16, 1024);
    return ptt_wg::make_desc(t + (r0 >> 6) * (D * 128) + j * 2048, D * 128,
                             1024);
  }
  __device__ __forceinline__ static uint64_t b_ft(uint32_t t, int j) {
    if (TR)
      return ptt_wg::make_desc(t + (j >> 2) * (R * 128) + (j & 3) * 32, 16,
                               1024);
    return ptt_wg::make_desc(t + j * 2048, D * 128, 1024);
  }
  __device__ __forceinline__ static uint64_t b_tf(uint32_t t, int J) {
    if (TR) return ptt_wg::make_desc(t + J * 2048, R * 128, 1024);
    return ptt_wg::make_desc(t + (J >> 2) * (D * 128) + (J & 3) * 32, 16,
                             1024);
  }
};

struct WgArgs {
  bf16* o;
  float* lse;
  Strides os;                 // o's (batch, head, feature, token) strides
  long long ls_b, ls_h;
  int B, H, Tq, kend, causal;
  int nqt, tiles;             // query tiles of a (batch row, head); all
  float sb;                   // bf16(scale)
  // where sb is a power of two, q' = q sb exactly and s = q' k^T = sb (q
  // k^T) bit for bit, so the kernel skips scaling q and takes s in units
  // of q k^T: the softmax's exponent multiplies by sl = sb log2 e instead
  // of log2 e, and lse by lse_mul = sb; else sl = log2 e, lse_mul = 1
  int scale_q;
  float sl, lse_mul;
};

// Work tile t of the persistent schedule (kernels/flash_attention.py
// fwd_bf16_schedule): CTA c takes t = c, c + grid, ...; the nqt query tiles
// of one (batch row, head) are consecutive, so CTAs that run at one time
// read its k and v blocks from the L2, and tile j of them is query tile nqt
// - 1 - (j + bh) % nqt, so that under a causal mask a CTA's heavy and light
// tiles alternate from one pass of the grid to the next.  nfree of the
// tile's nblk key blocks (of kN keys; kend keys of H heads) need no mask:
// every key of theirs is kept for every query of the tile.  The dq
// backward kernel takes the same order.
struct WgWork {
  int b, h, q0, kend, nblk, nfree;
};

__device__ __forceinline__ WgWork wg_work(int t, int nqt, int H, int kend,
                                          int causal, int kN) {
  WgWork w;
  const int bh = t / nqt, j = t % nqt;
  w.b = bh / H;
  w.h = bh % H;
  w.q0 = (nqt - 1 - (j + bh) % nqt) * kWgM;
  w.kend = causal ? min(kend, w.q0 + kWgM) : kend;
  w.nblk = (w.kend + kN - 1) / kN;
  w.nfree = w.kend / kN;
  if (causal) w.nfree = min(w.nfree, w.q0 / kN);
  return w;
}

// q <- bf16(q * sb) over warpgroup wg's 64 queries of the staged q tile,
// 16 bytes a thread at a time: the rows its A descriptors read
template <int D, bool TR>
__device__ __forceinline__ void scale_q(uint8_t* q, int wg, int tid,
                                        float sb) {
  constexpr int kChunks = 64 * D * 2 / 16;
#pragma unroll
  for (int c = tid; c < kChunks; c += 128) {
    uint8_t* at = TR ? q + (c >> 9) * (kWgM * 128) + wg * 64 * 128 +
                           (c & 511) * 16
                     : q + wg * (D * 128) + c * 16;
    uint4 v = *reinterpret_cast<uint4*>(at);
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      e[i] = __floats2bfloat162_rn(f.x * sb, f.y * sb);
    }
    *reinterpret_cast<uint4*>(at) = v;
  }
}

// The products of a warpgroup's 64 queries, issued as commit groups: s =
// q' k^T (both operands in shared memory) and o += bf16(p) v (A = p from
// registers).
template <int D, bool TR>
__device__ __forceinline__ void issue_s(float (&s)[WgCfg<D>::kN / 2],
                                        uint32_t sq, uint32_t ks, int wg) {
  using Q = Tok<D, kWgM, TR>;
  using K = Tok<D, WgCfg<D>::kN, TR>;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    ptt_wg::wgmma_ss<Q::kTA, K::kTFT>(s, Q::a_tf(sq, 64 * wg, j),
                                      K::b_ft(ks, j), j > 0);
  ptt_wg::wgmma_commit();
}

template <int D, bool TR>
__device__ __forceinline__ void issue_pv(
    float (&o)[D / 2], const uint32_t (&pa)[WgCfg<D>::kN / 16][4],
    uint32_t vs) {
  using V = Tok<D, WgCfg<D>::kN, TR>;
#pragma unroll
  for (int J = 0; J < WgCfg<D>::kN / 16; ++J)
    ptt_wg::wgmma_rs<V::kTTF>(o, pa[J], V::b_tf(vs, J), 1);
  ptt_wg::wgmma_commit();
}

// The online softmax of one key block in f32, s[4 j + 2 i + e] the score of
// row row0 + 8 i and key k0 + 8 j + c0 + e: MASK sets keys >= kend and,
// causal, after the query to -inf; the row max m over each row's quad;
// s <- p = 2^(s sl - m sl) (one FMA and one ex2.approx each; sl =
// log2 e, or sb log2 e where s is in units of q k^T, WgArgs); l (this
// lane's share of the row sums) and the factor c that rescales o.
template <int N, bool MASK>
__device__ __forceinline__ void softmax(float (&s)[N], float (&m)[2],
                                        float (&l)[2], float (&c)[2], int k0,
                                        int kend, int causal, int row0,
                                        int c0, float sl) {
  if (MASK) {
    // the row's keys past lim[i] (counted from this lane's first key) go
    int lim[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = (causal ? min(kend, row0 + 8 * i + 1) : kend) - k0 - c0;
#pragma unroll
    for (int j = 0; j < N / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = 8 * j + (e & 1) >= lim[e >> 1] ? kNegInf : s[4 * j + e];
  }
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float ml[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    c[i] = ptt_bf16::ex2((m[i] - mx[i]) * sl);
    ml[i] = mx[i] * sl;
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[4 * j + e] = ptt_bf16::ex2(fmaf(s[4 * j + e], sl, -ml[e >> 1]));
      ps[e >> 1] += s[4 * j + e];
    }
  l[0] = l[0] * c[0] + ps[0];
  l[1] = l[1] * c[1] + ps[1];
}

// p as the A fragments of o += p v, k16 step J over keys 16 J ..: the
// accumulator's two 8-key column groups, packed pairwise to bf16 (no
// shuffle: the m16n8k16 A layout is two C tiles side by side)
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[N / 8][4],
                                       const float (&s)[N]) {
#pragma unroll
  for (int J = 0; J < N / 8; ++J)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[J][r] = ptt_bf16::pack(s[8 * J + 2 * r], s[8 * J + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&c)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= c[0];
    o[4 * j + 1] *= c[0];
    o[4 * j + 2] *= c[1];
    o[4 * j + 3] *= c[1];
  }
}

// The two warpgroups issue their products in turns (named barriers 3 and
// 4, 256 threads: one warpgroup waits, the other arrives), so that one's
// products run on the tensor cores while the other runs its softmax.
__device__ __forceinline__ void pp_sync(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + wg) : "memory");
}
__device__ __forceinline__ void pp_arrive(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - wg) : "memory");
}

// The state a warpgroup carries through a work tile's key blocks: the
// scores of the block in flight, p of the block before it as A fragments,
// o, the row max and sums, the pending rescale of o, and the ring slot
// whose v the next p v reads.
template <int D>
struct WgRow {
  static constexpr int kN = WgCfg<D>::kN;
  float s[kN / 2];
  uint32_t pa[kN / 16][4];
  float o[D / 2];
  float m[2], l[2], c[2];
  int prev;
};

// Key block blk after the first, pipelined: s of this block and p v of the
// previous one are issued back to back, so the tensor cores run p v while
// this block's softmax runs; then o is rescaled and this block's p packed.
// No read of an accumulator sits under a branch (ptxas serializes every
// wgmma of a kernel that has one, C7518).
template <int D, bool TR, bool MASK>
__device__ __forceinline__ void wg_step(WgRow<D>& r, uint32_t sq,
                                        uint32_t qempty, uint32_t ring,
                                        uint32_t bars,
                                        int& stage, uint32_t& phase, int wg,
                                        int blk, const WgWork& w, int row0,
                                        int c0, int causal, float sl) {
  using C = WgCfg<D>;
  constexpr int kS = C::kStages;
  const uint32_t ks = ring + stage * C::kStageBytes;
  ptt_wg::mbar_wait(bars + 8 * stage, phase);
  pp_sync(wg);
  ptt_wg::wgmma_fence();
  issue_s<D, TR>(r.s, sq, ks, wg);
  issue_pv<D, TR>(r.o, r.pa, ring + r.prev * C::kStageBytes + C::kBlockBytes);
  pp_arrive(wg);
  ptt_wg::wgmma_wait<1>();   // s has landed; p v may still run
  ptt_wg::fence_acc(r.s);
  if (blk + 1 == w.nblk) ptt_wg::release(qempty);   // the tile's q
  softmax<C::kN / 2, MASK>(r.s, r.m, r.l, r.c, blk * C::kN, w.kend, causal,
                           row0, c0, sl);
  ptt_wg::wgmma_wait<0>();
  ptt_wg::fence_acc(r.o);
  ptt_wg::release(bars + 8 * (kS + r.prev));
  rescale(r.o, r.c);
  pack_p(r.pa, r.s);
  r.prev = stage;
  if (++stage == kS) {
    stage = 0;
    phase ^= 1;
  }
}

template <int D, bool TR>
__global__ void __launch_bounds__(ptt_wg::kThreads, 1)
    flash_fwd_bf16_wg_kernel(const __grid_constant__ CUtensorMap mq,
                             const __grid_constant__ CUtensorMap mk,
                             const __grid_constant__ CUtensorMap mv,
                             const WgArgs a) {
  using C = WgCfg<D>;
  constexpr int kN = C::kN, kS = C::kStages;
  using Q = Tok<D, kWgM, TR>;
  using KV = Tok<D, kN, TR>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = ptt_wg::smem_addr(smem_raw);
  const uint32_t pad = (1024 - raw % 1024) % 1024;
  // two q tiles (work tile n in buffer n % 2, so that the next tile's q
  // lands while this one runs), then the ring of k, v blocks
  uint8_t* qp = smem_raw + pad;
  const uint32_t sq = raw + pad, ring = sq + 2 * C::kQBytes;
  uint8_t* epi = qp + 2 * C::kQBytes + kS * C::kStageBytes;
  // mbarriers: full[s] at bars + 8 s, empty[s] at bars + 8 (kS + s), then
  // the q buffers' full pair and empty pair
  const uint32_t bars = ring + kS * C::kStageBytes + 2 * C::kEpiBytes;
  const uint32_t qfull = bars + 16 * kS, qempty = qfull + 16;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kS; ++i) {
      ptt_wg::mbar_init(bars + 8 * i, 1);
      ptt_wg::mbar_init(bars + 8 * (kS + i), 4 * ptt_wg::kConsumers);
    }
    for (int i = 0; i < 2; ++i) {
      ptt_wg::mbar_init(qfull + 8 * i, 1);
      ptt_wg::mbar_init(qempty + 8 * i, 4 * ptt_wg::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the warp's index, known to ptxas to be the same across the warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (warp == ptt_wg::kProducerWarp) {
    if ((threadIdx.x & 31) == 0) {
      int stage = 0, n = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
        const WgWork w = wg_work(t, a.nqt, a.H, a.kend, a.causal, kN);
        const int qb = n & 1;
        ptt_wg::mbar_wait(qempty + 8 * qb, ((n >> 1) & 1) ^ 1);
        ptt_wg::mbar_expect_tx(qfull + 8 * qb, C::kQBytes);
        Q::load(sq + qb * C::kQBytes, &mq, qfull + 8 * qb, w.q0, w.h, w.b);
        for (int blk = 0; blk < w.nblk; ++blk) {
          const uint32_t full = bars + 8 * stage;
          const uint32_t slot = ring + stage * C::kStageBytes;
          ptt_wg::mbar_wait(bars + 8 * (kS + stage), phase ^ 1);
          ptt_wg::mbar_expect_tx(full, C::kStageBytes);
          KV::load(slot, &mk, full, blk * kN, w.h, w.b);
          KV::load(slot + C::kBlockBytes, &mv, full, blk * kN, w.h, w.b);
          if (++stage == kS) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }
  const int wg = warp >> 2, lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const int r0 = 16 * (warp & 3) + (lane >> 2);   // rows r0, r0 + 8 of 64
  const int c0 = 2 * (lane & 3);                  // columns c0, c0 + 1 of 8
  bf16* st = reinterpret_cast<bf16*>(epi + wg * C::kEpiBytes);
  int stage = 0, n = 0;
  uint32_t phase = 0;
  if (wg == 1) pp_arrive(1);   // warpgroup 0 first
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
    const WgWork w = wg_work(t, a.nqt, a.H, a.kend, a.causal, kN);
    const int qw = w.q0 + 64 * wg, row0 = qw + r0, qb = n & 1;
    const uint32_t sqt = sq + qb * C::kQBytes, qe = qempty + 8 * qb;
    ptt_wg::mbar_wait(qfull + 8 * qb, (n >> 1) & 1);
    if (a.scale_q) {
      scale_q<D, TR>(qp + qb * C::kQBytes, wg, tid, a.sb);
      ptt_wg::fence_proxy_async();   // q' before the wgmma that read it
      ptt_wg::wg_sync(wg);
    }
    WgRow<D> r;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) r.o[i] = 0.f;
    r.m[0] = r.m[1] = kNegInf;
    r.l[0] = r.l[1] = 0.f;
    // block 0 (masked: whether it needs it is no matter for one block)
    ptt_wg::mbar_wait(bars + 8 * stage, phase);
    pp_sync(wg);
    ptt_wg::wgmma_fence();
    issue_s<D, TR>(r.s, sqt, ring + stage * C::kStageBytes, wg);
    pp_arrive(wg);
    ptt_wg::wgmma_wait<0>();
    ptt_wg::fence_acc(r.s);
    if (w.nblk == 1) ptt_wg::release(qe);
    softmax<kN / 2, true>(r.s, r.m, r.l, r.c, 0, w.kend, a.causal, row0, c0,
                          a.sl);
    pack_p(r.pa, r.s);
    r.prev = stage;
    if (++stage == kS) {
      stage = 0;
      phase ^= 1;
    }
    int blk = 1;
    for (; blk < w.nfree; ++blk)
      wg_step<D, TR, false>(r, sqt, qe, ring, bars, stage, phase, wg, blk,
                            w, row0, c0, a.causal, a.sl);
    for (; blk < w.nblk; ++blk)
      wg_step<D, TR, true>(r, sqt, qe, ring, bars, stage, phase, wg, blk,
                           w, row0, c0, a.causal, a.sl);
    // p v of the last block
    pp_sync(wg);
    ptt_wg::wgmma_fence();
    issue_pv<D, TR>(r.o, r.pa, ring + r.prev * C::kStageBytes +
                                   C::kBlockBytes);
    pp_arrive(wg);
    ptt_wg::wgmma_wait<0>();
    ptt_wg::fence_acc(r.o);
    ptt_wg::release(bars + 8 * (kS + r.prev));

    float inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      r.l[i] += __shfl_xor_sync(0xffffffffu, r.l[i], 1);
      r.l[i] += __shfl_xor_sync(0xffffffffu, r.l[i], 2);
      r.l[i] = fmaxf(r.l[i], 1e-30f);
      inv[i] = 1.f / r.l[i];
    }
    // o = acc / l (times the reciprocal), rounded once, staged in shared
    // memory along o's contiguous dimension and written by 16-byte stores.
    // Each warp stages and stores its own 16 queries (rows 16 w .. of the
    // warpgroup's 64): a warp-wide sync suffices.  o[4 j + 2 i + e] is row
    // r0 + 8 i, feature 8 j + c0 + e.
    const int w16 = r0 & ~15;
    __syncwarp();   // this warp's stores of the last tile have read st
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float v0 = r.o[4 * j + 2 * i] * inv[i];
        const float v1 = r.o[4 * j + 2 * i + 1] * inv[i];
        if (TR) {
          *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8 * i) * (D + 8) +
                                             8 * j + c0) =
              __floats2bfloat162_rn(v0, v1);
        } else {
          st[(8 * j + c0) * 72 + r0 + 8 * i] = __float2bfloat16_rn(v0);
          st[(8 * j + c0 + 1) * 72 + r0 + 8 * i] = __float2bfloat16_rn(v1);
        }
      }
    __syncwarp();
    // 16-byte chunks of 8 features (token rows) or 8 tokens (feature rows;
    // T % 8 == 0, so a chunk lies wholly inside or past Tq)
    bf16* oh = a.o + w.b * a.os.b + w.h * a.os.h;
    if (TR) {
      constexpr int CH = D / 8;
#pragma unroll
      for (int it = 0; it < 16 * CH / 32; ++it) {
        const int id = lane + 32 * it, row = w16 + id / CH, cc = id % CH;
        if (qw + row < a.Tq)
          *reinterpret_cast<uint4*>(oh + (qw + row) * a.os.t + 8 * cc) =
              *reinterpret_cast<const uint4*>(st + row * (D + 8) + 8 * cc);
      }
    } else {
#pragma unroll
      for (int it = 0; it < 2 * D / 32; ++it) {
        const int id = lane + 32 * it, f = id >> 1, tok = w16 + 8 * (id & 1);
        if (qw + tok < a.Tq)
          *reinterpret_cast<uint4*>(oh + f * a.os.d + qw + tok) =
              *reinterpret_cast<const uint4*>(st + f * 72 + tok);
      }
    }
    if (c0 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
        if (row0 + 8 * i < a.Tq)
          a.lse[w.b * a.ls_b + w.h * a.ls_h + row0 + 8 * i] =
              a.lse_mul * r.m[i] + logf(r.l[i]);
    }
  }
  if (wg == 0) pp_sync(0);   // warpgroup 1's last turn
}

template <int D, bool TR>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int H, int Tq, int Tk, int kv_len, int causal,
                              float scale, Strides qs, Strides ks, Strides vs,
                              Strides os, long long ls_b, long long ls_h,
                              Strides dks, Strides dvs, int vq, int vk,
                              int vv, int vo) {
  using Tl = Tiles<D, TR>;
  constexpr int TE = Tl::kElems, NF = D / 8, KF = D / 16;
  constexpr int QN = 16;   // queries per block: one k16 step of dv, dk
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);   // key tile
  bf16* Vs = Ks + TE;                          // value tile
  bf16* QO = Vs + TE;   // stage s: q' at 2s TE, do after
  float* LE = reinterpret_cast<float*>(QO + 4 * TE);  // lse, delta rows

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kTile;
  const int wr = 16 * warp;
  const int kr0 = k0 + wr + g, kr1 = kr0 + 8;
  const int kend = min(Tk, kv_len);
  const float sb = __bfloat162float(__float2bfloat16_rn(scale));

  const bf16* qh = q + b * qs.b + h * qs.h;
  const bf16* oh = dout + b * os.b + h * os.h;
  const float* lh = lse + b * ls_b + h * ls_h;
  const float* eh = delta + b * ls_b + h * ls_h;
  const int qstart = causal ? k0 : 0;
  const int nqt = k0 < kend && qstart < Tq ? (Tq - qstart + kTile - 1) / kTile
                                            : 0;

  float dka[NF][4], dva[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[f][e] = dva[f][e] = 0.f;

  auto stage_q = [&](int sb_, int qt0) {
    Tl::stage(QO + 2 * sb_ * TE, qh, qs, qt0, Tq, vq);
    Tl::stage(QO + (2 * sb_ + 1) * TE, oh, os, qt0, Tq, vo);
    if (threadIdx.x < kTile)
      stage_row(LE + 2 * kTile * sb_, lh, qt0, Tq, threadIdx.x);
    else
      stage_row(LE + 2 * kTile * sb_ + kTile, eh, qt0, Tq,
                threadIdx.x - kTile);
  };
  if (nqt > 0) {
    Tl::stage(Ks, k + b * ks.b + h * ks.h, ks, k0, kend, vk);
    Tl::stage(Vs, v + b * vs.b + h * vs.h, vs, k0, kend, vv);
    stage_q(0, qstart);
    cp_commit();
  }

  for (int it = 0; it < nqt; ++it) {
    const int q0 = qstart + it * kTile, st = it & 1;
    if (it + 1 < nqt) {
      stage_q(st ^ 1, q0 + kTile);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    bf16* Qs = QO + 2 * st * TE;
    const bf16* Os = Qs + TE;
    const float* Ls = LE + 2 * kTile * st;
    const float* Es = Ls + kTile;
    Tl::scale(Qs, sb);
    __syncthreads();

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += QN) {
      const int qb = q0 + c0;
      if (qb >= Tq || (causal && qb + QN - 1 < k0 + wr)) continue;
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KF; ++kk) {   // s^T = k q'^T, dp^T = v do^T
        uint32_t a[4], bq[4];
        Tl::a_tf(a, Ks, wr, 16 * kk, lane);
        Tl::b_ft(bq, Qs, 16 * kk, c0, lane);
        ptt_bf16::mma(s[0], a, bq[0], bq[1]);
        ptt_bf16::mma(s[1], a, bq[2], bq[3]);
        Tl::a_tf(a, Vs, wr, 16 * kk, lane);
        Tl::b_ft(bq, Os, 16 * kk, c0, lane);
        ptt_bf16::mma(dp[0], a, bq[0], bq[1]);
        ptt_bf16::mma(dp[1], a, bq[2], bq[3]);
      }
      // p^T into s, ds^T into dp; columns are queries
      const bool need = k0 + kTile > kend || qb + QN > Tq ||
                        (causal && k0 + wr + 15 > qb);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = c0 + 8 * j + 2 * t + (e & 1), qp = q0 + ql;
          const int key = e < 2 ? kr0 : kr1;
          const bool valid =
              !need || (key < kend && qp < Tq && (!causal || key <= qp));
          const float p =
              valid ? exp2f(fmaf(s[j][e], kLog2e, -Ls[ql] * kLog2e)) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Es[ql]);
        }
      // dv += bf16(p^T) do, dk += bf16(ds^T) q'; k runs over the block's
      // 16 queries
      uint32_t pa[4], da[4];
      ptt_bf16::a_from_c(pa, s[0], s[1]);
      ptt_bf16::a_from_c(da, dp[0], dp[1]);
#pragma unroll
      for (int fp = 0; fp < NF / 2; ++fp) {
        uint32_t bb[4];
        Tl::b_tf(bb, Os, c0, 16 * fp, lane);
        ptt_bf16::mma(dva[2 * fp], pa, bb[0], bb[1]);
        ptt_bf16::mma(dva[2 * fp + 1], pa, bb[2], bb[3]);
        Tl::b_tf(bb, Qs, c0, 16 * fp, lane);
        ptt_bf16::mma(dka[2 * fp], da, bb[0], bb[1]);
        ptt_bf16::mma(dka[2 * fp + 1], da, bb[2], bb[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  write_rows<NF>(dk, dks, b, h, Tk, kr0, t, 1.f, 1.f, dka);
  write_rows<NF>(dv, dvs, b, h, Tk, kr0, t, 1.f, 1.f, dva);
}

template <int D, bool TR>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             bf16* __restrict__ dq, int H, int Tq, int Tk,
                             int kv_len, int causal, float scale, Strides qs,
                             Strides ks, Strides vs, Strides os,
                             long long ls_b, long long ls_h, Strides dqs,
                             int vq, int vk, int vv, int vo) {
  using Tl = Tiles<D, TR>;
  constexpr int TE = Tl::kElems, NF = D / 8, KF = D / 16;
  constexpr int KN = D == 64 ? 64 : 32, NJ = KN / 8;   // keys per block
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);  // q' tile
  bf16* Os = Qs + TE;                         // do tile
  bf16* KV = Os + TE;   // stage s: k at 2s TE, v after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int wr = 16 * warp;
  const int qr0 = q0 + wr + g, qr1 = qr0 + 8;

  const bf16* kh = k + b * ks.b + h * ks.h;
  const bf16* vh = v + b * vs.b + h * vs.h;
  const float* lh = lse + b * ls_b + h * ls_h;
  const float* eh = delta + b * ls_b + h * ls_h;
  const float lr0 = qr0 < Tq ? lh[qr0] * kLog2e : 0.f;
  const float lr1 = qr1 < Tq ? lh[qr1] * kLog2e : 0.f;
  const float er0 = qr0 < Tq ? eh[qr0] : 0.f, er1 = qr1 < Tq ? eh[qr1] : 0.f;
  int kend = min(Tk, kv_len);
  if (causal) kend = min(kend, q0 + kTile);
  const int ntiles = (kend + kTile - 1) / kTile;

  Tl::stage(Qs, q + b * qs.b + h * qs.h, qs, q0, Tq, vq);
  Tl::stage(Os, dout + b * os.b + h * os.h, os, q0, Tq, vo);
  cp_commit();
  Tl::stage(KV, kh, ks, 0, kend, vk);
  Tl::stage(KV + TE, vh, vs, 0, kend, vv);
  cp_commit();
  cp_wait<1>();   // q and do have landed
  __syncthreads();
  Tl::scale(Qs, __bfloat162float(__float2bfloat16_rn(scale)));
  __syncthreads();
  uint32_t qf[KF][4], of[KF][4];   // q' and do rows as A fragments
#pragma unroll
  for (int kk = 0; kk < KF; ++kk) {
    Tl::a_tf(qf[kk], Qs, wr, 16 * kk, lane);
    Tl::a_tf(of[kk], Os, wr, 16 * kk, lane);
  }

  float dqa[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[f][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kTile, st = it & 1;
    if (it + 1 < ntiles) {
      bf16* nb = KV + 2 * (st ^ 1) * TE;
      Tl::stage(nb, kh, ks, k0 + kTile, kend, vk);
      Tl::stage(nb + TE, vh, vs, k0 + kTile, kend, vv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* Ks = KV + 2 * st * TE;
    const bf16* Vs = Ks + TE;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += KN) {
      const int kb = k0 + c0;
      if (kb >= kend || (causal && kb > q0 + wr + 15)) continue;
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KF; ++kk)
#pragma unroll
        for (int jp = 0; jp < NJ / 2; ++jp) {   // s = q' k^T, dp = do v^T
          uint32_t bb[4];
          Tl::b_ft(bb, Ks, 16 * kk, c0 + 16 * jp, lane);
          ptt_bf16::mma(s[2 * jp], qf[kk], bb[0], bb[1]);
          ptt_bf16::mma(s[2 * jp + 1], qf[kk], bb[2], bb[3]);
          Tl::b_ft(bb, Vs, 16 * kk, c0 + 16 * jp, lane);
          ptt_bf16::mma(dp[2 * jp], of[kk], bb[0], bb[1]);
          ptt_bf16::mma(dp[2 * jp + 1], of[kk], bb[2], bb[3]);
        }
      const bool need = kb + KN > kend || q0 + kTile > Tq ||
                        (causal && kb + KN - 1 > q0 + wr);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kb + 8 * j + 2 * t + (e & 1);
          const int row = e < 2 ? qr0 : qr1;
          const bool valid =
              !need || (key < kend && row < Tq && (!causal || key <= row));
          const float p = valid
              ? exp2f(fmaf(s[j][e], kLog2e, -(e < 2 ? lr0 : lr1))) : 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? er0 : er1));   // ds
        }
      // dq += bf16(ds) k; k runs over the block's keys, 16 at a time
#pragma unroll
      for (int J = 0; J < NJ / 2; ++J) {
        uint32_t da[4];
        ptt_bf16::a_from_c(da, s[2 * J], s[2 * J + 1]);
#pragma unroll
        for (int fp = 0; fp < NF / 2; ++fp) {
          uint32_t bb[4];
          Tl::b_tf(bb, Ks, c0 + 16 * J, 16 * fp, lane);
          ptt_bf16::mma(dqa[2 * fp], da, bb[0], bb[1]);
          ptt_bf16::mma(dqa[2 * fp + 1], da, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  write_rows<NF>(dq, dqs, b, h, Tq, qr0, t, scale, scale, dqa);
}

// ---- the backward on wgmma (sm_90a): TMA, an mbarrier ring, warpgroups ----
//
// Two persistent launches of min(work tiles, SMs) CTAs, dk/dv then dq, each
// a producer warp and two consumer warpgroups of 64 rows, built from the
// forward's pieces (wgmma_bf16.cuh, Tok below).  Every output element is
// summed inside one CTA in a fixed order: no atomics, the same bits on
// every call.  Both kernels recompute s and dp, so a kept (query, key) pair
// costs 7 products of 2 d FLOP (the least is 5).
//   dk/dv (flash_bwd_dkv_bf16_wg_kernel): a work tile is 128 keys of one
//     (batch row, head); k and v arrive once by TMA and stay in shared
//     memory while the producer streams blocks of kDkvN queries (128 at d
//     64, 64 at d 128; q, do by TMA,
//     lse and delta by the producer warp's own loads) from the causal
//     diagonal into a ring.  Per block a warpgroup takes s^T = k q'^T and
//     dp^T = v do^T (both operands in shared memory), forms p^T and ds^T in
//     the accumulators (lse and delta by column, the masks as a query range
//     per key row), and adds dv += bf16(p^T) do and dk += bf16(ds^T) q' with
//     A from registers.  dk and dv stay in registers for the whole tile.
//   dq (flash_bwd_dq_bf16_wg_kernel): the forward's schedule and pipeline;
//     a work tile is 128 queries whose q' and do stay in shared memory, lse
//     and delta in registers; k and v stream in blocks of 64 keys.  A
//     warpgroup issues this block's s = q'k^T and dp = do v^T and the last
//     block's dq += bf16(ds) k back to back, and forms ds while the latter
//     runs; the warpgroups take turns to issue (pp_sync).
// q' = bf16(q bf16(scale)) is scaled in shared memory, or, where bf16(scale)
// is a power of two, folded with the same bits into the exponent and into
// dk's epilogue (BwdArgs).  q, k and v are in one orientation (token rows
// or feature rows), do in its own; the transpose bits read each in its own
// layout.  Outputs are staged by each warp and written by 16-byte stores
// along their unit stride.  The producer warpgroup gives up registers to
// the consumers (setmaxnreg), which hold dk and dv (d 128: 128 f32 a
// thread) beside the scores.

constexpr int kBwdM = 128;   // rows a work tile (keys, or queries)
// queries a dk/dv block: 128 at d 64, so that s^T and dp^T take wgmma
// m64n128k16, whose two shared-memory operands need 96 bytes a cycle where
// m64n64k16's need 128, all the SM has; 64 at d 128, where dk and dv hold
// 128 f32 a thread.  keys a dq block: 64, since the dq kernel keeps s, dp,
// the last block's ds and dq live together (at 128 keys it spilled 1.1 KB
// and ran at half the rate)
template <int D>
constexpr int kDkvN = D == 64 ? 128 : 64;
constexpr int kDqN = 64;
// 384 threads: consumer warpgroups 0 and 1, producer warpgroup 2 (its warp
// 8 loads, the rest exit), which gives the consumers its registers
// (setmaxnreg: 40 a thread there, 232 here, against 168 for all)
constexpr int kBwdThreads = 384;

// the dk/dv kernel's shared memory: k and v tiles (two buffers at d 64, so
// that the next tile's land during this one), the ring of q and do blocks,
// the stages' lse and delta, the consumers' staging tiles, the barriers
template <int D>
struct DkvCfg {
  static constexpr int kBufs = D == 64 ? 2 : 1;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kTileBytes = kBwdM * D * 2;    // a k or v tile
  static constexpr int kBlockBytes = kDkvN<D> * D * 2;   // a q or do block
  static constexpr int kStageBytes = 2 * kBlockBytes;
  static constexpr int kEpiBytes = 64 * (D + 8) * 2;
  static constexpr int kRowBytes = 2 * kDkvN<D> * 4;     // lse, delta
  static constexpr int kSmemBytes = 1024 + kBufs * 2 * kTileBytes +
                                    kStages * kStageBytes + 2 * kEpiBytes +
                                    kStages * kRowBytes +
                                    8 * (2 * kStages + 2 * kBufs);
};

// the dq kernel's: q and do tiles, the ring of k and v blocks, staging,
// barriers
template <int D>
struct DqCfg {
  static constexpr int kBufs = D == 64 ? 2 : 1;
  static constexpr int kStages = D == 64 ? 4 : 3;
  static constexpr int kTileBytes = kBwdM * D * 2;    // a q or do tile
  static constexpr int kBlockBytes = kDqN * D * 2;   // a k or v block
  static constexpr int kStageBytes = 2 * kBlockBytes;
  static constexpr int kEpiBytes = 64 * (D + 8) * 2;
  static constexpr int kSmemBytes = 1024 + kBufs * 2 * kTileBytes +
                                    kStages * kStageBytes + 2 * kEpiBytes +
                                    8 * (2 * kStages + 2 * kBufs);
};

struct BwdArgs {
  const float* lse;
  const float* delta;
  long long ls_b, ls_h;       // their batch and head strides (token 1)
  bf16* o0;                   // dq, or dk
  bf16* o1;                   // dv
  Strides s0, s1;             // their strides
  int H, Tq, Tk, kend, causal;
  int nt, tiles;              // row tiles of a (batch row, head); all
  // as WgArgs: where bf16(scale) sb is a power of two, q is not scaled and
  // s comes in units of q k^T: sl = sb log2 e, and dk = sb sum bf16(ds) q;
  // else sl = log2 e
  int scale_q;
  float sb, sl;
  float mul0, mul1;           // o0's and o1's factor before rounding
};

// Work tile t of the dk/dv kernel (kernels/flash_attention.py
// bwd_bf16_schedule): the nt key tiles of one (batch row, head) side by
// side, tile j being key tile (j + bh) % nt, so that under a causal mask a
// CTA's heavy and light tiles alternate; its query blocks start at the
// diagonal.  Blocks [0, nlo) and [nhi, nblk) need the mask: the diagonal's
// two, a ragged query tail, all where the tile reaches past kend.
struct KvWork {
  int b, h, k0, q0, nblk, nlo, nhi;
};

__device__ __forceinline__ KvWork kv_work(const BwdArgs& a, int t, int n) {
  KvWork w;
  const int bh = t / a.nt, j = t % a.nt;
  w.b = bh / a.H;
  w.h = bh % a.H;
  w.k0 = (j + bh) % a.nt * kBwdM;
  w.q0 = a.causal ? w.k0 : 0;
  w.nblk = w.k0 < a.kend ? (a.Tq - w.q0 + n - 1) / n : 0;
  w.nlo = a.causal ? min(kBwdM / n, w.nblk) : 0;
  if (w.k0 + kBwdM > a.kend) w.nlo = w.nblk;
  w.nhi = max(w.nlo, a.Tq % n ? w.nblk - 1 : w.nblk);
  return w;
}

// bf16(x sb) in place over the n16 16-byte chunks from p, a thread of 128
// taking every 128th: q' of a staged q block
__device__ __forceinline__ void scale_chunks(uint8_t* p, int n16, int tid,
                                             float sb) {
  for (int c = tid; c < n16; c += 128) {
    uint4 v = *reinterpret_cast<uint4*>(p + 16 * c);
    __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(e[i]);
      e[i] = __floats2bfloat162_rn(f.x * sb, f.y * sb);
    }
    *reinterpret_cast<uint4*>(p + 16 * c) = v;
  }
}

// A warpgroup's 64 rows of an output (acc[4 j + 2 i + e]: row r0 + 8 i,
// feature 8 j + c0 + e) times mul, rounded to bf16 once, into rows row0 ..
// (< T) of out (this (batch row, head)'s base) through its strides: each
// warp stages its 16 rows in st ([64][D + 8]: a warp's fragment writes fall
// in distinct banks) and writes them by 16-byte stores along out's unit
// stride, features where s.d == 1, else tokens (T % 8 == 0 there, so a
// chunk of 8 tokens lies wholly inside or past T)
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           float mul, bf16* st, bf16* out,
                                           const Strides& s, int row0, int T,
                                           int r0, int c0, int lane) {
  const int w16 = r0 & ~15;
  __syncwarp();   // this warp's stores of the last tile have read st
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8 * i) * (D + 8) +
                                         8 * j + c0) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul,
                                acc[4 * j + 2 * i + 1] * mul);
  __syncwarp();
  if (s.d == 1) {
    constexpr int CH = D / 8;
#pragma unroll
    for (int it = 0; it < 16 * CH / 32; ++it) {
      const int id = lane + 32 * it, row = w16 + id / CH, cc = id % CH;
      if (row0 + row < T)
        *reinterpret_cast<uint4*>(out + (row0 + row) * s.t + 8 * cc) =
            *reinterpret_cast<const uint4*>(st + row * (D + 8) + 8 * cc);
    }
  } else {
#pragma unroll
    for (int it = 0; it < 2 * D / 32; ++it) {
      const int id = lane + 32 * it, f = id >> 1, tok = w16 + 8 * (id & 1);
      if (row0 + tok < T) {
        uint4 v;
        bf16* e = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int x = 0; x < 8; ++x) e[x] = st[(tok + x) * (D + 8) + f];
        *reinterpret_cast<uint4*>(out + f * s.d + row0 + tok) = v;
      }
    }
  }
}

// One block of kDkvN queries for a dk/dv warpgroup (keys kr0, kr0 + 8 are
// its thread's rows): s^T = k q'^T and dp^T = v do^T; p^T = 2^(s sl - lse
// log2 e) and ds^T = p^T (dp^T - delta) in f32 (lse log2 e and delta per
// column, from the stage); MASK keeps query columns >= the key (causal),
// < Tq, and rows < kend, by one range a row; dv += bf16(p^T) do, dk +=
// bf16(ds^T) q'.  Waits for each group before the next: nothing reads an
// accumulator under a branch.
template <int D, bool TR, bool DTR, bool MASK>
__device__ __forceinline__ void kv_step(float (&dk)[D / 2], float (&dv)[D / 2],
                                        uint32_t kt, uint32_t vt,
                                        uint32_t ring, uint8_t* ringp,
                                        const float* rows, uint32_t bars,
                                        ptt_wg::Pipe& rg, int wg, int tid,
                                        int q0, int kr0, int c0,
                                        const BwdArgs& a) {
  using C = DkvCfg<D>;
  constexpr int kN = kDkvN<D>, kS = C::kStages;
  using K = Tok<D, kBwdM, TR>;
  using Q = Tok<D, kN, TR>;
  using O = Tok<D, kN, DTR>;
  const uint32_t qs = ring + rg.stage * C::kStageBytes;
  const uint32_t os = qs + C::kBlockBytes;
  ptt_wg::mbar_wait(bars + 8 * rg.stage, rg.phase);
  if (a.scale_q) {   // q' in place: each warpgroup half the block
    scale_chunks(ringp + rg.stage * C::kStageBytes + wg * C::kBlockBytes / 2,
                 C::kBlockBytes / 32, tid, a.sb);
    ptt_wg::fence_proxy_async();
    asm volatile("bar.sync 5, 256;\n" ::: "memory");
  }
  float s[kN / 2], dp[kN / 2];
  ptt_wg::wgmma_fence();
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    ptt_wg::wgmma_ss<K::kTA, Q::kTFT>(s, K::a_tf(kt, 64 * wg, j),
                                      Q::b_ft(qs, j), j > 0);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    ptt_wg::wgmma_ss<K::kTA, O::kTFT>(dp, K::a_tf(vt, 64 * wg, j),
                                      O::b_ft(os, j), j > 0);
  ptt_wg::wgmma_commit();
  ptt_wg::wgmma_wait<0>();
  ptt_wg::fence_acc(s);
  ptt_wg::fence_acc(dp);
  const float* le = rows + rg.stage * 2 * kN;   // lse log2 e, then delta
  int lo[2], hi[2];
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = kr0 + 8 * i;
      lo[i] = a.causal ? key - q0 - c0 : -(1 << 30);
      hi[i] = key < a.kend ? a.Tq - q0 - c0 : -(1 << 30);
    }
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const float2 l = *reinterpret_cast<const float2*>(le + 8 * j + c0);
    const float2 d = *reinterpret_cast<const float2*>(le + kN + 8 * j + c0);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ptt_bf16::ex2(fmaf(s[4 * j + e], a.sl, -(e & 1 ? l.y : l.x)));
      if (MASK) {
        const int col = 8 * j + (e & 1);
        p = col >= lo[e >> 1] && col < hi[e >> 1] ? p : 0.f;
      }
      s[4 * j + e] = p;
      dp[4 * j + e] = p * (dp[4 * j + e] - (e & 1 ? d.y : d.x));
    }
  }
  uint32_t pa[kN / 16][4], da[kN / 16][4];
  pack_p(pa, s);
  pack_p(da, dp);
  ptt_wg::wgmma_fence();
#pragma unroll
  for (int J = 0; J < kN / 16; ++J)
    ptt_wg::wgmma_rs<O::kTTF>(dv, pa[J], O::b_tf(os, J), 1);
#pragma unroll
  for (int J = 0; J < kN / 16; ++J)
    ptt_wg::wgmma_rs<Q::kTTF>(dk, da[J], Q::b_tf(qs, J), 1);
  ptt_wg::wgmma_commit();
  ptt_wg::wgmma_wait<0>();
  ptt_wg::fence_acc(dv);
  ptt_wg::fence_acc(dk);
  ptt_wg::release(bars + 8 * (kS + rg.stage));
  rg.next(kS);
}

template <int D, bool TR, bool DTR>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dkv_bf16_wg_kernel(const __grid_constant__ CUtensorMap mq,
                                 const __grid_constant__ CUtensorMap mk,
                                 const __grid_constant__ CUtensorMap mv,
                                 const __grid_constant__ CUtensorMap mdo,
                                 const BwdArgs a) {
  using C = DkvCfg<D>;
  constexpr int kN = kDkvN<D>, kS = C::kStages, kB = C::kBufs;
  using K = Tok<D, kBwdM, TR>;
  using Q = Tok<D, kN, TR>;
  using O = Tok<D, kN, DTR>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = ptt_wg::smem_addr(smem_raw);
  const uint32_t pad = (1024 - raw % 1024) % 1024;
  // k, v tiles (buffer n % kB: k, then v), the ring (stage s: q, then do),
  // the staging tiles, the stages' lse log2 e and delta rows, the barriers
  const uint32_t skv = raw + pad, ring = skv + kB * 2 * C::kTileBytes;
  uint8_t* ringp = smem_raw + pad + kB * 2 * C::kTileBytes;
  uint8_t* epi = ringp + kS * C::kStageBytes;
  float* rows = reinterpret_cast<float*>(epi + 2 * C::kEpiBytes);
  // full[s] at bars + 8 s (32 arrivals: the producer warp's lanes, each
  // after its lse and delta stores), empty[s] at bars + 8 (kS + s), then
  // the k/v buffers' full and empty barriers
  const uint32_t bars = ptt_wg::smem_addr(rows + kS * 2 * kN);
  const uint32_t kvfull = bars + 16 * kS, kvempty = kvfull + 8 * kB;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kS; ++i) {
      ptt_wg::mbar_init(bars + 8 * i, 32);
      ptt_wg::mbar_init(bars + 8 * (kS + i), 4 * ptt_wg::kConsumers);
    }
    for (int i = 0; i < kB; ++i) {
      ptt_wg::mbar_init(kvfull + 8 * i, 1);
      ptt_wg::mbar_init(kvempty + 8 * i, 4 * ptt_wg::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int wg = warp >> 2, lane = threadIdx.x & 31;
  if (wg == ptt_wg::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != ptt_wg::kProducerWarp) return;
    ptt_wg::Pipe rg;
    int n = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
      const KvWork w = kv_work(a, t, kN);
      const int kb = n % kB;
      if (lane == 0) {
        const uint32_t kt = skv + kb * 2 * C::kTileBytes;
        ptt_wg::mbar_wait(kvempty + 8 * kb, ((n / kB) & 1) ^ 1);
        ptt_wg::mbar_expect_tx(kvfull + 8 * kb, 2 * C::kTileBytes);
        K::load(kt, &mk, kvfull + 8 * kb, w.k0, w.h, w.b);
        K::load(kt + C::kTileBytes, &mv, kvfull + 8 * kb, w.k0, w.h, w.b);
      }
      const long long lb = w.b * a.ls_b + w.h * a.ls_h;
      for (int blk = 0; blk < w.nblk; ++blk) {
        const int q0 = w.q0 + blk * kN;
        const uint32_t full = bars + 8 * rg.stage;
        ptt_wg::mbar_wait(bars + 8 * (kS + rg.stage), rg.phase ^ 1);
        float* le = rows + rg.stage * 2 * kN;
#pragma unroll
        for (int c = lane; c < kN; c += 32) {
          const bool in = q0 + c < a.Tq;
          le[c] = in ? a.lse[lb + q0 + c] * kLog2e : 0.f;
          le[kN + c] = in ? a.delta[lb + q0 + c] : 0.f;
        }
        if (lane == 0) {
          const uint32_t qs = ring + rg.stage * C::kStageBytes;
          ptt_wg::mbar_expect_tx(full, C::kStageBytes);
          Q::load(qs, &mq, full, q0, w.h, w.b);
          O::load(qs + C::kBlockBytes, &mdo, full, q0, w.h, w.b);
        } else {
          ptt_wg::mbar_arrive(full);
        }
        rg.next(kS);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x & 127;
  const int r0 = 16 * (warp & 3) + (lane >> 2);   // rows r0, r0 + 8 of 64
  const int c0 = 2 * (lane & 3);                  // columns c0, c0 + 1 of 8
  bf16* st = reinterpret_cast<bf16*>(epi + wg * C::kEpiBytes);
  ptt_wg::Pipe rg;
  int n = 0;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
    const KvWork w = kv_work(a, t, kN);
    const int kb = n % kB;
    const uint32_t kt = skv + kb * 2 * C::kTileBytes;
    const uint32_t vt = kt + C::kTileBytes;
    ptt_wg::mbar_wait(kvfull + 8 * kb, (n / kB) & 1);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    const int kr0 = w.k0 + 64 * wg + r0;
    int blk = 0;
    for (; blk < w.nlo; ++blk)
      kv_step<D, TR, DTR, true>(dk, dv, kt, vt, ring, ringp, rows, bars, rg,
                                wg, tid, w.q0 + blk * kN, kr0, c0, a);
    for (; blk < w.nhi; ++blk)
      kv_step<D, TR, DTR, false>(dk, dv, kt, vt, ring, ringp, rows, bars,
                                 rg, wg, tid, w.q0 + blk * kN, kr0, c0,
                                 a);
    for (; blk < w.nblk; ++blk)
      kv_step<D, TR, DTR, true>(dk, dv, kt, vt, ring, ringp, rows, bars, rg,
                                wg, tid, w.q0 + blk * kN, kr0, c0, a);
    ptt_wg::release(kvempty + 8 * kb);
    const int row0 = w.k0 + 64 * wg;
    store_rows<D>(dk, a.mul0, st, a.o0 + w.b * a.s0.b + w.h * a.s0.h, a.s0,
                  row0, a.Tk, r0, c0, lane);
    store_rows<D>(dv, a.mul1, st, a.o1 + w.b * a.s1.b + w.h * a.s1.h, a.s1,
                  row0, a.Tk, r0, c0, lane);
  }
}

// The state a dq warpgroup carries through a work tile's key blocks: the
// scores and dp of the block in flight, ds of the block before it as A
// fragments, dq, the rows' lse log2 e and delta, and the ring slot whose k
// the next dq product reads.
template <int D>
struct DqRow {
  float s[kDqN / 2], dp[kDqN / 2];
  uint32_t da[kDqN / 16][4];
  float dq[D / 2];
  float lsl[2], dl[2];
  int prev;
};

// ds = p (dp - delta), p = 2^(s sl - lse log2 e), in place of s; MASK sets
// p to 0 for keys >= kend and, causal, after the query (a key limit a row,
// as the forward's softmax)
template <bool MASK, int N>
__device__ __forceinline__ void form_ds(float (&s)[N], const float (&dp)[N],
                                        const float (&lsl)[2],
                                        const float (&dl)[2], int k0,
                                        int kend, int causal, int row0,
                                        int c0, float sl) {
  int lim[2];
  if (MASK) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      lim[i] = (causal ? min(kend, row0 + 8 * i + 1) : kend) - k0 - c0;
  }
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float p = ptt_bf16::ex2(fmaf(s[4 * j + e], sl, -lsl[e >> 1]));
      if (MASK) p = 8 * j + (e & 1) < lim[e >> 1] ? p : 0.f;
      s[4 * j + e] = p * (dp[4 * j + e] - dl[e >> 1]);
    }
}

// s = q' k^T and dp = do v^T of a warpgroup's 64 queries over one key
// block, one commit group
template <int D, bool TR, bool DTR>
__device__ __forceinline__ void issue_sdp(DqRow<D>& r, uint32_t sq,
                                          uint32_t sdo, uint32_t ks,
                                          int wg) {
  using Q = Tok<D, kBwdM, TR>;
  using O = Tok<D, kBwdM, DTR>;
  using K = Tok<D, kDqN, TR>;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    ptt_wg::wgmma_ss<Q::kTA, K::kTFT>(r.s, Q::a_tf(sq, 64 * wg, j),
                                      K::b_ft(ks, j), j > 0);
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    ptt_wg::wgmma_ss<O::kTA, K::kTFT>(r.dp, O::a_tf(sdo, 64 * wg, j),
                                      K::b_ft(ks + DqCfg<D>::kBlockBytes, j),
                                      j > 0);
  ptt_wg::wgmma_commit();
}

// dq += bf16(ds) k of the block in slot r.prev, one commit group
template <int D, bool TR>
__device__ __forceinline__ void issue_dq(DqRow<D>& r, uint32_t ring) {
  using K = Tok<D, kDqN, TR>;
  const uint32_t ks = ring + r.prev * DqCfg<D>::kStageBytes;
#pragma unroll
  for (int J = 0; J < kDqN / 16; ++J)
    ptt_wg::wgmma_rs<K::kTTF>(r.dq, r.da[J], K::b_tf(ks, J), 1);
  ptt_wg::wgmma_commit();
}

// Key block blk after the first: this block's s and dp and the previous
// block's dq product issued back to back, ds formed while the latter runs
// (the forward's wg_step)
template <int D, bool TR, bool DTR, bool MASK>
__device__ __forceinline__ void dq_step(DqRow<D>& r, uint32_t sq,
                                        uint32_t sdo, uint32_t qempty,
                                        uint32_t ring, uint32_t bars,
                                        ptt_wg::Pipe& rg, int wg, int blk,
                                        const WgWork& w, int row0, int c0,
                                        const BwdArgs& a) {
  constexpr int kS = DqCfg<D>::kStages;
  ptt_wg::mbar_wait(bars + 8 * rg.stage, rg.phase);
  pp_sync(wg);
  ptt_wg::wgmma_fence();
  issue_sdp<D, TR, DTR>(r, sq, sdo, ring + rg.stage * DqCfg<D>::kStageBytes,
                        wg);
  issue_dq<D, TR>(r, ring);
  pp_arrive(wg);
  ptt_wg::wgmma_wait<1>();   // s and dp have landed; dq may still run
  ptt_wg::fence_acc(r.s);
  ptt_wg::fence_acc(r.dp);
  if (blk + 1 == w.nblk) ptt_wg::release(qempty);   // the tile's q, do
  form_ds<MASK>(r.s, r.dp, r.lsl, r.dl, blk * kDqN, w.kend, a.causal, row0,
                c0, a.sl);
  ptt_wg::wgmma_wait<0>();
  ptt_wg::fence_acc(r.dq);
  ptt_wg::release(bars + 8 * (kS + r.prev));
  pack_p(r.da, r.s);
  r.prev = rg.stage;
  rg.next(kS);
}

template <int D, bool TR, bool DTR>
__global__ void __launch_bounds__(kBwdThreads, 1)
    flash_bwd_dq_bf16_wg_kernel(const __grid_constant__ CUtensorMap mq,
                                const __grid_constant__ CUtensorMap mk,
                                const __grid_constant__ CUtensorMap mv,
                                const __grid_constant__ CUtensorMap mdo,
                                const BwdArgs a) {
  using C = DqCfg<D>;
  constexpr int kN = kDqN, kS = C::kStages, kB = C::kBufs;
  using Q = Tok<D, kBwdM, TR>;
  using O = Tok<D, kBwdM, DTR>;
  using K = Tok<D, kN, TR>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = ptt_wg::smem_addr(smem_raw);
  const uint32_t pad = (1024 - raw % 1024) % 1024;
  // q and do tiles (buffer n % kB: q, then do), the ring (stage s: k, then
  // v), the staging tiles, the barriers: full[s], empty[s], then the q/do
  // buffers' full and empty
  uint8_t* qp = smem_raw + pad;
  const uint32_t sq = raw + pad, ring = sq + kB * 2 * C::kTileBytes;
  uint8_t* epi = qp + kB * 2 * C::kTileBytes + kS * C::kStageBytes;
  const uint32_t bars = ring + kS * C::kStageBytes + 2 * C::kEpiBytes;
  const uint32_t qfull = bars + 16 * kS, qempty = qfull + 8 * kB;
  if (threadIdx.x == 0) {
    for (int i = 0; i < kS; ++i) {
      ptt_wg::mbar_init(bars + 8 * i, 1);
      ptt_wg::mbar_init(bars + 8 * (kS + i), 4 * ptt_wg::kConsumers);
    }
    for (int i = 0; i < kB; ++i) {
      ptt_wg::mbar_init(qfull + 8 * i, 1);
      ptt_wg::mbar_init(qempty + 8 * i, 4 * ptt_wg::kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int wg = warp >> 2, lane = threadIdx.x & 31;
  if (wg == ptt_wg::kConsumers) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != ptt_wg::kProducerWarp || lane != 0) return;
    ptt_wg::Pipe rg;
    int n = 0;
    for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
      const WgWork w = wg_work(t, a.nt, a.H, a.kend, a.causal, kN);
      const int qb = n % kB;
      const uint32_t qt = sq + qb * 2 * C::kTileBytes;
      ptt_wg::mbar_wait(qempty + 8 * qb, ((n / kB) & 1) ^ 1);
      ptt_wg::mbar_expect_tx(qfull + 8 * qb, 2 * C::kTileBytes);
      Q::load(qt, &mq, qfull + 8 * qb, w.q0, w.h, w.b);
      O::load(qt + C::kTileBytes, &mdo, qfull + 8 * qb, w.q0, w.h, w.b);
      for (int blk = 0; blk < w.nblk; ++blk) {
        const uint32_t full = bars + 8 * rg.stage;
        const uint32_t slot = ring + rg.stage * C::kStageBytes;
        ptt_wg::mbar_wait(bars + 8 * (kS + rg.stage), rg.phase ^ 1);
        ptt_wg::mbar_expect_tx(full, C::kStageBytes);
        K::load(slot, &mk, full, blk * kN, w.h, w.b);
        K::load(slot + C::kBlockBytes, &mv, full, blk * kN, w.h, w.b);
        rg.next(kS);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int tid = threadIdx.x & 127;
  const int r0 = 16 * (warp & 3) + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  bf16* st = reinterpret_cast<bf16*>(epi + wg * C::kEpiBytes);
  ptt_wg::Pipe rg;
  int n = 0;
  if (wg == 1) pp_arrive(1);   // warpgroup 0 first
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x, ++n) {
    const WgWork w = wg_work(t, a.nt, a.H, a.kend, a.causal, kN);
    const int qw = w.q0 + 64 * wg, row0 = qw + r0, qb = n % kB;
    const uint32_t sqt = sq + qb * 2 * C::kTileBytes;
    const uint32_t sdo = sqt + C::kTileBytes, qe = qempty + 8 * qb;
    DqRow<D> r;
    const long long lb = w.b * a.ls_b + w.h * a.ls_h;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = row0 + 8 * i;
      r.lsl[i] = row < a.Tq ? a.lse[lb + row] * kLog2e : 0.f;
      r.dl[i] = row < a.Tq ? a.delta[lb + row] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) r.dq[i] = 0.f;
    ptt_wg::mbar_wait(qfull + 8 * qb, (n / kB) & 1);
    if (a.scale_q) {
      scale_q<D, TR>(qp + qb * 2 * C::kTileBytes, wg, tid, a.sb);
      ptt_wg::fence_proxy_async();   // q' before the wgmma that read it
      ptt_wg::wg_sync(wg);
    }
    // block 0 (masked: whether it needs it is no matter for one block)
    ptt_wg::mbar_wait(bars + 8 * rg.stage, rg.phase);
    pp_sync(wg);
    ptt_wg::wgmma_fence();
    issue_sdp<D, TR, DTR>(r, sqt, sdo, ring + rg.stage * C::kStageBytes, wg);
    pp_arrive(wg);
    ptt_wg::wgmma_wait<0>();
    ptt_wg::fence_acc(r.s);
    ptt_wg::fence_acc(r.dp);
    if (w.nblk == 1) ptt_wg::release(qe);
    form_ds<true>(r.s, r.dp, r.lsl, r.dl, 0, w.kend, a.causal, row0, c0,
                  a.sl);
    pack_p(r.da, r.s);
    r.prev = rg.stage;
    rg.next(kS);
    int blk = 1;
    for (; blk < w.nfree; ++blk)
      dq_step<D, TR, DTR, false>(r, sqt, sdo, qe, ring, bars, rg, wg, blk, w,
                                 row0, c0, a);
    for (; blk < w.nblk; ++blk)
      dq_step<D, TR, DTR, true>(r, sqt, sdo, qe, ring, bars, rg, wg, blk, w,
                                row0, c0, a);
    // dq of the last block
    pp_sync(wg);
    ptt_wg::wgmma_fence();
    issue_dq<D, TR>(r, ring);
    pp_arrive(wg);
    ptt_wg::wgmma_wait<0>();
    ptt_wg::fence_acc(r.dq);
    ptt_wg::release(bars + 8 * (kS + r.prev));
    store_rows<D>(r.dq, a.mul0, st, a.o0 + w.b * a.s0.b + w.h * a.s0.h,
                  a.s0, qw, a.Tq, r0, c0, lane);
  }
  if (wg == 0) pp_sync(0);   // warpgroup 1's last turn
}

// token rows where every input has feature stride 1, else feature rows
inline bool token_rows(const Strides* st, int n) {
  for (int i = 0; i < n; ++i)
    if (st[i].d != 1) return false;
  return true;
}

template <int D, bool TR>
int launch_fwd(const bf16* q, const bf16* k, const bf16* v, bf16* o,
               float* lse, int H, int B, int Tq, int Tk, int kv_len,
               int causal, float scale, const Strides* st, long long ls_b,
               long long ls_h, cudaStream_t stream) {
  auto vec = TR ? vec16_tr : vec16_fr;
  const int smem = 5 * Tiles<D, TR>::kElems * (int)sizeof(bf16);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D, TR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + kTile - 1) / kTile);
  flash_fwd_bf16_kernel<D, TR><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, H, Tq, Tk, kv_len, causal, scale, st[0], st[1], st[2],
      st[3], ls_b, ls_h, vec(q, st[0]), vec(k, st[1]), vec(v, st[2]));
  return (int)cudaGetLastError();
}

// TMA can describe operand p (T tokens) for the wgmma forward: a 16-byte
// aligned base, the orientation's unit stride (feature stride 1 in token
// rows, token stride 1 in feature rows), and every other stride of a
// dimension longer than 1 a positive multiple of 8 elements (16 bytes).
// Feature rows also need T % 8 == 0: o is written 8 tokens a store.
// kernels/flash_attention.py fwd_bf16_path makes the same choice.
bool wg_ok(const void* p, const Strides& s, bool tr, int D, int T, int H,
           int B) {
  auto ok = [](long long x, long long n) {
    return n <= 1 || (x > 0 && x % 8 == 0 && x < (1LL << 39));
  };
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  if (tr) return s.d == 1 && ok(s.t, T) && ok(s.h, H) && ok(s.b, B);
  return s.t == 1 && T % 8 == 0 && ok(s.d, D) && ok(s.h, H) && ok(s.b, B);
}

// The map of an operand of T tokens for the wgmma forward: dims (D, T, H,
// B) in boxes of 64 features x rows tokens (token rows), or (T, D, H, B) in
// boxes of 64 tokens x D features (feature rows).  T is a dimension of its
// own, so TMA fills a box's rows past a batch row's T with zeros.  A
// dimension of extent 1 takes stride 8 (TMA reads no second index of it).
cudaError_t wg_map(CUtensorMap* m, const bf16* p, const Strides& s, bool tr,
                   int D, int T, int H, int B, int rows) {
  auto st = [](long long x, long long n) { return n > 1 ? x : 8LL; };
  const long long dims_tr[4] = {D, T, H, B}, dims_fr[4] = {T, D, H, B};
  const long long str_tr[3] = {st(s.t, T), st(s.h, H), st(s.b, B)};
  const long long str_fr[3] = {st(s.d, D), st(s.h, H), st(s.b, B)};
  const int box_tr[4] = {64, rows, 1, 1}, box_fr[4] = {64, D, 1, 1};
  return tr ? ptt_tma::tensor_map(m, p, 4, dims_tr, str_tr, box_tr)
            : ptt_tma::tensor_map(m, p, 4, dims_fr, str_fr, box_fr);
}

// the wgmma forward: one persistent launch of min(work tiles, SMs) CTAs
template <int D, bool TR>
int launch_fwd_wg(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                  float* lse, int H, int B, int Tq, int Tk, int kv_len,
                  int causal, float scale, const Strides* st, long long ls_b,
                  long long ls_h, cudaStream_t stream) {
  using C = WgCfg<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t err;
  if ((err = wg_map(&mq, q, st[0], TR, D, Tq, H, B, kWgM)) != cudaSuccess ||
      (err = wg_map(&mk, k, st[1], TR, D, Tk, H, B, C::kN)) != cudaSuccess ||
      (err = wg_map(&mv, v, st[2], TR, D, Tk, H, B, C::kN)) != cudaSuccess)
    return (int)err;
  WgArgs a;
  a.o = o;
  a.lse = lse;
  a.os = st[3];
  a.ls_b = ls_b;
  a.ls_h = ls_h;
  a.B = B;
  a.H = H;
  a.Tq = Tq;
  a.kend = Tk < kv_len ? Tk : kv_len;
  a.causal = causal;
  a.nqt = (Tq + kWgM - 1) / kWgM;
  a.tiles = B * H * a.nqt;
  a.sb = __bfloat162float(__float2bfloat16_rn(scale));
  int e2;
  const bool pow2 = a.sb > 0.f && frexpf(a.sb, &e2) == 0.5f;
  a.scale_q = !pow2;
  a.sl = pow2 ? a.sb * kLog2e : kLog2e;
  a.lse_mul = pow2 ? a.sb : 1.f;
  err = cudaFuncSetAttribute(flash_fwd_bf16_wg_kernel<D, TR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int grid = a.tiles < ptt_gemm::sm_count() ? a.tiles
                                                 : ptt_gemm::sm_count();
  flash_fwd_bf16_wg_kernel<D, TR>
      <<<grid, ptt_wg::kThreads, C::kSmemBytes, stream>>>(mq, mk, mv, a);
  return (int)cudaGetLastError();
}

// The operands' orientations on the wgmma backward: q, k and v in token
// rows where all three have feature stride 1, else feature rows; do in its
// own (token rows where its feature stride is 1).  TMA must describe each
// in its orientation, and the 16-byte stores each output in its own (wg_ok;
// kernels/flash_attention.py bwd_path makes the same choice).
bool bwd_wg_ok(const void* const* p, const Strides* st, int D, int Tq, int Tk,
               int H, int B) {
  const bool tr = token_rows(st, 3);
  const int T[7] = {Tq, Tk, Tk, Tq, Tq, Tk, Tk};
  for (int i = 0; i < 7; ++i) {
    const bool own = i < 3 ? tr : st[i].d == 1;
    if (!wg_ok(p[i], st[i], own, D, T[i], H, B)) return false;
  }
  return true;
}

// the wgmma backward: dk/dv, then dq, each one persistent launch of
// min(work tiles, SMs) CTAs
template <int D, bool TR, bool DTR>
int launch_bwd_wg(const bf16* q, const bf16* k, const bf16* v,
                  const bf16* dout, const float* lse, const float* delta,
                  bf16* dq, bf16* dk, bf16* dv, int H, int B, int Tq, int Tk,
                  int kv_len, int causal, float scale, const Strides* st,
                  long long ls_b, long long ls_h, cudaStream_t stream) {
  BwdArgs a;
  a.lse = lse;
  a.delta = delta;
  a.ls_b = ls_b;
  a.ls_h = ls_h;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.kend = Tk < kv_len ? Tk : kv_len;
  a.causal = causal;
  a.sb = __bfloat162float(__float2bfloat16_rn(scale));
  int e2;
  const bool pow2 = a.sb > 0.f && frexpf(a.sb, &e2) == 0.5f;
  a.scale_q = !pow2;
  a.sl = pow2 ? a.sb * kLog2e : kLog2e;
  const int sms = ptt_gemm::sm_count();
  CUtensorMap mq, mk, mv, mdo;
  int grid;
  cudaError_t err;
  // dk/dv: k and v in 128-key tiles, q and do in blocks of kDkvN queries
  if ((err = wg_map(&mq, q, st[0], TR, D, Tq, H, B, kDkvN<D>)) !=
          cudaSuccess ||
      (err = wg_map(&mk, k, st[1], TR, D, Tk, H, B, kBwdM)) != cudaSuccess ||
      (err = wg_map(&mv, v, st[2], TR, D, Tk, H, B, kBwdM)) != cudaSuccess ||
      (err = wg_map(&mdo, dout, st[3], DTR, D, Tq, H, B, kDkvN<D>)) !=
          cudaSuccess)
    return (int)err;
  a.o0 = dk;
  a.o1 = dv;
  a.s0 = st[5];
  a.s1 = st[6];
  a.mul0 = pow2 ? a.sb : 1.f;
  a.mul1 = 1.f;
  a.nt = (Tk + kBwdM - 1) / kBwdM;
  a.tiles = B * H * a.nt;
  err = cudaFuncSetAttribute(flash_bwd_dkv_bf16_wg_kernel<D, TR, DTR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DkvCfg<D>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  grid = a.tiles < sms ? a.tiles : sms;
  flash_bwd_dkv_bf16_wg_kernel<D, TR, DTR>
      <<<grid, kBwdThreads, DkvCfg<D>::kSmemBytes, stream>>>(mq, mk, mv, mdo,
                                                            a);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  // dq: q and do in 128-query tiles, k and v in 64-key blocks
  if ((err = wg_map(&mq, q, st[0], TR, D, Tq, H, B, kBwdM)) != cudaSuccess ||
      (err = wg_map(&mk, k, st[1], TR, D, Tk, H, B, kDqN)) !=
          cudaSuccess ||
      (err = wg_map(&mv, v, st[2], TR, D, Tk, H, B, kDqN)) !=
          cudaSuccess ||
      (err = wg_map(&mdo, dout, st[3], DTR, D, Tq, H, B, kBwdM)) !=
          cudaSuccess)
    return (int)err;
  a.o0 = dq;
  a.o1 = nullptr;
  a.s0 = st[4];
  a.mul0 = scale;
  a.nt = (Tq + kBwdM - 1) / kBwdM;
  a.tiles = B * H * a.nt;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_wg_kernel<D, TR, DTR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             DqCfg<D>::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  grid = a.tiles < sms ? a.tiles : sms;
  flash_bwd_dq_bf16_wg_kernel<D, TR, DTR>
      <<<grid, kBwdThreads, DqCfg<D>::kSmemBytes, stream>>>(mq, mk, mv, mdo,
                                                            a);
  return (int)cudaGetLastError();
}

template <int D, bool TR>
int launch_bwd(const bf16* q, const bf16* k, const bf16* v,
               const bf16* dout, const float* lse, const float* delta,
               bf16* dq, bf16* dk, bf16* dv, int H, int B, int Tq, int Tk,
               int kv_len, int causal, float scale, const Strides* st,
               long long ls_b, long long ls_h, cudaStream_t stream) {
  auto vec = TR ? vec16_tr : vec16_fr;
  const int tiles = 6 * Tiles<D, TR>::kElems * (int)sizeof(bf16);
  const int smem_dkv = tiles + 4 * kTile * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<D, TR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<D, TR>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             tiles);
  if (err != cudaSuccess) return (int)err;
  const int vq = vec(q, st[0]), vk = vec(k, st[1]);
  const int vv = vec(v, st[2]), vo = vec(dout, st[3]);
  const dim3 grid_k(B * H, (Tk + kTile - 1) / kTile);
  flash_bwd_dkv_bf16_kernel<D, TR><<<grid_k, kThreads, smem_dkv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, kv_len, causal, scale,
      st[0], st[1], st[2], st[3], ls_b, ls_h, st[5], st[6], vq, vk, vv, vo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(B * H, (Tq + kTile - 1) / kTile);
  flash_bwd_dq_bf16_kernel<D, TR><<<grid_q, kThreads, tiles, stream>>>(
      q, k, v, dout, lse, delta, dq, H, Tq, Tk, kv_len, causal, scale, st[0],
      st[1], st[2], st[3], ls_b, ls_h, st[4], vq, vk, vv, vo);
  return (int)cudaGetLastError();
}

void read_strides(Strides* st, const long long* strides, int n) {
  for (int i = 0; i < n; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                    strides[4 * i + 3]};
}

}  // namespace

// q [B, H, Tq, D], k and v [B, H, Tk, D] and o [B, H, Tq, D], bf16, in any
// layout: strides[16] holds (batch, head, feature, token) element strides
// for q, k, v and o in that order, strides[16:18] the batch and head
// strides of lse [B, H, Tq] (f32, token stride 1).  D is 64 or 128;
// 1 <= kv_len <= Tk.  path 1: the wgmma kernel, which needs operands that
// TMA can describe (wg_ok; q, k, v and o all in token rows or all in feature
// rows) and returns cudaErrorInvalidValue on others; path 0: the mma.sync
// kernel, any layout.  The caller chooses (kernels/flash_attention.py
// fwd_bf16_path).  Returns a cudaError_t as int.
extern "C" int ptt_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int H,
                                  int D, int B, int Tq, int Tk, int kv_len,
                                  int causal, float scale,
                                  const long long* strides, int path,
                                  void* stream) {
  if (H <= 0 || B <= 0 || Tq <= 0 || Tk <= 0 || kv_len < 1 || kv_len > Tk ||
      (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  read_strides(st, strides, 4);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (path == 1) {
    const bool tr = token_rows(st, 4);
    if (!(wg_ok(q, st[0], tr, D, Tq, H, B) &&
          wg_ok(k, st[1], tr, D, Tk, H, B) &&
          wg_ok(v, st[2], tr, D, Tk, H, B) &&
          wg_ok(o, st[3], tr, D, Tq, H, B)))
      return (int)cudaErrorInvalidValue;
    auto go = D == 64
                  ? (tr ? launch_fwd_wg<64, true> : launch_fwd_wg<64, false>)
                  : (tr ? launch_fwd_wg<128, true>
                        : launch_fwd_wg<128, false>);
    return go(qb, kb, vb, ob, lf, H, B, Tq, Tk, kv_len, causal, scale, st,
              strides[16], strides[17], s);
  }
  const bool tr = token_rows(st, 3);
  auto go = D == 64 ? (tr ? launch_fwd<64, true> : launch_fwd<64, false>)
                    : (tr ? launch_fwd<128, true> : launch_fwd<128, false>);
  return go(qb, kb, vb, ob, lf, H, B, Tq, Tk, kv_len, causal, scale, st,
            strides[16], strides[17], s);
}

// The backward of ptt_flash_fwd_bf16: q, k, v, do and the outputs dq, dk, dv
// bf16 in any layout, strides[28] their (batch, head, feature, token)
// element strides in that order, strides[28:30] the batch and head strides
// that lse and delta [B, H, Tq] (f32, token stride 1) share.  Two launches,
// dk/dv then dq.  path 1: the wgmma kernels, which need operands that TMA
// can describe (bwd_wg_ok: q, k and v in one orientation, do and each
// output in its own) and return cudaErrorInvalidValue on others; path 0:
// the mma.sync kernels, any layout.  The caller chooses
// (kernels/flash_attention.py bwd_bf16_path).  Returns a cudaError_t as
// int.
extern "C" int ptt_flash_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, int H, int D,
                                  int B, int Tq, int Tk, int kv_len,
                                  int causal, float scale,
                                  const long long* strides, int path,
                                  void* stream) {
  if (H <= 0 || B <= 0 || Tq <= 0 || Tk <= 0 || kv_len < 1 || kv_len > Tk ||
      (path != 0 && path != 1))
    return (int)cudaErrorInvalidValue;
  Strides st[7];
  read_strides(st, strides, 7);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* ef = static_cast<const float*>(delta);
  bf16* dqb = static_cast<bf16*>(dq);
  bf16* dkb = static_cast<bf16*>(dk);
  bf16* dvb = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  if (path == 1) {
    const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
    if (!bwd_wg_ok(ptrs, st, D, Tq, Tk, H, B))
      return (int)cudaErrorInvalidValue;
    const bool tr = token_rows(st, 3), dtr = st[3].d == 1;
    typedef int (*Go)(const bf16*, const bf16*, const bf16*, const bf16*,
                      const float*, const float*, bf16*, bf16*, bf16*, int,
                      int, int, int, int, int, float, const Strides*,
                      long long, long long, cudaStream_t);
    static const Go go[2][2][2] = {
        {{launch_bwd_wg<64, false, false>, launch_bwd_wg<64, false, true>},
         {launch_bwd_wg<64, true, false>, launch_bwd_wg<64, true, true>}},
        {{launch_bwd_wg<128, false, false>, launch_bwd_wg<128, false, true>},
         {launch_bwd_wg<128, true, false>, launch_bwd_wg<128, true, true>}}};
    return go[D == 128][tr][dtr](qb, kb, vb, ob, lf, ef, dqb, dkb, dvb, H, B,
                                 Tq, Tk, kv_len, causal, scale, st,
                                 strides[28], strides[29], s);
  }
  const bool tr = token_rows(st, 4);   // q, k, v, do
  auto go = D == 64 ? (tr ? launch_bwd<64, true> : launch_bwd<64, false>)
                    : (tr ? launch_bwd<128, true> : launch_bwd<128, false>);
  return go(qb, kb, vb, ob, lf, ef, dqb, dkb, dvb, H, B, Tq, Tk, kv_len,
            causal, scale, st, strides[28], strides[29], s);
}
