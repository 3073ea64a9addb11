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
// Design: FlashAttention-2 on mma.sync m16n8k16 bf16 with f32 accumulators
// (bf16_mma.cuh: fragments, ldmatrix, packing), one product per product:
// no split.  Triton is not used: the kernels need exact control of where
// p and ds are rounded and of the fragment layout that lets them feed the
// next product from registers.  A CTA is 4 warps, 16 tile rows a warp.
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
#include "tf32_mma.cuh"

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
// 1 <= kv_len <= Tk.  Returns a cudaError_t as int.
extern "C" int ptt_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int H,
                                  int D, int B, int Tq, int Tk, int kv_len,
                                  int causal, float scale,
                                  const long long* strides, void* stream) {
  if (H <= 0 || B <= 0 || Tq <= 0 || Tk <= 0 || kv_len < 1 || kv_len > Tk)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  read_strides(st, strides, 4);
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  bf16* ob = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool tr = token_rows(st, 3);
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  auto go = D == 64 ? (tr ? launch_fwd<64, true> : launch_fwd<64, false>)
                    : (tr ? launch_fwd<128, true> : launch_fwd<128, false>);
  return go(qb, kb, vb, ob, lf, H, B, Tq, Tk, kv_len, causal, scale, st,
            strides[16], strides[17], s);
}

// The backward of ptt_flash_fwd_bf16: q, k, v, do and the outputs dq, dk, dv
// bf16 in any layout, strides[28] their (batch, head, feature, token)
// element strides in that order, strides[28:30] the batch and head strides
// that lse and delta [B, H, Tq] (f32, token stride 1) share.  Two launches,
// dk/dv then dq.  Returns a cudaError_t as int.
extern "C" int ptt_flash_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dq, void* dk, void* dv, int H, int D,
                                  int B, int Tq, int Tk, int kv_len,
                                  int causal, float scale,
                                  const long long* strides, void* stream) {
  if (H <= 0 || B <= 0 || Tq <= 0 || Tk <= 0 || kv_len < 1 || kv_len > Tk)
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
  const bool tr = token_rows(st, 4);   // q, k, v, do
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
  auto go = D == 64 ? (tr ? launch_bwd<64, true> : launch_bwd<64, false>)
                    : (tr ? launch_bwd<128, true> : launch_bwd<128, false>);
  return go(qb, kb, vb, ob, lf, ef, dqb, dkb, dvb, H, B, Tq, Tk, kv_len,
            causal, scale, st, strides[28], strides[29], s);
}
