// Flash-attention backward for Hopper (sm_90a), for any layout, on the
// tensor cores.
//
// Replaces the Pallas TPU kernels
// paddle_tpu/kernels/flash_attention.py:_flash_bwd_hdt (bodies
// _bwd_fused1_kernel_hdt, _bwd_fused_kernel_hdt, _bwd_dkv_kernel_hdt and
// _bwd_dq_kernel_hdt) and _flash_bwd (bodies _bwd_fused1_kernel,
// _bwd_dkv_kernel and _bwd_dq_kernel).  From the forward's q, k, v, its
// lse, do and delta = rowsum(do * o) (taken in f32 by the caller), with
// every operand and output given by its (batch, head, feature, token)
// element strides, so the head-major [H, d, B*T] and the [B, H, T, d]
// layouts take the same kernels:
//   p  = exp(scale * q^T k - lse)        (0 where masked)
//   ds = p * (do^T v - delta)
//   dv = p^T do,   dk = ds^T (scale * q),   dq = scale * ds k
// with the forward's masks: keys after the query (causal), keys >= kv_len,
// and the ragged tails of every tile.  dq, dk, dv are written through
// their own strides.
//
// Bound on the H100: operations.  The least work is 5 d-long dot products
// per kept (query, key) pair (s, dp, and the three gradient updates), 10*d
// FLOP: 21.517 GFLOP at B 32, H 8, T 512, d 64; in 3xTF32 the tensor cores
// do three times that, 64.6 GFLOP at 495 TFLOP/s = 0.130 ms.  q, k, v, do,
// dq, dk, dv move once (235 MB, 0.070 ms at 3.35 TB/s).  This design
// recomputes s and dp in both of its kernels: 7 products per kept pair,
// 1.4x the least work, and it computes whole 64 x 64 tiles on the causal
// diagonal.
//
// Design: two kernels on mma.sync m16n8k8 TF32 with the 3xTF32 split
// (flash_mma.cuh: numerics, fragment maps, staging), no atomics, so the
// result is the same bits on every run.  Triton is not used: the kernels
// need exact control of the three-pass split and of the fragment layout
// that lets p and ds feed the gradient products from registers.  A CTA is
// 4 warps, 16 tile rows a warp; every tile is a [64][d + 4] token-row tile
// staged by cp.async along the path chosen from its operand's strides
// (16-byte along features, 4-byte along tokens, or 4-byte generic), so the
// token-strided do that autograd hands over and the [B, T, H, d] views
// take 16-byte copies.
//   dk/dv: one CTA per (64-key tile, batch row, head); the warp's 16 key
//     rows are the M dimension.  The key and value tiles stay in shared
//     memory while the CTA walks the query tiles from the causal diagonal
//     to Tq, with (q, do, lse, delta) double-buffered so the next query
//     tile's copy overlaps this one's products.  Per block of 16 queries,
//     s^T = k q^T and dp^T = v do^T land in accumulators (scale goes into
//     the exponent), p^T and ds^T are formed there and used directly as A
//     operands (k relabelled within each 8-block, the B rows read as 2t
//     and 2t + 1) of dv += p^T do and dk += ds^T q.  dk (times scale when
//     written) and dv stay in registers.
//   dq: one CTA per (64-query tile, batch row, head).  The q and do tiles
//     stay in shared memory while the CTA walks the key tiles up to the
//     diagonal and kv_len, k and v double-buffered; s and dp are
//     recomputed per block of 64 keys (32 at d 128), ds is formed in
//     registers and dq += ds k takes it as the A operand.  dq (times scale
//     at the end) stays in registers.
//   Both kernels skip a block in which every pair is masked for a warp
//   (the causal diagonal).  The block sizes keep every accumulator in
//   registers.
// Shared memory: 6 tiles, 104,448 bytes (+ 1 KB of lse/delta for dk/dv) at
// d 64, 202,752 at d 128.  Occupancy (ptxas, printed by chip_smoke.py's
// build phase): at d 64 both kernels take about 160 registers and no
// spills, and shared memory allows 2 CTAs (8 warps) an SM; at d 128 one CTA
// (dk/dv about 225 registers, dq about 165), no spills.
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

using namespace ptt_flash;

// acc[f] (rows r, r + 8 of the warp; features 8 f + 2t, + 1) times mul,
// through out's strides, for rows < T
template <int NF>
__device__ __forceinline__ void write_rows(float* out, const Strides& s,
                                           int b, int h, int T, int r0,
                                           int t, float mul,
                                           const float (&acc)[NF][4]) {
  float* base = out + b * s.b + h * s.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + 8 * half;
    if (row >= T) continue;
    float* p = base + (long long)row * s.t;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      p[(long long)(8 * f + 2 * t) * s.d] = mul * acc[f][2 * half];
      p[(long long)(8 * f + 2 * t + 1) * s.d] = mul * acc[f][2 * half + 1];
    }
  }
}

// S[i] <- base[t0 + i] for t0 + i < tend, else 0, i < 64 (lse, delta rows)
__device__ __forceinline__ void stage_row(float* S, const float* base,
                                          int t0, int tend, int i) {
  const bool in = t0 + i < tend;
  cp_async4(S + i, in ? base + t0 + i : base, in);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Tq, int Tk, int kv_len, int causal,
                         float scale, Strides qs, Strides ks, Strides vs,
                         Strides os, long long ls_b, long long ls_h,
                         Strides dks, Strides dvs, int mq, int mk, int mv,
                         int mo) {
  constexpr int TF = Tile<D>::kFloats, NF = D / 8;
  constexpr int QN = 16, NJ = QN / 8;   // queries per block
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [64][LD] key rows
  float* Vs = Ks + TF;                          // [64][LD] value rows
  float* QO = Vs + TF;      // stage s: q rows at 2s TF, do rows after
  float* LE = QO + 4 * TF;  // stage s: lse at 128 s, delta at 128 s + 64

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int k0 = blockIdx.y * kTile;            // first key tiles first
  const int wr = 16 * warp;
  const int kr0 = k0 + wr + g, kr1 = kr0 + 8;   // this lane's two keys
  const int kend = min(Tk, kv_len);

  const float* qh = q + b * qs.b + h * qs.h;
  const float* oh = dout + b * os.b + h * os.h;
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

  // query tile from qt0 (q, do, lse, delta) into stage sb
  auto stage_q = [&](int sb, int qt0) {
    stage<D>(QO + 2 * sb * TF, qh, qs, qt0, Tq, mq);
    stage<D>(QO + (2 * sb + 1) * TF, oh, os, qt0, Tq, mo);
    if (threadIdx.x < kTile)
      stage_row(LE + 2 * kTile * sb, lh, qt0, Tq, threadIdx.x);
    else
      stage_row(LE + 2 * kTile * sb + kTile, eh, qt0, Tq,
                threadIdx.x - kTile);
  };
  if (nqt > 0) {
    stage<D>(Ks, k + b * ks.b + h * ks.h, ks, k0, kend, mk);
    stage<D>(Vs, v + b * vs.b + h * vs.h, vs, k0, kend, mv);
    stage_q(0, qstart);
    cp_commit();
  }
  const float sl2 = scale * kLog2e;   // s^T is taken unscaled

  for (int it = 0; it < nqt; ++it) {
    const int q0 = qstart + it * kTile, sb = it & 1;
    if (it + 1 < nqt) {   // the next tile's copy overlaps this tile
      stage_q(sb ^ 1, q0 + kTile);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Qs = QO + 2 * sb * TF;
    const float* Os = Qs + TF;
    const float* Ls = LE + 2 * kTile * sb;
    const float* Es = Ls + kTile;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += QN) {
      const int qb = q0 + c0;   // the block's first query
      // nothing to do where every pair is masked for the warp's keys
      if (qb >= Tq || (causal && qb + QN - 1 < k0 + wr)) continue;
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {   // s^T = k q^T
        float ka[4];
        load_a<D>(ka, Ks, wr + g, 8 * kk, t, 1.f);
        FragA ak;
        ak.set(ka);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB bq;
          load_b_rows<D>(bq, Qs, c0 + 8 * j, 8 * kk, g, t);
          mma3(s[j], ak, bq);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {   // dp^T = v do^T
        float va[4];
        load_a<D>(va, Vs, wr + g, 8 * kk, t, 1.f);
        FragA av;
        av.set(va);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB bo;
          load_b_rows<D>(bo, Os, c0 + 8 * j, 8 * kk, g, t);
          mma3(dp[j], av, bo);
        }
      }
      // p^T into s, ds^T into dp; columns are queries
      const bool need = k0 + kTile > kend || qb + QN > Tq ||
                        (causal && k0 + wr + 15 > qb);
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = c0 + 8 * j + 2 * t + (e & 1), qp = q0 + ql;
          const int key = e < 2 ? kr0 : kr1;
          const bool valid =
              !need || (key < kend && qp < Tq && (!causal || key <= qp));
          const float p =
              valid ? exp2f(fmaf(s[j][e], sl2, -Ls[ql] * kLog2e)) : 0.f;
          s[j][e] = p;
          dp[j][e] = p * (dp[j][e] - Es[ql]);
        }
      // dv += p^T do, dk += ds^T q (times scale when written); k runs over
      // the block's queries
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragA ap;
        a_from_c(ap, s[j]);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          FragB bo;
          load_b_cols<D>(bo, Os, c0 + 8 * j, 8 * f, g, t);
          mma3(dva[f], ap, bo);
        }
      }
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragA ads;
        a_from_c(ads, dp[j]);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          FragB bq;
          load_b_cols<D>(bq, Qs, c0 + 8 * j, 8 * f, g, t);
          mma3(dka[f], ads, bq);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  write_rows<NF>(dk, dks, b, h, Tk, kr0, t, scale, dka);
  write_rows<NF>(dv, dvs, b, h, Tk, kr0, t, 1.f, dva);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int H, int Tq, int Tk,
                        int kv_len, int causal, float scale, Strides qs,
                        Strides ks, Strides vs, Strides os, long long ls_b,
                        long long ls_h, Strides dqs, int mq, int mk, int mv,
                        int mo) {
  constexpr int TF = Tile<D>::kFloats, NF = D / 8;
  constexpr int KN = D == 64 ? 64 : 32, NJ = KN / 8;   // keys per block
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [64][LD] query rows
  float* Os = Qs + TF;                          // [64][LD] do rows
  float* KV = Os + TF;      // stage s: key rows at 2s TF, value rows after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // last tiles first
  const int wr = 16 * warp;
  const int qr0 = q0 + wr + g, qr1 = qr0 + 8;

  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;
  const float* lh = lse + b * ls_b + h * ls_h;
  const float* eh = delta + b * ls_b + h * ls_h;
  // lse in log2 units; s is taken unscaled
  const float lr0 = qr0 < Tq ? lh[qr0] * kLog2e : 0.f;
  const float lr1 = qr1 < Tq ? lh[qr1] * kLog2e : 0.f;
  const float sl2 = scale * kLog2e;
  const float er0 = qr0 < Tq ? eh[qr0] : 0.f, er1 = qr1 < Tq ? eh[qr1] : 0.f;
  int kend = min(Tk, kv_len);
  if (causal) kend = min(kend, q0 + kTile);
  const int ntiles = (kend + kTile - 1) / kTile;

  stage<D>(Qs, q + b * qs.b + h * qs.h, qs, q0, Tq, mq);
  stage<D>(Os, dout + b * os.b + h * os.h, os, q0, Tq, mo);
  stage<D>(KV, kh, ks, 0, kend, mk);
  stage<D>(KV + TF, vh, vs, 0, kend, mv);
  cp_commit();

  float dqa[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) dqa[f][e] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kTile, sb = it & 1;
    if (it + 1 < ntiles) {   // the next tile's copy overlaps this tile
      float* nb = KV + 2 * (sb ^ 1) * TF;
      stage<D>(nb, kh, ks, k0 + kTile, kend, mk);
      stage<D>(nb + TF, vh, vs, k0 + kTile, kend, mv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Ks = KV + 2 * sb * TF;
    const float* Vs = Ks + TF;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += KN) {
      const int kb = k0 + c0;   // the block's first key
      if (kb >= kend || (causal && kb > q0 + wr + 15)) continue;
      float s[NJ][4], dp[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {   // s = q k^T
        float qa[4];
        load_a<D>(qa, Qs, wr + g, 8 * kk, t, 1.f);
        FragA aq;
        aq.set(qa);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB bk;
          load_b_rows<D>(bk, Ks, c0 + 8 * j, 8 * kk, g, t);
          mma3(s[j], aq, bk);
        }
      }
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {   // dp = do v^T
        float oa[4];
        load_a<D>(oa, Os, wr + g, 8 * kk, t, 1.f);
        FragA ao;
        ao.set(oa);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB bv;
          load_b_rows<D>(bv, Vs, c0 + 8 * j, 8 * kk, g, t);
          mma3(dp[j], ao, bv);
        }
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
          const float p =
              valid ? exp2f(fmaf(s[j][e], sl2, -(e < 2 ? lr0 : lr1))) : 0.f;
          s[j][e] = p * (dp[j][e] - (e < 2 ? er0 : er1));   // ds
        }
      // dq += ds k; k runs over the block's keys
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragA a;
        a_from_c(a, s[j]);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          FragB bk;
          load_b_cols<D>(bk, Ks, c0 + 8 * j, 8 * f, g, t);
          mma3(dqa[f], a, bk);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  write_rows<NF>(dq, dqs, b, h, Tq, qr0, t, scale, dqa);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, int H, int B, int Tq, int Tk, int kv_len, int causal,
           float scale, const Strides* st, long long ls_b, long long ls_h,
           cudaStream_t stream) {
  constexpr int TF = Tile<D>::kFloats;
  const int smem_dkv = (6 * TF + 4 * kTile) * (int)sizeof(float);
  const int smem_dq = 6 * TF * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return (int)err;
  const int mq = stage_mode(q, st[0]), mk = stage_mode(k, st[1]);
  const int mv = stage_mode(v, st[2]), mo = stage_mode(dout, st[3]);
  const dim3 grid_k(B * H, (Tk + kTile - 1) / kTile);
  flash_bwd_dkv_kernel<D><<<grid_k, kThreads, smem_dkv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, kv_len, causal, scale,
      st[0], st[1], st[2], st[3], ls_b, ls_h, st[5], st[6], mq, mk, mv, mo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q(B * H, (Tq + kTile - 1) / kTile);
  flash_bwd_dq_kernel<D><<<grid_q, kThreads, smem_dq, stream>>>(
      q, k, v, dout, lse, delta, dq, H, Tq, Tk, kv_len, causal, scale, st[0],
      st[1], st[2], st[3], ls_b, ls_h, st[4], mq, mk, mv, mo);
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, Tq, D], k and v [B, H, Tk, D], do [B, H, Tq, D] and the outputs
// dq [B, H, Tq, D], dk and dv [B, H, Tk, D] in any layout: strides[28]
// holds (batch, head, feature, token) element strides for q, k, v, do, dq,
// dk and dv in that order, strides[28:30] the batch and head strides that
// lse and delta [B, H, Tq] share (token stride 1).  f32; D is 64 or 128;
// 1 <= kv_len <= Tk.  Returns a cudaError_t as int.
extern "C" int ptt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* dout, const void* lse,
                             const void* delta, void* dq, void* dk, void* dv,
                             int H, int D, int B, int Tq, int Tk, int kv_len,
                             int causal, float scale,
                             const long long* strides, void* stream) {
  if (H <= 0 || B <= 0 || Tq <= 0 || Tk <= 0 || kv_len < 1 || kv_len > Tk)
    return (int)cudaErrorInvalidValue;
  Strides st[7];
  for (int i = 0; i < 7; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                    strides[4 * i + 3]};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  const float* lf = static_cast<const float*>(lse);
  const float* ef = static_cast<const float*>(delta);
  float* dqf = static_cast<float*>(dq);
  float* dkf = static_cast<float*>(dk);
  float* dvf = static_cast<float*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(qf, kf, vf, of, lf, ef, dqf, dkf, dvf, H, B, Tq, Tk,
                        kv_len, causal, scale, st, strides[28], strides[29],
                        s);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, ef, dqf, dkf, dvf, H, B, Tq, Tk,
                         kv_len, causal, scale, st, strides[28], strides[29],
                         s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
