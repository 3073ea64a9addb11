// Flash-attention backward for Hopper (sm_90a), for any layout.
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
// FLOP, on the f32 CUDA cores (67 TFLOP/s); q, k, v, do, dq, dk, dv move
// once.  This design recomputes s and dp in both of its kernels: 7 products
// per kept pair, 1.4x the least work (the one-pass JAX plan makes 5), and
// it computes whole 64 x 64 tiles on the causal diagonal.
//
// Design (simple first; no wgmma, no TMA): two kernels, no atomics, so the
// result is the same bits on every run.  Every CTA has 256 threads (16 x 16)
// and works on 64 x 64 (query, key) tiles held in shared memory as token
// rows ([64][d + 4] floats; the pad keeps the float4 reads of 8 rows in 8
// different bank groups).  Per tile pair, step A gives each thread a 4 x 4
// block of s and dp (queries tx + 16 i, keys 4 ty + l) from float4 reads,
// turns them into p and ds and puts them in shared memory; step B is a
// rank-64 update of the thread's block of the gradient (4 tokens by 4 or 8
// features).
//   dk/dv: one CTA per (64-key tile, batch row, head).  The key and value
//     tiles stay in shared memory while the CTA walks the query tiles from
//     the causal diagonal to Tq, staging q (times scale), do, lse and delta
//     for each; dk and dv stay in registers.
//   dq: one CTA per (64-query tile, batch row, head).  The query and do
//     tiles stay in shared memory while the CTA walks the key tiles up to
//     the diagonal and kv_len; dq stays in registers.
// Staging reads each tile with neighbouring threads on neighbouring tokens,
// coalesced when the token stride is 1 (q, k, v from fused_mha's
// projections); a token-strided operand (do from autograd, the
// [B, H, T, d] layout) is then read through L1.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;         // tokens per tile, queries and keys
constexpr int kNT = 256;       // threads per CTA, 16 x 16
constexpr int kLP = kT + 4;    // row of the p / ds tiles

// element strides of one operand: batch row, head, feature, token
struct Strides {
  long long b, h, d, t;
};

template <int D>
struct Tile {
  static constexpr int LD = D + 4;          // token row in shared memory
  static constexpr int kFloats = kT * LD;   // one [64][LD] tile
  static constexpr int NG = D / 64;         // feature groups of 64
};

// S[t][j] = base[j, t0 + t] * mul for t0 + t < tend, else 0.
template <int D>
__device__ __forceinline__ void stage(float* S, const float* base, Strides s,
                                      int t0, int tend, float mul) {
  for (int idx = threadIdx.x; idx < D * kT; idx += kNT) {
    const int j = idx / kT, t = idx % kT, tp = t0 + t;
    S[t * Tile<D>::LD + j] =
        tp < tend ? base[(long long)j * s.d + (long long)tp * s.t] * mul
                  : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// Step A: s[i][l] = Qr[tx + 16 i] . Kr[4 ty + l] and
// dp[i][l] = Or[tx + 16 i] . Vr[4 ty + l], over the D features of the rows.
template <int D>
__device__ __forceinline__ void scores(const float* Qr, const float* Or,
                                       const float* Kr, const float* Vr,
                                       int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int LD = Tile<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int l = 0; l < 4; ++l) s[i][l] = dp[i][l] = 0.f;
#pragma unroll 2
  for (int j = 0; j < D; j += 4) {
    float4 qv[4], ov[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = ld4(Qr + (tx + 16 * i) * LD + j);
      ov[i] = ld4(Or + (tx + 16 * i) * LD + j);
    }
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      const float4 kv = ld4(Kr + (4 * ty + l) * LD + j);
      const float4 vv = ld4(Vr + (4 * ty + l) * LD + j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[i][l] = dot4(qv[i], kv, s[i][l]);
        dp[i][l] = dot4(ov[i], vv, dp[i][l]);
      }
    }
  }
}

// acc[l][4 g + m] += sum_r w[r][4 ty + l] * X[r][64 g + 4 tx + m] over the
// first `rows` rows: w is a [64][kLP] tile, X a [64][LD] tile.
template <int D>
__device__ __forceinline__ void rank_update(const float* w, const float* X,
                                            int rows, int tx, int ty,
                                            float (&acc)[4][4 * Tile<D>::NG]) {
  constexpr int LD = Tile<D>::LD, NG = Tile<D>::NG;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    const float4 wv = ld4(w + r * kLP + 4 * ty);
    const float wl[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const float4 xv = ld4(X + r * LD + 64 * g + 4 * tx);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        acc[l][4 * g + 0] = fmaf(wl[l], xv.x, acc[l][4 * g + 0]);
        acc[l][4 * g + 1] = fmaf(wl[l], xv.y, acc[l][4 * g + 1]);
        acc[l][4 * g + 2] = fmaf(wl[l], xv.z, acc[l][4 * g + 2]);
        acc[l][4 * g + 3] = fmaf(wl[l], xv.w, acc[l][4 * g + 3]);
      }
    }
  }
}

// out[b, h, token t0 + 4 ty + l, feature 64 g + 4 tx + m] =
// mul * acc[l][4 g + m] for tokens < T, through out's strides s.
template <int D>
__device__ __forceinline__ void write_rows(float* out, Strides s, int h,
                                           int b, int T, int t0, int tx,
                                           int ty, float mul,
                                           const float (&acc)[4][4 * Tile<D>::NG]) {
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const int t = t0 + 4 * ty + l;
    if (t >= T) continue;
    float* row = out + b * s.b + h * s.h + (long long)t * s.t;
#pragma unroll
    for (int g = 0; g < Tile<D>::NG; ++g)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        row[(long long)(64 * g + 4 * tx + m) * s.d] = mul * acc[l][4 * g + m];
  }
}

template <int D>
__global__ void __launch_bounds__(kNT)
    flash_bwd_dkv_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int Tq, int Tk, int kv_len, int causal, float scale,
                         Strides qs, Strides ks, Strides vs, Strides os,
                         long long ls_b, long long ls_h, Strides dks,
                         Strides dvs) {
  constexpr int NG = Tile<D>::NG, TF = Tile<D>::kFloats;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);  // [64][LD] key rows
  float* Vs = Ks + TF;                          // [64][LD]
  float* Qs = Vs + TF;                          // [64][LD] query rows x scale
  float* Os = Qs + TF;                          // [64][LD] do rows
  float* Ps = Os + TF;                          // [64 q][kLP] p
  float* Ss = Ps + kT * kLP;                    // [64 q][kLP] ds
  float* Ls = Ss + kT * kLP;                    // [64] lse
  float* Es = Ls + kT;                          // [64] delta

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kT, b = blockIdx.y, h = blockIdx.z;
  const int kend = min(Tk, kv_len);

  const float* qh = q + b * qs.b + h * qs.h;
  const float* oh = dout + b * os.b + h * os.h;
  const float* lh = lse + b * ls_b + h * ls_h;
  const float* eh = delta + b * ls_b + h * ls_h;

  stage<D>(Ks, k + b * ks.b + h * ks.h, ks, k0, kend, 1.f);
  stage<D>(Vs, v + b * vs.b + h * vs.h, vs, k0, kend, 1.f);

  float dka[4][4 * NG], dva[4][4 * NG];
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) dka[l][c] = dva[l][c] = 0.f;

  for (int q0 = (causal ? k0 : 0); k0 < kend && q0 < Tq; q0 += kT) {
    __syncthreads();  // every thread is done with the previous query tile
    stage<D>(Qs, qh, qs, q0, Tq, scale);
    stage<D>(Os, oh, os, q0, Tq, 1.f);
    if (threadIdx.x < kT) {
      const int qp = q0 + threadIdx.x;
      Ls[threadIdx.x] = qp < Tq ? lh[qp] : 0.f;
      Es[threadIdx.x] = qp < Tq ? eh[qp] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(Qs, Os, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = tx + 16 * i, qp = q0 + qi;
      float pv[4], dsv[4];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int kp = k0 + 4 * ty + l;
        const bool valid = kp < kend && qp < Tq && (!causal || kp <= qp);
        pv[l] = valid ? expf(s[i][l] - Ls[qi]) : 0.f;
        dsv[l] = pv[l] * (dp[i][l] - Es[qi]);
      }
      *reinterpret_cast<float4*>(Ps + qi * kLP + 4 * ty) =
          make_float4(pv[0], pv[1], pv[2], pv[3]);
      *reinterpret_cast<float4*>(Ss + qi * kLP + 4 * ty) =
          make_float4(dsv[0], dsv[1], dsv[2], dsv[3]);
    }
    __syncthreads();

    const int rows = min(kT, Tq - q0);
    rank_update<D>(Ps, Os, rows, tx, ty, dva);   // dv += p^T do
    rank_update<D>(Ss, Qs, rows, tx, ty, dka);   // dk += ds^T (scale q)
  }

  write_rows<D>(dk, dks, h, b, Tk, k0, tx, ty, 1.f, dka);
  write_rows<D>(dv, dvs, h, b, Tk, k0, tx, ty, 1.f, dva);
}

template <int D>
__global__ void __launch_bounds__(kNT)
    flash_bwd_dq_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq, int Tq, int Tk, int kv_len,
                        int causal, float scale, Strides qs, Strides ks,
                        Strides vs, Strides os, long long ls_b,
                        long long ls_h, Strides dqs) {
  constexpr int NG = Tile<D>::NG, TF = Tile<D>::kFloats;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [64][LD] query rows x scale
  float* Os = Qs + TF;                          // [64][LD] do rows
  float* Ks = Os + TF;                          // [64][LD] key rows
  float* Vs = Ks + TF;                          // [64][LD] value rows
  float* St = Vs + TF;                          // [64 k][kLP] ds, key-major

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = blockIdx.x * kT, b = blockIdx.y, h = blockIdx.z;

  stage<D>(Qs, q + b * qs.b + h * qs.h, qs, q0, Tq, scale);
  stage<D>(Os, dout + b * os.b + h * os.h, os, q0, Tq, 1.f);
  const float* lh = lse + b * ls_b + h * ls_h;
  const float* eh = delta + b * ls_b + h * ls_h;
  float lrow[4], erow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + tx + 16 * i;
    lrow[i] = qp < Tq ? lh[qp] : 0.f;
    erow[i] = qp < Tq ? eh[qp] : 0.f;
  }
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;

  float dqa[4][4 * NG];
#pragma unroll
  for (int l = 0; l < 4; ++l)
#pragma unroll
    for (int c = 0; c < 4 * NG; ++c) dqa[l][c] = 0.f;

  int kend = causal ? min(Tk, q0 + kT) : Tk;
  kend = min(kend, kv_len);
  for (int k0 = 0; k0 < kend; k0 += kT) {
    __syncthreads();  // every thread is done with the previous key tile
    stage<D>(Ks, kh, ks, k0, kend, 1.f);
    stage<D>(Vs, vh, vs, k0, kend, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    scores<D>(Qs, Os, Ks, Vs, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = tx + 16 * i, qp = q0 + qi;
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const int kl = 4 * ty + l, kp = k0 + kl;
        const bool valid = kp < kend && qp < Tq && (!causal || kp <= qp);
        const float p = valid ? expf(s[i][l] - lrow[i]) : 0.f;
        St[kl * kLP + qi] = p * (dp[i][l] - erow[i]);
      }
    }
    __syncthreads();

    rank_update<D>(St, Ks, min(kT, kend - k0), tx, ty, dqa);  // ds k
  }

  write_rows<D>(dq, dqs, h, b, Tq, q0, tx, ty, scale, dqa);
}

template <int D>
int launch(const float* q, const float* k, const float* v, const float* dout,
           const float* lse, const float* delta, float* dq, float* dk,
           float* dv, int H, int B, int Tq, int Tk, int kv_len, int causal,
           float scale, const Strides* st, long long ls_b, long long ls_h,
           cudaStream_t stream) {
  constexpr int TF = Tile<D>::kFloats;
  const int smem_dkv = (4 * TF + 2 * kT * kLP + 2 * kT) * (int)sizeof(float);
  const int smem_dq = (4 * TF + kT * kLP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_dkv);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_dq);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((Tk + kT - 1) / kT, B, H);
  flash_bwd_dkv_kernel<D><<<grid_k, kNT, smem_dkv, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, Tq, Tk, kv_len, causal, scale, st[0],
      st[1], st[2], st[3], ls_b, ls_h, st[5], st[6]);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_q((Tq + kT - 1) / kT, B, H);
  flash_bwd_dq_kernel<D><<<grid_q, kNT, smem_dq, stream>>>(
      q, k, v, dout, lse, delta, dq, Tq, Tk, kv_len, causal, scale, st[0],
      st[1], st[2], st[3], ls_b, ls_h, st[4]);
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
