// Streamed LM head with softmax cross-entropy, forward and backward, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels paddle_tpu/kernels/lm_head.py:_fwd (body
// _fwd_kernel) and _bwd (body _bwd_kernel).  x [N, D], W [D, V] and labels
// [N] (int64, negative = ignored), all f32 and contiguous:
//   forward:  loss_n = lse_n - (x_n W)[y_n]  (0 where y_n < 0),
//             lse_n = logsumexp_v (x_n W)_v
//   backward: dlogits = (softmax(x W) - onehot(y)) * g   (g = 0 where y < 0)
//             dx = dlogits W^T,  dW = x^T dlogits
// The products are computed here, in this file's own tiled f32 GEMM, not by
// a library.
//
// Bound on the H100: operations.  The forward is one product, 2*N*D*V FLOP
// (537 GFLOP at N 16384, D 512, V 32000); the backward three (recompute,
// dx, dW), on the f32 CUDA cores (67 TFLOP/s).  The bytes (x, W, dx, dW
// once) are two orders of magnitude below that at these shapes.
//
// Design (simple first; no tensor cores, no TMA, single-buffered tiles).
// One tile loop serves every product (gemm_f32.cuh, shared with
// fused_block.cu): a CTA of 256 threads computes a 128 x 128 f32 tile,
// 8 x 8 a thread, over k-slices of 8 staged in shared memory, prefetching
// the next slice into registers.  Each operand comes with its own element
// strides, so one loop reads x, W, W^T and x^T.
//   lm_head_fwd: one CTA per 128 tokens walks the whole vocabulary (one
//     pass over W) and carries a running (max, sum of exp, gold logit) per
//     row across the vocab tiles, reduced over the 16 threads of a row with
//     shuffles.  It writes only loss [N] and lse [N]; no logit leaves the
//     chip.  The vocab tail is masked, so V is any width.
//   lm_head_bwd, per token chunk of C rows (the op's chunk_size), three
//     launches: (1) recompute the logits tile and write dlogits [C, V] to a
//     scratch buffer (a second pass over W); (2) dx = dlogits W^T (a third
//     pass over W); (3) dW (+)= x^T dlogits, accumulated in f32 across the
//     chunks in chunk order.  Every output element is summed by one thread
//     in a fixed order: no atomics, the same bits on every run.  The
//     scratch bounds memory at O(C*V) instead of O(N*V); a later design may
//     fuse it away.
#include <cuda_runtime.h>

#include "gemm_f32.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// reduce over the 16 threads that share a row (16 neighbouring lanes)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 1; o < BN / TN; o <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 1; o < BN / TN; o <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(NT)
    lm_head_fwd_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       const long long* __restrict__ labels,
                       float* __restrict__ loss, float* __restrict__ lse,
                       int N, int D, int V) {
  __shared__ __align__(16) float As[BK * AS];
  __shared__ __align__(16) float Bs[BK * BS];
  const int tr = threadIdx.x / (BN / TN), tc = threadIdx.x % (BN / TN);
  const int m0 = blockIdx.x * BM;
  const Mat A{x, D, 1}, B{w, V, 1};

  long long y[TM];
  float m[TM], l[TM], gold[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + split_idx(tr, i);
    y[i] = r < N ? labels[r] : -1;
    m[i] = kNegInf;
    l[i] = 0.f;
    gold[i] = 0.f;
  }

  for (int n0 = 0; n0 < V; n0 += BN) {
    float acc[TM][TN];
    tile_product(A, B, N, V, D, m0, n0, acc, As, Bs);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float tmax = kNegInf;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int c = n0 + split_idx(tc, j);
        if (c < V) {
          tmax = fmaxf(tmax, acc[i][j]);
          if (c == y[i]) gold[i] += acc[i][j];
        }
      }
      const float m_new = fmaxf(m[i], row_max(tmax));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (n0 + split_idx(tc, j) < V) sum += expf(acc[i][j] - m_new);
      l[i] = l[i] * expf(m[i] - m_new) + row_sum(sum);
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float g = row_sum(gold[i]);
    const int r = m0 + split_idx(tr, i);
    if (tc == 0 && r < N) {
      const float ls = m[i] + logf(fmaxf(l[i], 1e-30f));
      loss[r] = y[i] >= 0 ? ls - g : 0.f;
      lse[r] = ls;
    }
  }
}

// dl[r, c] = (exp(x_r . w_c - lse_r) - [c == y_r]) * g_r for one chunk
__global__ void __launch_bounds__(NT)
    lm_head_dlogits_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const long long* __restrict__ labels,
                           const float* __restrict__ lse,
                           const float* __restrict__ g,
                           float* __restrict__ dl, int C, int D, int V) {
  __shared__ __align__(16) float As[BK * AS];
  __shared__ __align__(16) float Bs[BK * BS];
  const int tr = threadIdx.x / (BN / TN), tc = threadIdx.x % (BN / TN);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[TM][TN];
  tile_product(Mat{x, D, 1}, Mat{w, V, 1}, C, V, D, m0, n0, acc, As, Bs);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + split_idx(tr, i);
    if (r >= C) continue;
    const long long y = labels[r];
    const float ls = lse[r], gr = g[r];
    float* row = dl + (long long)r * V;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + split_idx(tc, j);
      if (c < V)
        row[c] = (expf(acc[i][j] - ls) - (c == y ? 1.f : 0.f)) * gr;
    }
  }
}

// Cm[M, N] (row stride ldc) = A . B, plus Cm's old value when accumulate
__global__ void __launch_bounds__(NT)
    lm_head_gemm_kernel(const Mat A, const Mat B, float* __restrict__ Cm,
                long long ldc, int M, int N, int K, int accumulate) {
  __shared__ __align__(16) float As[BK * AS];
  __shared__ __align__(16) float Bs[BK * BS];
  const int tr = threadIdx.x / (BN / TN), tc = threadIdx.x % (BN / TN);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  float acc[TM][TN];
  tile_product(A, B, M, N, K, m0, n0, acc, As, Bs);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + split_idx(tr, i);
    if (r >= M) continue;
    float* row = Cm + (long long)r * ldc;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + split_idx(tc, j);
      if (c < N) row[c] = accumulate ? row[c] + acc[i][j] : acc[i][j];
    }
  }
}

}  // namespace

// x [N, D], w [D, V] f32, labels [N] int64 -> loss [N], lse [N] f32; all
// contiguous.  Returns a cudaError_t as int.
extern "C" int ptt_lm_head_fwd(const void* x, const void* w,
                               const void* labels, void* loss, void* lse,
                               int N, int D, int V, void* stream) {
  if (N <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  lm_head_fwd_kernel<<<(N + BM - 1) / BM, NT, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const long long*>(labels), static_cast<float*>(loss),
      static_cast<float*>(lse), N, D, V);
  return (int)cudaGetLastError();
}

// One token chunk of the backward: x, labels, lse and g point at the
// chunk's first row (C rows); dlogits is a [C, V] scratch; dx points at the
// chunk's rows of [N, D]; dw [D, V] is overwritten (accumulate 0, the first
// chunk) or added to.  All f32 and contiguous, labels int64.
extern "C" int ptt_lm_head_bwd_chunk(const void* x, const void* w,
                                     const void* labels, const void* lse,
                                     const void* g, void* dlogits, void* dx,
                                     void* dw, int C, int D, int V,
                                     int accumulate, void* stream) {
  if (C <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* dlf = static_cast<float*>(dlogits);
  lm_head_dlogits_kernel<<<dim3((V + BN - 1) / BN, (C + BM - 1) / BM), NT, 0,
                           s>>>(xf, wf, static_cast<const long long*>(labels),
                                static_cast<const float*>(lse),
                                static_cast<const float*>(g), dlf, C, D, V);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dx [C, D] = dlogits [C, V] . W^T, where W^T[v, d] = w[d * V + v]
  lm_head_gemm_kernel<<<dim3((D + BN - 1) / BN, (C + BM - 1) / BM), NT, 0, s>>>(
      Mat{dlf, V, 1}, Mat{wf, 1, V}, static_cast<float*>(dx), D, C, D, V, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // dW [D, V] (+)= x^T [D, C] . dlogits [C, V], where x^T[d, c] = x[c * D + d]
  lm_head_gemm_kernel<<<dim3((V + BN - 1) / BN, (D + BM - 1) / BM), NT, 0, s>>>(
      Mat{xf, 1, D}, Mat{dlf, V, 1}, static_cast<float*>(dw), V, D, V, C,
      accumulate);
  return (int)cudaGetLastError();
}
