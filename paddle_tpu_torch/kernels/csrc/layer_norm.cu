// Row layer norm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/layer_norm.py:_ln_fwd
// (body _ln_kernel).  y = (x - mean) * rstd * gamma + beta over the last
// axis of x [N, D]; mean and rstd are written in f32, y in x's dtype.
//
// Bound on the H100: memory.  The kernel reads x once and writes y once
// (about 2 * N * D * sizeof(x) bytes); its arithmetic is a few operations
// per element.  Design: one warp per row for D <= 1024 (four rows per CTA
// of 128 threads), one CTA of 256 threads per row above that.  Each thread
// keeps its strided share of the row in registers (at most 32 values), so
// the centred-variance pass and the output pass never re-read device
// memory.  The mean comes first and then the variance of the centred
// values, as _ln_kernel computes them (not E[x^2] - mean^2), all in f32
// with warp shuffles (plus one shared-memory step across the warps of a
// CTA).  Neighbouring lanes touch neighbouring elements, so every load and
// store is coalesced.  Any N, any 1 <= D <= 8192, f32 or bf16 input;
// gamma and beta are f32.
//
// A second entry, ptt_layer_norm_fwd_pairs, writes y of f32 x as 3xTF32
// operand pairs (hi, lo) = (tf32(y), tf32(y - tf32(y))) instead of f32: the
// fused block (fused_block.cu) feeds its norms' outputs straight to
// gemm_tc.cuh's tile loop, which reads pre-split operands.  The same
// statistics and the same y, split as it is stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tf32_mma.cuh"

namespace {

constexpr int kMaxPerThread = 32;   // 32 lanes * 32 = 1024; 256 * 32 = 8192
constexpr int kWarpRowsPerCta = 4;
constexpr int kCtaThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ void store(float2* p, float v) {
  uint32_t hi, lo;
  ptt_mma::split(v, hi, lo);
  *p = make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over the GROUP threads that share a row: a warp, or the whole CTA.
template <int GROUP>
__device__ __forceinline__ float group_sum(float v, float* red) {
  v = warp_sum(v);
  if (GROUP == 32) return v;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  __syncthreads();  // red may still be read by the previous reduction
  if (lane == 0) red[warp] = v;
  __syncthreads();
  return warp_sum(lane < GROUP / 32 ? red[lane] : 0.f);
}

// x in T, y in Y (T, or float2 pairs of f32 x)
template <typename T, typename Y, int GROUP>
__global__ void ln_fwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ gamma,
                              const float* __restrict__ beta,
                              Y* __restrict__ y, float* __restrict__ mean_out,
                              float* __restrict__ rstd_out, int N, int D,
                              float eps) {
  __shared__ float red[32];
  const int lane = threadIdx.x % GROUP;
  const long long row =
      GROUP == 32 ? (long long)blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32
                  : (long long)blockIdx.x;
  if (row >= N) return;  // whole warps only: the warp path has no barrier
  const T* xr = x + row * D;
  Y* yr = y + row * D;

  float v[kMaxPerThread];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = lane + i * GROUP;
    v[i] = c < D ? to_f32(xr[c]) : 0.f;
    s += v[i];
  }
  const float mu = group_sum<GROUP>(s, red) / D;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = lane + i * GROUP;
    const float dlt = c < D ? v[i] - mu : 0.f;
    ss += dlt * dlt;
  }
  const float var = group_sum<GROUP>(ss, red) / D;
  const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kMaxPerThread; ++i) {
    const int c = lane + i * GROUP;
    if (c < D) store(yr + c, (v[i] - mu) * rstd * gamma[c] + beta[c]);
  }
  if (lane == 0) {
    mean_out[row] = mu;
    rstd_out[row] = rstd;
  }
}

template <typename T, typename Y = T>
void launch(const void* x, const void* gamma, const void* beta, void* y,
            void* mean, void* rstd, int N, int D, float eps,
            cudaStream_t stream) {
  if (D <= 32 * kMaxPerThread) {
    const int grid = (N + kWarpRowsPerCta - 1) / kWarpRowsPerCta;
    ln_fwd_kernel<T, Y, 32><<<grid, 32 * kWarpRowsPerCta, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<Y*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), N, D, eps);
  } else {
    ln_fwd_kernel<T, Y, kCtaThreads><<<N, kCtaThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const float*>(gamma),
        static_cast<const float*>(beta), static_cast<Y*>(y),
        static_cast<float*>(mean), static_cast<float*>(rstd), N, D, eps);
  }
}

}  // namespace

// x [N, D] (f32, or bf16 when is_bf16), gamma/beta [D] f32 -> y [N, D] in
// x's dtype, mean/rstd [N] f32.  All contiguous.  Returns cudaGetLastError().
extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int N, int D, float eps,
                                  int is_bf16, void* stream) {
  if (N <= 0 || D <= 0 || D > kCtaThreads * kMaxPerThread)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    launch<__nv_bfloat16>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
  else
    launch<float>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
  return (int)cudaGetLastError();
}

// x [N, D] f32, gamma/beta [D] f32 -> y [N, D] as (hi, lo) pairs (float2),
// mean/rstd [N] f32.  All contiguous.  Returns cudaGetLastError().
extern "C" int ptt_layer_norm_fwd_pairs(const void* x, const void* gamma,
                                        const void* beta, void* y2,
                                        void* mean, void* rstd, int N, int D,
                                        float eps, void* stream) {
  if (N <= 0 || D <= 0 || D > kCtaThreads * kMaxPerThread)
    return (int)cudaErrorInvalidValue;
  launch<float, float2>(x, gamma, beta, y2, mean, rstd, N, D, eps,
                        static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
