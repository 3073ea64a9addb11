// The tiled f32 GEMM loop of fused_block.cu (on the CUDA cores; the LM
// head runs on the tensor cores, gemm_tc.cuh).
//
// A CTA of NT = 256 threads computes a BM x BN = 128 x 128 f32 tile of
// A . B, 8 x 8 a thread, over k-slices of BK = 8 staged in shared memory;
// each thread loads its share of the next k-slice into registers before it
// multiplies the current one, so the loads' latency hides behind the
// arithmetic.  Each operand comes with its own element strides (Mat), so
// the one loop reads a matrix or its transpose; staging puts neighbouring
// threads on whichever index is contiguous in memory.  A thread's 8 rows
// and 8 columns are two groups of 4 at 0 and 64 (split_idx), so its float4
// reads of the staged tiles are free of bank conflicts.  Rows and columns
// outside [M, N] and depths outside K are zero-filled, so any shape works.
// The caller owns the epilogue: acc[i][j] is element
// (m0 + split_idx(tr, i), n0 + split_idx(tc, j)) with tr = tid / 16 and
// tc = tid % 16.  The file that includes this header owns the kernels, so
// the loop is compiled into each of them, in an unnamed namespace.
#pragma once
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 8, TM = 8, TN = 8;
constexpr int NT = (BM / TM) * (BN / TN);  // 256 threads
constexpr int AS = BM + 4;  // padded smem row: conflict-free staging
constexpr int BS = BN + 4;

// Element (r, c) of a matrix operand is p[r * sr + c * sc].
struct Mat {
  const float* p;
  long long sr, sc;
};

__device__ __forceinline__ int split_idx(int g, int i) {
  return (i < 4 ? 0 : 64) + g * 4 + (i & 3);
}

constexpr int RA = BM * BK / NT, RB = BK * BN / NT;  // staged per thread

// This thread's share of the k-slice at k0: ra of A[m0:, k0:k0+BK] and rb
// of B[k0:k0+BK, n0:], zero outside [M, K] and [K, N].
__device__ __forceinline__ void load_slice(const Mat A, const Mat B, int M,
                                           int N, int K, int m0, int n0,
                                           int k0, float (&ra)[RA],
                                           float (&rb)[RB]) {
  const int t = threadIdx.x;
  const bool a_kfast = A.sc == 1, b_nfast = B.sc == 1;
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int idx = t + r * NT;
    const int m = a_kfast ? idx / BK : idx % BM;
    const int k = a_kfast ? idx % BK : idx / BM;
    const int gm = m0 + m, gk = k0 + k;
    ra[r] = (gm < M && gk < K) ? A.p[gm * A.sr + gk * A.sc] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int idx = t + r * NT;
    const int n = b_nfast ? idx % BN : idx / BK;
    const int k = b_nfast ? idx / BN : idx % BK;
    const int gn = n0 + n, gk = k0 + k;
    rb[r] = (gk < K && gn < N) ? B.p[gk * B.sr + gn * B.sc] : 0.f;
  }
}

// acc = A[m0:m0+BM, :K] . B[:K, n0:n0+BN], zero outside [M, N].  The next
// k-slice's global loads are issued before the current slice's products,
// so their latency hides behind the arithmetic.
__device__ __forceinline__ void tile_product(const Mat A, const Mat B, int M,
                                             int N, int K, int m0, int n0,
                                             float (&acc)[TM][TN], float* As,
                                             float* Bs) {
  const int t = threadIdx.x, tr = t / (BN / TN), tc = t % (BN / TN);
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  const bool a_kfast = A.sc == 1, b_nfast = B.sc == 1;
  float ra[RA], rb[RB];
  load_slice(A, B, M, N, K, m0, n0, 0, ra, rb);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // every thread is done with the previous k-slice
#pragma unroll
    for (int r = 0; r < RA; ++r) {
      const int idx = t + r * NT;
      const int m = a_kfast ? idx / BK : idx % BM;
      const int k = a_kfast ? idx % BK : idx / BM;
      As[k * AS + m] = ra[r];
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int idx = t + r * NT;
      const int n = b_nfast ? idx % BN : idx / BK;
      const int k = b_nfast ? idx / BN : idx % BK;
      Bs[k * BS + n] = rb[r];
    }
    __syncthreads();
    if (k0 + BK < K) load_slice(A, B, M, N, K, m0, n0, k0 + BK, ra, rb);
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(As + k * AS + tr * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(As + k * AS + 64 + tr * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * BS + tc * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(Bs + k * BS + 64 + tc * 4);
      const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
}

}  // namespace
