// Times csrc/gemm_tc.cuh's 3xTF32 mma.sync tile loop (ptt_gemm::run_tiles)
// beside variants of it at the LM-head forward's product,
// A [16384, 512] . B [512, 32000], on pre-split (hi, lo) operands, A
// k-contiguous and B n-contiguous, and reports each one's error against
// f64 on sums near 77 (every product positive: the worst case for an
// accumulator that truncates).  The variants, kept here as local copies of
// the loop, differ in the CTA and warp tiles, the k-tile and how the three
// passes are accumulated:
//   direct  one accumulator through every mma of the k loop
//   k8      a zero accumulator per k8 step, added at once by f32 adds
//   2lvl    one accumulator per k-tile, added to a second by f32 adds
//           (gemm_tc.cuh's choice)
// and where the operands are split: before the product into (hi, lo) pairs
// in device memory (the lm_head kernels' pre-pass), or ("smem split") from
// plain f32 tiles, each split once in shared memory after it lands, one
// k-tile ahead of the products that read it.  The row "gemm_tc.cuh
// run_tiles" is the shipped loop itself, included from the package.
// Build and run on a CUDA card, from the repository root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o build/gemm_tc_variants tools/gemm_tc_variants.cu
//   build/gemm_tc_variants [M N K]
// Given M, N and K, it times only the shipped loop, at that product (the
// fused block's q/k/v, Wo, W1 and W2 products, say), with the same
// operand values and the same error check.
// It is a measurement tool, not part of the package (nothing imports or
// builds it).
#include <cuda_runtime.h>

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "../paddle_tpu_torch/kernels/csrc/gemm_tc.cuh"

using namespace ptt_mma;

enum AccMode { kDirect = 0, kPerK8 = 1, kTwoLevel = 2 };

template <int WM_, int WN_, int WGM_, int WGN_, int BK_, int ST_, int ACC_,
          int MINB_>
struct Cfg {
  static constexpr int WM = WM_, WN = WN_, WGM = WGM_, WGN = WGN_, BK = BK_,
                       ST = ST_, ACC = ACC_, MINB = MINB_;
  static constexpr int NT = 32 * WGM * WGN, BM = WM * WGM, BN = WN * WGN;
  static constexpr int MI = WM / 16, NJ = WN / 8, KS = BK / 8;
  static constexpr int ALD = BK + 4, BLD = BN + 4;
  static constexpr int AP = BM * ALD, BP = BK * BLD, SP = AP + BP;
  static constexpr int SMEM = ST * SP * 8;
};

template <class C>
__device__ __forceinline__ void stage(float2* As, float2* Bs, const float2* A,
                                      const float2* B, int M, int N, int K,
                                      int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  {
    constexpr int CH = C::BK / 2, RS = C::NT / CH;
    const int c = 2 * (tid % CH);
    for (int r = tid / CH; r < C::BM; r += RS) {
      const int gr = m0 + r, gc = k0 + c;
      const bool in = gr < M && gc < K;
      cp_async16(As + r * C::ALD + c, in ? A + (long long)gr * K + gc : A, in);
    }
  }
  {
    constexpr int CH = C::BN / 2, RS = C::NT / CH;
    const int c = 2 * (tid % CH);
    for (int r = tid / CH; r < C::BK; r += RS) {
      const int gr = k0 + r, gc = n0 + c;
      const bool in = gr < K && gc < N;
      cp_async16(Bs + r * C::BLD + c, in ? B + (long long)gr * N + gc : B, in);
    }
  }
}

__device__ __forceinline__ void lp(uint32_t& h, uint32_t& l,
                                   const float2* p) {
  const float2 v = *p;
  h = __float_as_uint(v.x);
  l = __float_as_uint(v.y);
}

template <class C>
__device__ __forceinline__ void load_a(FragA& a, const float2* As, int r,
                                       int k) {
  const float2* p = As + r * C::ALD + k;
  lp(a.hi[0], a.lo[0], p);
  lp(a.hi[1], a.lo[1], p + 8 * C::ALD);
  lp(a.hi[2], a.lo[2], p + 4);
  lp(a.hi[3], a.lo[3], p + 8 * C::ALD + 4);
}

template <class C>
__device__ __forceinline__ void load_b(FragB& b, const float2* Bs, int k,
                                       int c) {
  const float2* p = Bs + k * C::BLD + c;
  lp(b.hi[0], b.lo[0], p);
  lp(b.hi[1], b.lo[1], p + 4 * C::BLD);
}

template <class C>
__global__ void __launch_bounds__(C::NT, C::MINB)
    gemm(const float2* A, const float2* B, float* Cm, int M, int N, int K) {
  extern __shared__ float4 sm4[];
  float2* sm = reinterpret_cast<float2*>(sm4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WGN * C::WM, wn = warp % C::WGN * C::WN;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int nk = (K + C::BK - 1) / C::BK;
  float acc[C::MI][C::NJ][4], tot[C::MI][C::NJ][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < C::ST - 1; ++s) {
    if (s < nk)
      stage<C>(sm + s * C::SP, sm + s * C::SP + C::AP, A, B, M, N, K, m0, n0,
               s * C::BK);
    cp_commit();
  }
  for (int f = 0; f < nk; ++f) {
    cp_wait<C::ST - 2>();
    __syncthreads();
    if (f + C::ST - 1 < nk) {
      const int s = (f + C::ST - 1) % C::ST;
      stage<C>(sm + s * C::SP, sm + s * C::SP + C::AP, A, B, M, N, K, m0, n0,
               (f + C::ST - 1) * C::BK);
    }
    cp_commit();
    const float2* As = sm + (f % C::ST) * C::SP;
    const float2* Bs = As + C::AP;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      FragA a[C::MI];
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
        load_a<C>(a[i], As, wm + 16 * i + g, 8 * kk + t);
      if (C::ACC == kPerK8) {
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) {
          FragB b;
          load_b<C>(b, Bs, 8 * kk + t, wn + 8 * j + g);
#pragma unroll
          for (int i = 0; i < C::MI; ++i) {
            float d[4] = {0.f, 0.f, 0.f, 0.f};
            mma3(d, a[i], b);
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
          }
        }
      } else {   // pass by pass into acc
        FragB b[C::NJ];
#pragma unroll
        for (int j = 0; j < C::NJ; ++j)
          load_b<C>(b[j], Bs, 8 * kk + t, wn + 8 * j + g);
#pragma unroll
        for (int i = 0; i < C::MI; ++i)
#pragma unroll
          for (int j = 0; j < C::NJ; ++j) mma(acc[i][j], a[i].lo, b[j].hi);
#pragma unroll
        for (int i = 0; i < C::MI; ++i)
#pragma unroll
          for (int j = 0; j < C::NJ; ++j) mma(acc[i][j], a[i].hi, b[j].lo);
#pragma unroll
        for (int i = 0; i < C::MI; ++i)
#pragma unroll
          for (int j = 0; j < C::NJ; ++j) mma(acc[i][j], a[i].hi, b[j].hi);
      }
    }
    if (C::ACC == kTwoLevel) {
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int j = 0; j < C::NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            tot[i][j][e] += acc[i][j][e];
            acc[i][j][e] = 0.f;
          }
    }
  }
  cp_wait<0>();
  for (int i = 0; i < C::MI; ++i)
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
      for (int j = 0; j < C::NJ; ++j)
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn + 8 * j + 2 * t + e;
          if (c < N)
            Cm[(long long)r * N + c] =
                acc[i][j][2 * h + e] + tot[i][j][2 * h + e];
        }
    }
}

// The smem split: C's tiles and 2lvl accumulation, f32 operands staged by
// 16-byte copies into a ring of C::ST f32 stages, split into one of two
// pair tiles a k-tile ahead.
template <class C>
__global__ void __launch_bounds__(C::NT, C::MINB)
    gemm_smem_split(const float* A, const float* B, float* Cm, int M, int N,
                    int K) {
  constexpr int AF = C::BM * C::ALD, BF = C::BK * C::BLD;   // f32 stage
  extern __shared__ float4 sm4[];
  float2* pairs = reinterpret_cast<float2*>(sm4);          // 2 x C::SP
  float* ring = reinterpret_cast<float*>(pairs + 2 * C::SP);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / C::WGN * C::WM, wn = warp % C::WGN * C::WN;
  const int m0 = blockIdx.y * C::BM, n0 = blockIdx.x * C::BN;
  const int nk = (K + C::BK - 1) / C::BK;
  auto issue = [&](int f) {
    float* As = ring + (f % C::ST) * (AF + BF);
    float* Bs = As + AF;
    const int k0 = f * C::BK;
    {
      constexpr int CH = C::BK / 4, RS = C::NT / CH;
      const int c = 4 * (tid % CH);
      for (int r = tid / CH; r < C::BM; r += RS) {
        const bool in = m0 + r < M && k0 + c < K;
        cp_async16(As + r * C::ALD + c,
                   in ? A + (long long)(m0 + r) * K + k0 + c : A, in);
      }
    }
    {
      constexpr int CH = C::BN / 4, RS = C::NT / CH;
      const int c = 4 * (tid % CH);
      for (int r = tid / CH; r < C::BK; r += RS) {
        const bool in = k0 + r < K && n0 + c < N;
        cp_async16(Bs + r * C::BLD + c,
                   in ? B + (long long)(k0 + r) * N + n0 + c : B, in);
      }
    }
  };
  auto split4 = [&](float2* P, const float* R, int rows, int ld) {
    const int q = (ld - 4) / 4;   // 4-float groups a row
    for (int idx = tid; idx < rows * q; idx += C::NT) {
      const int r = idx / q, c = 4 * (idx % q);
      const float4 v = *reinterpret_cast<const float4*>(R + r * ld + c);
      uint32_t h[4], l[4];
      split(v.x, h[0], l[0]);
      split(v.y, h[1], l[1]);
      split(v.z, h[2], l[2]);
      split(v.w, h[3], l[3]);
      float4* d = reinterpret_cast<float4*>(P + r * ld + c);
      d[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(l[0]),
                         __uint_as_float(h[1]), __uint_as_float(l[1]));
      d[1] = make_float4(__uint_as_float(h[2]), __uint_as_float(l[2]),
                         __uint_as_float(h[3]), __uint_as_float(l[3]));
    }
  };
  auto split_slot = [&](int f) {
    const float* R = ring + (f % C::ST) * (AF + BF);
    float2* P = pairs + (f & 1) * C::SP;
    split4(P, R, C::BM, C::ALD);
    split4(P + C::AP, R + AF, C::BK, C::BLD);
  };
  float acc[C::MI][C::NJ][4], tot[C::MI][C::NJ][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < C::NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = tot[i][j][e] = 0.f;
#pragma unroll
  for (int f = 0; f < C::ST; ++f) {
    if (f < nk) issue(f);
    cp_commit();
  }
  cp_wait<C::ST - 1>();
  __syncthreads();
  split_slot(0);
  for (int f = 0; f < nk; ++f) {
    cp_wait<C::ST - 2>();   // k-tile f + 1 has landed
    __syncthreads();        // pair tile f % 2 is split; slot f % ST is free
    if (f + C::ST < nk) issue(f + C::ST);
    cp_commit();
    if (f + 1 < nk) split_slot(f + 1);
    const float2* As = pairs + (f & 1) * C::SP;
    const float2* Bs = As + C::AP;
#pragma unroll
    for (int kk = 0; kk < C::KS; ++kk) {
      FragA a[C::MI];
      FragB b[C::NJ];
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
        load_a<C>(a[i], As, wm + 16 * i + g, 8 * kk + t);
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
        load_b<C>(b[j], Bs, 8 * kk + t, wn + 8 * j + g);
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) mma(acc[i][j], a[i].lo, b[j].hi);
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) mma(acc[i][j], a[i].hi, b[j].lo);
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int j = 0; j < C::NJ; ++j) mma(acc[i][j], a[i].hi, b[j].hi);
    }
#pragma unroll
    for (int i = 0; i < C::MI; ++i)
#pragma unroll
      for (int j = 0; j < C::NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[i][j][e] += acc[i][j][e];
          acc[i][j][e] = 0.f;
        }
  }
  cp_wait<0>();
  for (int i = 0; i < C::MI; ++i)
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      if (r >= M) continue;
      for (int j = 0; j < C::NJ; ++j)
        for (int e = 0; e < 2; ++e) {
          const int c = n0 + wn + 8 * j + 2 * t + e;
          if (c < N) Cm[(long long)r * N + c] = tot[i][j][2 * h + e];
        }
    }
}

// the shipped loop: ptt_gemm::run_tiles over one output tile a CTA, its
// accumulators stored by the epilogue (the lm_head kernels' fragment map)
__global__ void __launch_bounds__(ptt_gemm::kThreads, 1)
    gemm_tc(const float2* A, const float2* B, float* Cm, int M, int N,
            int K) {
  extern __shared__ float4 sm4[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / ptt_gemm::kWarpsN * ptt_gemm::kWM;
  const int wn = warp % ptt_gemm::kWarpsN * ptt_gemm::kWN;
  const int m0 = blockIdx.y * ptt_gemm::kBM;
  ptt_gemm::run_tiles<true, true>(
      ptt_gemm::Operand{A, K, 1}, ptt_gemm::Operand{B, N, 1}, M, N, 0, K, m0,
      blockIdx.x * ptt_gemm::kBN, 1, reinterpret_cast<float2*>(sm4),
      [&](const ptt_gemm::Acc& acc, int n) {
        for (int i = 0; i < ptt_gemm::kMI; ++i)
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + wm + 16 * i + g + 8 * h;
            if (r >= M) continue;
            for (int j = 0; j < ptt_gemm::kNJ; ++j)
              for (int e = 0; e < 2; ++e) {
                const int c = n + wn + 8 * j + 2 * t + e;
                if (c < N)
                  Cm[(long long)r * N + c] = acc.v[i][j][2 * h + e];
              }
          }
      });
}

__global__ void split_kernel(const float* s, float2* d, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    uint32_t h, l;
    split(s[i], h, l);
    d[i] = make_float2(__uint_as_float(h), __uint_as_float(l));
  }
}

static int M = 16384, N = 32000, K = 512;
static std::vector<float> ha, hb;

// times kernel k (on operands A and B, pairs or f32) with smem bytes of
// dynamic shared memory
template <class C, class T>
int run(const char* name, void (*k)(const T*, const T*, float*, int, int,
                                    int),
        int smem, const T* A, const T* B, float* Cm) {
  cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int occ = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, k, C::NT, smem);
  cudaFuncAttributes at;
  cudaFuncGetAttributes(&at, k);
  const dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  k<<<grid, C::NT, smem>>>(A, B, Cm, M, N, K);   // warm-up
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const int iters = 10;
  cudaEventRecord(a);
  for (int i = 0; i < iters; ++i) k<<<grid, C::NT, smem>>>(A, B, Cm, M, N, K);
  cudaEventRecord(b);
  cudaError_t err = cudaEventSynchronize(b);
  if (err != cudaSuccess) {
    printf("%s: %s\n", name, cudaGetErrorString(err));
    return 1;
  }
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  ms /= iters;
  std::vector<float> h((size_t)M * N);
  cudaMemcpy(h.data(), Cm, h.size() * 4, cudaMemcpyDeviceToHost);
  double e64 = 0;
  for (int q = 0; q < 4000; ++q) {
    const long long r = q * 7919LL % M, c = q * 104729LL % N;
    double sum = 0;
    for (int kk = 0; kk < K; ++kk)
      sum += (double)ha[r * K + kk] * (double)hb[(long long)kk * N + c];
    e64 = fmax(e64, fabs(h[r * N + c] - sum));
  }
  const double flop = 2.0 * M * N * K;
  printf("[variant] %-40s %3d registers, %4d bytes spilled, %6d bytes "
         "shared, %d CTAs/SM: %.3f ms, %.1f TFLOP/s of TF32 work (%.1f of "
         "f32 work), max abs err vs f64 %.3g\n",
         name, at.numRegs, (int)at.localSizeBytes, smem, occ, ms,
         3 * flop / ms / 1e9, flop / ms / 1e9, e64);
  return 0;
}

int main(int argc, char** argv) {
  const bool one_shape = argc == 4;
  if (one_shape) {
    M = atoi(argv[1]);
    N = atoi(argv[2]);
    K = atoi(argv[3]);
  } else if (argc != 1) {
    printf("usage: %s [M N K]\n", argv[0]);
    return 2;
  }
  printf("[shape] M %d N %d K %d\n", M, N, K);
  ha.resize((size_t)M * K);
  hb.resize((size_t)K * N);
  srand(1);
  for (auto& v : ha) v = rand() / (float)RAND_MAX * 6.0f;
  for (auto& v : hb) v = rand() / (float)RAND_MAX * 0.1f;
  float *a, *b, *c;
  float2 *a2, *b2;
  cudaMalloc(&a, ha.size() * 4);
  cudaMalloc(&b, hb.size() * 4);
  cudaMalloc(&a2, ha.size() * 8);
  cudaMalloc(&b2, hb.size() * 8);
  cudaMalloc(&c, (size_t)M * N * 4);
  cudaMemcpy(a, ha.data(), ha.size() * 4, cudaMemcpyHostToDevice);
  cudaMemcpy(b, hb.data(), hb.size() * 4, cudaMemcpyHostToDevice);
  split_kernel<<<1024, 256>>>(a, a2, ha.size());
  split_kernel<<<1024, 256>>>(b, b2, hb.size());
  if (cudaDeviceSynchronize() != cudaSuccess) return 1;
  int bad = 0;
  using V1 = Cfg<64, 64, 2, 4, 16, 4, kDirect, 1>;
  using V2 = Cfg<64, 64, 2, 2, 16, 3, kDirect, 2>;
  using V3 = Cfg<64, 64, 2, 4, 16, 4, kPerK8, 1>;
  using V4 = Cfg<64, 32, 2, 4, 16, 4, kTwoLevel, 1>;
  // gemm_tc.cuh's tiles (for the grid), its loop run by gemm_tc
  using V5 = Cfg<ptt_gemm::kWM, ptt_gemm::kWN, ptt_gemm::kBM / ptt_gemm::kWM,
                 ptt_gemm::kWarpsN, ptt_gemm::kBK, 3, kTwoLevel, 1>;
  static_assert(V5::NT == ptt_gemm::kThreads && V5::BN == ptt_gemm::kBN,
                "the grid of gemm_tc");
  using V6 = Cfg<64, 32, 2, 4, 32, 2, kTwoLevel, 1>;   // its f32 ring
  if (one_shape)
    return run<V5>("gemm_tc.cuh run_tiles (w64x32 bk32 2lvl)", gemm_tc,
                   ptt_gemm::Layout<true, true>::kSmemBytes, a2, b2, c);
  bad |= run<V1>("128x256 w64x64 bk16 direct", gemm<V1>, V1::SMEM, a2, b2, c);
  bad |= run<V2>("128x128 w64x64 bk16 direct", gemm<V2>, V2::SMEM, a2, b2, c);
  bad |= run<V3>("128x256 w64x64 bk16 k8", gemm<V3>, V3::SMEM, a2, b2, c);
  bad |= run<V4>("128x128 w64x32 bk16 2lvl", gemm<V4>, V4::SMEM, a2, b2, c);
  bad |= run<V5>("gemm_tc.cuh run_tiles (w64x32 bk32 2lvl)", gemm_tc,
                 ptt_gemm::Layout<true, true>::kSmemBytes, a2, b2, c);
  // two pair tiles and two f32 stages: 227 KB hold no third
  const int smem6 = 2 * V6::SP * 8 + V6::ST * V6::SP * 4;
  bad |= run<V6>("128x128 w64x32 bk32 2lvl smem split", gemm_smem_split<V6>,
                 smem6, a, b, c);
  return bad;
}
