// Row layer norm forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paddle_tpu/kernels/layer_norm.py:_ln_fwd
// (body _ln_kernel).  y = (x - mean) * rstd * gamma + beta over the last
// axis of x [N, D]; mean and rstd are written in f32, y in x's dtype.
// Every path keeps _ln_kernel's arithmetic: the f32 mean first, then the
// variance of the centred values (not E[x^2] - mean^2), rstd = 1 /
// sqrt(var + eps), y in f32, rounded once to y's type.  gamma and beta are
// f32.
//
// Bound on the H100: memory.  A call reads x once and writes y once
// (2 * N * D * sizeof(x) bytes, plus the f32 stats); its arithmetic is a
// few operations an element.  At the training shape (N 16384, D 512) that
// is 67.2 MB in f32 and 33.7 MB in bf16: 0.0201 and 0.0101 ms at 3.35
// TB/s.
//
// Two paths, chosen on the host before the launch.
//
// ln_fwd_kernel, the scalar path: f32 rows, the f32 block's pair output
// and the bf16 rows that v16 cannot take.  One warp per row for
// D <= 1024 (four rows per CTA of 128 threads), one CTA of 256 threads per
// row above that.  Each thread keeps its strided share of the row in
// registers (at most 32 values), so the centred-variance pass and the
// output pass never re-read device memory; the sums are warp shuffles
// (plus one shared-memory step across the warps of a CTA).  Neighbouring
// lanes touch neighbouring elements, so every access is coalesced, but
// one element at a time: a bf16 row costs as many memory instructions as
// an f32 row, and gamma and beta are re-read for every row.  Any N, any
// 1 <= D <= 8192.
//
// The v16 path: bf16 rows with D % 8 == 0, 8 <= D <= 8192, and x and y
// 16-byte aligned (kernels/layer_norm.py bf16_path; ptt_layer_norm_bf16_path
// here, which the bf16 block's C entry applies to its two norms).  Every
// access moves 16 bytes (8 bf16), neighbouring lanes on neighbouring
// 16-byte words; a lane takes W words of a row (a template parameter, 1-4),
// the words past the row's D / 8 masked (D 264, 520); gamma and beta of the
// lane's columns are loaded once and kept in registers for all its rows;
// the grid is persistent, min(CTAs the rows need, SMs x resident CTAs),
// from the SM count and cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// asked once per device and kernel and cached; lane 0 of a row's group
// writes mean and rstd; no cache hints.  Two forms:
//   - ln_fwd_v16_tma_kernel, D <= 1024 (the training rows, D 512: 64 words,
//     two a lane).  A producer warp streams blocks of 4 contiguous rows
//     into a 4-stage ring of shared memory by 1-D TMA bulk copies
//     (cp.async.bulk ... mbarrier::complete_tx), a CTA's blocks strided by
//     the grid; each of 4 consumer warps normalizes one row of a block from
//     shared memory and writes y over it; the producer stores the block to
//     y by one bulk copy (after the consumers' fence.proxy.async) and
//     refills the slot once that copy has read it (wait_group.read).  So a
//     CTA has up to 4 blocks of loads in flight while its warps reduce, and
//     no thread spends registers or instructions on the copies.
//   - ln_fwd_v16_row_kernel, D > 1024: a CTA of 256 threads a row, the
//     row's words straight into registers (16-byte loads), the CTA's next
//     row loaded before the current one is reduced.
// ptt_layer_norm_bf16_plan exports the plan (kernels/layer_norm.py
// bf16_plan mirrors it).  Measured on the H100 (PERF.md §6,
// tools/layer_norm_ab.py): the TMA form beat a warp a row with the words
// in registers and two rows in flight at the training shape, alone and
// inside the bf16 block, with or without an evict-first hint on x; that
// form left the source.
//
// A third entry, ptt_layer_norm_fwd_pairs, writes y of f32 x as 3xTF32
// operand pairs (hi, lo) = (tf32(y), tf32(y - tf32(y))) instead of f32: the
// fused block (fused_block.cu) feeds its norms' outputs straight to
// gemm_tc.cuh's tile loop, which reads pre-split operands.  The same
// statistics and the same y, split as it is stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"
#include "wgmma_bf16.cuh"

namespace {

constexpr int kMaxPerThread = 32;   // 32 lanes * 32 = 1024; 256 * 32 = 8192
constexpr int kWarpRowsPerCta = 4;
constexpr int kCtaThreads = 256;
constexpr int kMaxD = kCtaThreads * kMaxPerThread;

// the v16 path
constexpr int kV16MaxWords = 4;                      // 16-byte words a lane
constexpr int kV16WarpMaxD = 32 * kV16MaxWords * 8;  // 1024: the TMA form
constexpr int kV16RowThreads = 256;                  // the CTA form
constexpr int kTmaConsumers = 4;   // warps a CTA that normalize (+ producer)
constexpr int kTmaThreads = 32 * (kTmaConsumers + 1);
constexpr int kTmaStages = 4;
constexpr int kTmaBarBytes = 128;  // full[], done[]; the ring after them
constexpr int kMaxDevices = 64;
constexpr int kPathScalar = 0, kPathV16 = 1;

// dynamic shared memory of the TMA form at W words a lane: the barriers and
// kTmaStages blocks of kTmaConsumers rows of up to 32 W words
constexpr int tma_smem_bytes(int W) {
  return kTmaBarBytes + kTmaStages * kTmaConsumers * 32 * W * 16;
}

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) {
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

// ---- the v16 path ---------------------------------------------------------

// 8 bf16 of a 16-byte word as f32, in address order, and back (one rounding)
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  return u;
}

// gamma and beta of the W words a lane takes (lane, lane + lanes, ...), held
// in registers for all the rows of a group; words past the row's end are
// zeros and not `mine`
template <int W>
struct Affine {
  bool mine[W];
  float g[W][8], b[W][8];

  __device__ __forceinline__ Affine(const float* __restrict__ gamma,
                                    const float* __restrict__ beta, int lane,
                                    int lanes, int words) {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const int w = lane + i * lanes;
      mine[i] = w < words;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        g[i][k] = mine[i] ? __ldg(gamma + 8 * w + k) : 0.f;
        b[i][k] = mine[i] ? __ldg(beta + 8 * w + k) : 0.f;
      }
    }
  }
};

// One row of a group of `lanes` threads: x's words of this lane in (zeros
// where not mine), y's out through put(i, word); returns (mean, rstd).
// _ln_kernel's arithmetic: the f32 mean, the variance of the centred
// values, y = (x - mean) * rstd * gamma + beta rounded once.
template <int GROUP, int W, typename Put>
__device__ __forceinline__ float2 norm_row(const uint4 (&in)[W],
                                           const Affine<W>& a, float* red,
                                           int D, float eps, Put put) {
  float v[W][8];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    unpack8(in[i], v[i]);
#pragma unroll
    for (int k = 0; k < 8; ++k) s += v[i][k];
  }
  const float mu = group_sum<GROUP>(s, red) / D;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float dlt = a.mine[i] ? v[i][k] - mu : 0.f;
      ss += dlt * dlt;
    }
  const float var = group_sum<GROUP>(ss, red) / D;
  const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < W; ++i) {
    if (!a.mine[i]) continue;
    float o[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      o[k] = (v[i][k] - mu) * rstd * a.g[i][k] + a.b[i][k];
    put(i, pack8(o));
  }
  return make_float2(mu, rstd);
}

// The warp form (D <= 1024): rows in blocks of kTmaConsumers through TMA
// bulk copies.  Warp kTmaConsumers (lane 0) is the producer: it loads the
// CTA's blocks b = blockIdx.x, + gridDim.x, ... into a kTmaStages ring by
// 1-D cp.async.bulk copies that complete on full[s]; consumer warp w takes
// row w of each block from shared memory (16-byte reads, neighbouring lanes
// on neighbouring words: conflict-free), writes y over it, fences its
// writes for the async proxy and arrives on done[s]; the producer then
// stores the block to y by one bulk copy and, once that copy has read the
// slot (wait_group.read), refills it with the block kTmaStages ahead.
template <int W>
__global__ void __launch_bounds__(kTmaThreads)
    ln_fwd_v16_tma_kernel(const uint4* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          uint4* __restrict__ y, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int N, int D,
                          float eps) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);   // full[S], done[S]
  uint4* ring = reinterpret_cast<uint4*>(smem + kTmaBarBytes);
  const int words = D / 8, stage = kTmaConsumers * words;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int blocks = (N + kTmaConsumers - 1) / kTmaConsumers;
  const int mine = (int)blockIdx.x < blocks
                       ? (blocks - (int)blockIdx.x + (int)gridDim.x - 1) /
                             (int)gridDim.x
                       : 0;
  const uint32_t full0 = ptt_wg::smem_addr(bars);
  const uint32_t done0 = ptt_wg::smem_addr(bars + kTmaStages);
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      ptt_wg::mbar_init(full0 + 8 * s, 1);
      ptt_wg::mbar_init(done0 + 8 * s, kTmaConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // the first row of the CTA's j-th block, and that block's bytes
  auto first = [&](int j) {
    return ((long long)blockIdx.x + (long long)j * gridDim.x) *
           kTmaConsumers;
  };
  auto bytes = [&](long long r0) {
    return (int)(N - r0 < kTmaConsumers ? N - r0 : kTmaConsumers) * words *
           16;
  };
  if (warp == kTmaConsumers) {
    if (lane != 0) return;
    auto load = [&](int j) {
      const uint32_t full = full0 + 8 * (j % kTmaStages);
      const long long r0 = first(j);
      ptt_wg::mbar_expect_tx(full, bytes(r0));
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(
              ptt_wg::smem_addr(ring + (j % kTmaStages) * stage)),
          "l"(x + r0 * words), "r"(bytes(r0)), "r"(full)
          : "memory");
    };
    for (int j = 0; j < mine && j < kTmaStages; ++j) load(j);
    for (int j = 0; j < mine; ++j) {
      const int s = j % kTmaStages;
      ptt_wg::mbar_wait(done0 + 8 * s, (j / kTmaStages) & 1);
      const long long r0 = first(j);
      asm volatile(
          "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
          "cp.async.bulk.commit_group;\n" ::"l"(y + r0 * words),
          "r"(ptt_wg::smem_addr(ring + s * stage)), "r"(bytes(r0))
          : "memory");
      if (j + kTmaStages < mine) {
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
        load(j + kTmaStages);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }
  const Affine<W> a(gamma, beta, lane, 32, words);
  for (int j = 0; j < mine; ++j) {
    const int s = j % kTmaStages;
    const long long row = first(j) + warp;
    ptt_wg::mbar_wait(full0 + 8 * s, (j / kTmaStages) & 1);
    if (row < N) {
      uint4* r = ring + s * stage + warp * words;
      uint4 in[W];
#pragma unroll
      for (int i = 0; i < W; ++i)
        in[i] = a.mine[i] ? r[lane + 32 * i] : make_uint4(0, 0, 0, 0);
      const float2 st = norm_row<32>(in, a, nullptr, D, eps,
                                     [&](int i, const uint4& o) {
                                       r[lane + 32 * i] = o;
                                     });
      if (lane == 0) {
        mean_out[row] = st.x;
        rstd_out[row] = st.y;
      }
      ptt_wg::fence_proxy_async();   // y in shared memory, for the store
    }
    __syncwarp();
    if (lane == 0) ptt_wg::mbar_arrive(done0 + 8 * s);
  }
}

// The CTA form (D > 1024): a CTA of kV16RowThreads takes rows blockIdx.x,
// + gridDim.x, ..., each thread W 16-byte words of a row straight from
// device memory into registers; the loads of the CTA's next row go out
// before the current row's reductions.
template <int W>
__global__ void __launch_bounds__(kV16RowThreads)
    ln_fwd_v16_row_kernel(const uint4* __restrict__ x,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta,
                          uint4* __restrict__ y, float* __restrict__ mean_out,
                          float* __restrict__ rstd_out, int N, int D,
                          float eps) {
  __shared__ float red[32];
  const int words = D / 8, lane = threadIdx.x;
  const Affine<W> a(gamma, beta, lane, kV16RowThreads, words);
  auto load = [&](long long row, uint4 (&in)[W]) {
#pragma unroll
    for (int i = 0; i < W; ++i)
      in[i] = a.mine[i] && row < N
                  ? x[row * words + lane + i * kV16RowThreads]
                  : make_uint4(0, 0, 0, 0);
  };
  uint4 cur[W];
  load(blockIdx.x, cur);
  for (long long row = blockIdx.x; row < N; row += gridDim.x) {
    uint4 nxt[W];
    load(row + gridDim.x, nxt);
    const float2 st = norm_row<kV16RowThreads>(
        cur, a, red, D, eps, [&](int i, const uint4& o) {
          y[row * words + lane + i * kV16RowThreads] = o;
        });
    if (lane == 0) {
      mean_out[row] = st.x;
      rstd_out[row] = st.y;
    }
#pragma unroll
    for (int i = 0; i < W; ++i) cur[i] = nxt[i];
  }
}

// resident CTAs an SM of the form's kernel with W words a lane, asked once
// per device
template <bool TMA, int W>
int v16_resident_w(int dev) {
  static int cache[kMaxDevices];   // 0: not asked yet
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int n = 0;
  const cudaError_t err =
      TMA ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, ln_fwd_v16_tma_kernel<W>, kTmaThreads,
                tma_smem_bytes(W))
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &n, ln_fwd_v16_row_kernel<W>, kV16RowThreads, 0);
  if (err != cudaSuccess) return 0;
  if (dev < kMaxDevices) cache[dev] = n;
  return n;
}

template <bool TMA>
int v16_resident(int words_per_lane, int dev) {
  switch (words_per_lane) {
    case 1: return v16_resident_w<TMA, 1>(dev);
    case 2: return v16_resident_w<TMA, 2>(dev);
    case 3: return v16_resident_w<TMA, 3>(dev);
    case 4: return v16_resident_w<TMA, 4>(dev);
  }
  return 0;
}

int sm_count(int dev) {
  static int cache[kMaxDevices];
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < kMaxDevices) cache[dev] = n;
  return n;
}

struct V16Plan {
  bool ok;
  int lanes;           // lanes a row: 32 (the TMA form) or kV16RowThreads
  int words_per_lane;  // W
  int warps_per_cta;
  int rows_per_cta;    // rows a CTA takes at a time: a block, or one row
  int ctas;
  int sms;
  int ctas_per_sm;     // resident CTAs an SM
};

bool v16_takes(const void* x, const void* y, int D) {
  return D % 8 == 0 && D >= 8 && D <= kMaxD &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(y) % 16 == 0;
}

V16Plan v16_plan(int N, int D) {
  V16Plan p = {};
  int dev = 0;
  if (N <= 0 || D % 8 || D < 8 || D > kMaxD ||
      cudaGetDevice(&dev) != cudaSuccess)
    return p;
  const bool tma = D <= kV16WarpMaxD;
  p.lanes = tma ? 32 : kV16RowThreads;
  p.words_per_lane = (D / 8 + p.lanes - 1) / p.lanes;
  p.warps_per_cta = tma ? kTmaConsumers + 1 : kV16RowThreads / 32;
  p.rows_per_cta = tma ? kTmaConsumers : 1;
  p.sms = sm_count(dev);
  p.ctas_per_sm = tma ? v16_resident<true>(p.words_per_lane, dev)
                      : v16_resident<false>(p.words_per_lane, dev);
  if (p.sms <= 0 || p.ctas_per_sm <= 0) return p;
  const long long need = ((long long)N + p.rows_per_cta - 1) / p.rows_per_cta;
  const long long most = (long long)p.sms * p.ctas_per_sm;
  p.ctas = (int)(need < most ? need : most);
  p.ok = true;
  return p;
}

template <int W>
void launch_v16_w(const V16Plan& p, const void* x, const void* gamma,
                  const void* beta, void* y, void* mean, void* rstd, int N,
                  int D, float eps, cudaStream_t s) {
  const uint4* xv = static_cast<const uint4*>(x);
  uint4* yv = static_cast<uint4*>(y);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  float* m = static_cast<float*>(mean);
  float* r = static_cast<float*>(rstd);
  if (p.lanes == 32)
    ln_fwd_v16_tma_kernel<W><<<p.ctas, kTmaThreads, tma_smem_bytes(W), s>>>(
        xv, g, b, yv, m, r, N, D, eps);
  else
    ln_fwd_v16_row_kernel<W><<<p.ctas, kV16RowThreads, 0, s>>>(
        xv, g, b, yv, m, r, N, D, eps);
}

void launch_v16(const V16Plan& p, const void* x, const void* gamma,
                const void* beta, void* y, void* mean, void* rstd, int N,
                int D, float eps, cudaStream_t s) {
  switch (p.words_per_lane) {
    case 1: return launch_v16_w<1>(p, x, gamma, beta, y, mean, rstd, N, D,
                                   eps, s);
    case 2: return launch_v16_w<2>(p, x, gamma, beta, y, mean, rstd, N, D,
                                   eps, s);
    case 3: return launch_v16_w<3>(p, x, gamma, beta, y, mean, rstd, N, D,
                                   eps, s);
    case 4: return launch_v16_w<4>(p, x, gamma, beta, y, mean, rstd, N, D,
                                   eps, s);
  }
}

}  // namespace

// x [N, D] f32, gamma/beta [D] f32 -> y [N, D] f32, mean/rstd [N] f32.  All
// contiguous.  Returns cudaGetLastError().
extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int N, int D, float eps,
                                  void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  launch<float>(x, gamma, beta, y, mean, rstd, N, D, eps,
                static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// The path of bf16 rows x -> y of width D: 1 (v16) where D % 8 == 0,
// 8 <= D <= 8192 and x and y are 16-byte aligned, else 0 (scalar).
// kernels/layer_norm.py bf16_path is the same rule.
extern "C" int ptt_layer_norm_bf16_path(const void* x, const void* y, int D) {
  return v16_takes(x, y, D) ? kPathV16 : kPathScalar;
}

// x [N, D] bf16, gamma/beta [D] f32 -> y [N, D] bf16, mean/rstd [N] f32.
// All contiguous.  path 1 (v16) or 0 (scalar), as the caller chose; v16 on
// operands it cannot take (ptt_layer_norm_bf16_path 0) returns
// cudaErrorInvalidValue before any launch.  Returns cudaGetLastError().
extern "C" int ptt_layer_norm_fwd_bf16(const void* x, const void* gamma,
                                       const void* beta, void* y, void* mean,
                                       void* rstd, int N, int D, float eps,
                                       int path, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == kPathV16) {
    if (!v16_takes(x, y, D)) return (int)cudaErrorInvalidValue;
    const V16Plan p = v16_plan(N, D);
    if (!p.ok) return (int)cudaErrorInvalidValue;
    launch_v16(p, x, gamma, beta, y, mean, rstd, N, D, eps, s);
  } else if (path == kPathScalar) {
    launch<bf16>(x, gamma, beta, y, mean, rstd, N, D, eps, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The v16 path's plan for N rows of width D on the current card: out[0..6]
// = lanes a row, words a lane, warps a CTA, rows a CTA takes at a time,
// CTAs, SMs, resident CTAs an SM (kernels/layer_norm.py bf16_plan mirrors
// it).  cudaErrorInvalidValue where v16 takes no such rows.
extern "C" int ptt_layer_norm_bf16_plan(int N, int D, int* out) {
  const V16Plan p = v16_plan(N, D);
  if (!p.ok) return (int)cudaErrorInvalidValue;
  const int v[7] = {p.lanes, p.words_per_lane, p.warps_per_cta,
                    p.rows_per_cta, p.ctas, p.sms, p.ctas_per_sm};
  for (int i = 0; i < 7; ++i) out[i] = v[i];
  return 0;
}

// x [N, D] f32, gamma/beta [D] f32 -> y [N, D] as (hi, lo) pairs (float2),
// mean/rstd [N] f32.  All contiguous.  Returns cudaGetLastError().
extern "C" int ptt_layer_norm_fwd_pairs(const void* x, const void* gamma,
                                        const void* beta, void* y2,
                                        void* mean, void* rstd, int N, int D,
                                        float eps, void* stream) {
  if (N <= 0 || D <= 0 || D > kMaxD) return (int)cudaErrorInvalidValue;
  launch<float, float2>(x, gamma, beta, y2, mean, rstd, N, D, eps,
                        static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}
