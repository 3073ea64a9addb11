// Streamed LM head with softmax cross-entropy, forward and backward, in
// bf16 for Hopper (sm_90a), on the tensor cores: the kernels of the
// training path under FLAGS_amp_bf16.
//
// Replaces the Pallas TPU kernels paddle_tpu/kernels/lm_head.py:_fwd (body
// _fwd_kernel) and _bwd (body _bwd_kernel) as they run on the bf16 x and W
// that fused_lm_head_loss hands them under AMP.  x [N, D], W [D, V] bf16,
// labels [N] int64 (negative = ignored), all contiguous:
//   forward:  loss_n = lse_n - (x_n W)[y_n] (0 where y_n < 0),
//             lse_n = logsumexp_v (x_n W)_v; logits, loss and lse f32
//   backward: dlogits = bf16((softmax(x W) - onehot(y)) * g)   (g = 0 where
//             y < 0), dx = bf16(dlogits W^T) per chunk,
//             dW = bf16(sum over the chunks of x^T dlogits, in f32)
// These are the Pallas kernel's roundings (lm_head.py:128, :243, :244).
// The products are computed here, on gemm_bf16.cuh's and wgmma_bf16.cuh's
// tile loops, not by a library.
//
// Bound on the H100 at N 16384, D 512, V 32000: operations.  The forward
// is one product, 2 N D V FLOP = 537 GFLOP, 0.543 ms at 989 TFLOP/s; the
// backward three (recompute, dx, dW), 1.61 TFLOP, 1.628 ms.  The bytes (x,
// W, dx, dW once) are two orders of magnitude below that.
//
// Design.  The main paths of both directions run on wgmma_bf16.cuh's
// pieces (TMA into an mbarrier ring, wgmma, a producer warp and two
// consumer warpgroups, a persistent grid); their sync paths, for operands
// TMA cannot describe, on the bf16 tile loop of gemm_bf16.cuh (128 x 128
// CTA tiles, 8 warps of mma.sync, a 4-stage cp.async ring, ldmatrix
// fragments).  Operands go from device memory to shared memory as they
// are.  Both directions choose the path the same way (below).
//   lm_head_fwd, wgmma path (ptt_lm_head_fwd_bf16_wgmma): a balanced
//     persistent split of the flat (token tile, vocab tile) grid, x held
//     in shared memory across a CTA's vocab tiles where D <= 640, the
//     running (max, sum of exp, gold logit) in the epilogue, overlapped
//     with the other warpgroup's products; a second launch merges each token
//     tile's segments in vocabulary order ("the forward on wgmma_bf16.cuh's
//     pieces" below).  2 launches.
//   lm_head_fwd, sync path (ptt_lm_head_fwd_bf16): as lm_head.cu's: a CTA
//     takes 128 tokens and one of S contiguous shares of the vocabulary
//     tiles, folds each vocab tile's logits into a running (max, sum of
//     exp, gold logit) per row in registers, merges its lanes and warps in
//     a fixed order, and a second launch merges the shares of each token
//     in share order.  No logit leaves the chip on either path.
//   lm_head_bwd, per token chunk of C rows (the op's chunk_size):
//     (1) recomputes the logits tile and writes dlogits [C, V], rounded to
//     bf16, to the workspace; (2) dx = dlogits W^T with the vocabulary (K)
//     cut into S ranges where the output tiles alone would not fill the
//     SMs, each range's partial written apart in f32 and summed in range
//     order by a small launch that rounds dx to bf16 (S = 1: the product's
//     epilogue writes bf16 dx); (3) dW (+)= x^T dlogits into an f32 sum in
//     the workspace, in chunk order; the last chunk writes dW, rounded to
//     bf16, instead.  Every output element is summed by one thread in a
//     fixed order: no atomics, the same bits on every run.
//   Two paths run the backward's products, chosen by the caller from the
//   operands before the launch (kernels/lm_head.py bwd_bf16_path; the
//   forward's fwd_bf16_path is the same condition):
//     wgmma (ptt_lm_head_bwd_chunk_bf16_wgmma) where TMA can describe x and
//     W: 16-byte-aligned bases, D and V multiples of 8 (16-byte rows).
//     Every operand is read in its own layout: recompute A = x (K-major),
//     B = W (N-major); dx A = dlogits (K-major), B = W^T, which is W read
//     K-major; dW A = x^T (M-major), B = dlogits (N-major).  Each product
//     is one persistent launch whose epilogue stages its tile in shared
//     memory and writes it with 16-byte stores: dlogits as bf16, dx as
//     bf16 (S = 1) or f32 partials, dW adding the f32 sum or writing bf16.
//     3 launches a chunk at the training shape (S = 1).
//     sync (ptt_lm_head_bwd_chunk_bf16) otherwise, e.g. an odd D or V:
//     gemm_bf16.cuh's loop, whose staging takes element copies there;
//     4 launches a chunk.
// Memory: the backward's workspace holds dlogits (2 C V bytes: 250 MiB at
// C 4096, V 32000, a quarter of the f32 kernel's (hi, lo) pairs), the dx
// partials (4 S C D bytes, none where S = 1) and the f32 dW sum (4 D V
// bytes); the forward's holds the shares' (sync) or the segments'
// (wgmma) partial states.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"
#include "tma_maps.cuh"
#include "wgmma_bf16.cuh"

namespace {

using ptt_bf16::bf16;
using ptt_bf16::ex2;   // flushes below 2^-126: moves a dlogit by less
                      // than 2^-126 |g| where the row's largest is ~|g|
using ptt_gemm::Acc;
using ptt_gemm::align256;
using ptt_gemm::cdiv;
using ptt_gemm::kBM;
using ptt_gemm::kBN;
using ptt_gemm::kMI;
using ptt_gemm::kNJ;
using ptt_gemm::kThreads;
using ptt_gemm::kWarpsN;
using ptt_gemm::kWM;
using ptt_gemm::kWN;
using ptt_gemm::pass_blocks;
using ptt_gemm::sm_count;
using ptt_gemm_bf16::kBK;
using ptt_gemm_bf16::Layout;
using ptt_gemm_bf16::Operand;
using ptt_gemm_bf16::allow_smem;
using ptt_gemm_bf16::operand;
using ptt_gemm_bf16::run_tiles;
using ptt_tma::kmajor_map;
using ptt_tma::mnmajor_map;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWaves = 4;   // CTAs aimed at per SM (one fits), forward and dx

// the running softmax state of one row: max, sum of exp(. - max), gold
struct RowState {
  float m, l, gold;
};

__device__ __forceinline__ RowState merge(RowState a, RowState b) {
  const float m = fmaxf(a.m, b.m);
  return RowState{m,
                  a.l * exp2f((a.m - m) * kLog2e) +
                      b.l * exp2f((b.m - m) * kLog2e),
                  a.gold + b.gold};
}

__device__ __forceinline__ RowState shfl_merge(RowState s, int o) {
  RowState r;
  r.m = __shfl_xor_sync(0xffffffffu, s.m, o);
  r.l = __shfl_xor_sync(0xffffffffu, s.l, o);
  r.gold = __shfl_xor_sync(0xffffffffu, s.gold, o);
  return merge(s, r);
}

// Forward: CTA (token tile, share) -> part[share] [3][N] (max, sum, gold)
// of its rows over its vocab tiles.
__global__ void __launch_bounds__(kThreads, 1)
    lm_head_fwd_bf16_kernel(const Operand X, const Operand W,
                            const long long* __restrict__ labels,
                            float* __restrict__ part, int N, int D, int V,
                            int tiles_per_share) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
  const int m0 = blockIdx.x * kBM;
  const int nt = (V + kBN - 1) / kBN;
  const int first = blockIdx.y * tiles_per_share;
  const int count = min(tiles_per_share, nt - first);

  int y[kMI][2];
  RowState st[kMI][2];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm + 16 * i + g + 8 * h;
      y[i][h] = r < N ? (int)labels[r] : -1;
      st[i][h] = RowState{kNegInf, 0.f, 0.f};
    }

  run_tiles<true, true>(
      X, W, N, V, 0, D, m0, first * kBN, count, smem,
      [&](const Acc& acc, int n) {
        const bool ragged = n + kBN > V;
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float mx = kNegInf, gold = 0.f;
#pragma unroll
            for (int j = 0; j < kNJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n + wn + 8 * j + 2 * t + e;
                const float v = acc.v[i][j][2 * h + e];
                if (!ragged || c < V) mx = fmaxf(mx, v);
                if (c == y[i][h]) gold += v;
              }
            RowState& s = st[i][h];
            const float m = fmaxf(s.m, mx);
            float sum = 0.f;
#pragma unroll
            for (int j = 0; j < kNJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n + wn + 8 * j + 2 * t + e;
                if (!ragged || c < V)
                  sum += exp2f((acc.v[i][j][2 * h + e] - m) * kLog2e);
              }
            s.l = s.l * exp2f((s.m - m) * kLog2e) + sum;
            s.m = m;
            s.gold += gold;
          }
      });

  // the quad's 4 lanes, then the warps along the vocabulary, in order
  RowState* red = reinterpret_cast<RowState*>(smem);   // [kWarpsN][kBM]
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      RowState s = shfl_merge(st[i][h], 1);
      s = shfl_merge(s, 2);
      if (t == 0) red[warp % kWarpsN * kBM + wm + 16 * i + g + 8 * h] = s;
    }
  __syncthreads();
  if (threadIdx.x < kBM && m0 + (int)threadIdx.x < N) {
    RowState s = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarpsN; ++w) s = merge(s, red[w * kBM + threadIdx.x]);
    float* p = part + (long long)blockIdx.y * 3 * N + m0 + threadIdx.x;
    p[0] = s.m;
    p[N] = s.l;
    p[2 * N] = s.gold;
  }
}

// loss and lse of each token from its S shares, merged in share order
__global__ void lm_head_fwd_bf16_merge_kernel(
    const float* __restrict__ part, const long long* __restrict__ labels,
    float* __restrict__ loss, float* __restrict__ lse, int N, int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  RowState s{kNegInf, 0.f, 0.f};
  for (int k = 0; k < S; ++k) {
    const float* p = part + (long long)k * 3 * N + r;
    s = merge(s, RowState{p[0], p[N], p[2 * N]});
  }
  const float ls = s.m + logf(fmaxf(s.l, 1e-30f));
  lse[r] = ls;
  loss[r] = labels[r] >= 0 ? ls - s.gold : 0.f;
}

// dl[r, c] = bf16((exp(x_r . w_c - lse_r) - [c == y_r]) * g_r) for one
// chunk
__global__ void __launch_bounds__(kThreads, 1)
    lm_head_bwd_bf16_dlogits_kernel(const Operand X, const Operand W,
                                    const long long* __restrict__ labels,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ gm,
                                    bf16* __restrict__ dl, int C, int D,
                                    int V) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
  const int m0 = blockIdx.y * kBM;
  run_tiles<true, true>(
      X, W, C, V, 0, D, m0, blockIdx.x * kBN, 1, smem,
      [&](const Acc& acc, int n) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + wm + 16 * i + g + 8 * h;
            if (r >= C) continue;
            const long long y = labels[r];
            const float ls = lse[r], gr = gm[r];
            bf16* row = dl + (long long)r * V;
#pragma unroll
            for (int j = 0; j < kNJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n + wn + 8 * j + 2 * t + e;
                if (c >= V) continue;
                row[c] = __float2bfloat16_rn(
                    (exp2f((acc.v[i][j][2 * h + e] - ls) * kLog2e) -
                     (c == y ? 1.f : 0.f)) * gr);
              }
          }
      });
}

// out [M, N] (row stride ldo, f32) = A . B over k in this CTA's range
// [z kchunk, min(K, (z + 1) kchunk)), at out + z zstride: dx's partials
__global__ void __launch_bounds__(kThreads, 1)
    lm_head_bwd_bf16_dx_kernel(const Operand A, const Operand B,
                               float* __restrict__ out, long long ldo,
                               long long zstride, int M, int N, int K,
                               int kchunk) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
  const int m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  float* o = out + blockIdx.z * zstride;
  run_tiles<true, false>(
      A, B, M, N, kb, ke, m0, blockIdx.x * kBN, 1, smem,
      [&](const Acc& acc, int n) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + wm + 16 * i + g + 8 * h;
            if (r >= M) continue;
            float* row = o + r * ldo;
#pragma unroll
            for (int j = 0; j < kNJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n + wn + 8 * j + 2 * t + e;
                if (c < N) row[c] = acc.v[i][j][2 * h + e];
              }
          }
      });
}

// dW [D, V] from x^T [D, rows] . dlogits [rows, V]: sum[] = (sum[] +) the
// product in f32, or, on the last chunk (final), out[] = bf16 of it
__global__ void __launch_bounds__(kThreads, 1)
    lm_head_bwd_bf16_dw_kernel(const Operand A, const Operand B,
                               float* __restrict__ sum, bf16* __restrict__ out,
                               int M, int N, int K, int accumulate,
                               int final) {
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
  const int m0 = blockIdx.y * kBM;
  run_tiles<false, true>(
      A, B, M, N, 0, K, m0, blockIdx.x * kBN, 1, smem,
      [&](const Acc& acc, int n) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + wm + 16 * i + g + 8 * h;
            if (r >= M) continue;
            const long long row = (long long)r * N;
#pragma unroll
            for (int j = 0; j < kNJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n + wn + 8 * j + 2 * t + e;
                if (c >= N) continue;
                float v = acc.v[i][j][2 * h + e];
                if (accumulate) v += sum[row + c];
                if (final)
                  out[row + c] = __float2bfloat16_rn(v);
                else
                  sum[row + c] = v;
              }
          }
      });
}

// out[i] = bf16(sum over z < S of part[z n + i]), in z order: dx
__global__ void lm_head_bwd_bf16_reduce_kernel(const float* __restrict__ part,
                                               bf16* __restrict__ out,
                                               long long n, int S) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float s = part[i];
    for (int z = 1; z < S; ++z) s += part[z * n + i];
    out[i] = __float2bfloat16_rn(s);
  }
}

// ---- the backward on wgmma_bf16.cuh (the wgmma path) ----

// what a product's epilogue does with its 128 x 128 tile
enum WgEpi {
  kWgDlogits = 0,   // dl = bf16((exp(l - lse) - onehot) g), bf16 out
  kWgDx = 1,        // dx = bf16(acc), bf16 out
  kWgDxPart = 2,    // dx's range partial, f32 out + range zstride
  kWgDw = 3,        // dW: f32 sum (+)= acc, or bf16 out on the last chunk
};

struct WgArgs {
  ptt_wg::Sched s;
  int M, N;                   // the output's extent (N a multiple of 8)
  long long ldo, zstride;     // output row stride; kWgDxPart: per range
  void* out;
  float* sum;                 // kWgDw: the f32 dW sum
  const long long* labels;    // kWgDlogits: the chunk's rows
  const float* lse;
  const float* g;
  int accumulate, final;      // kWgDw
};

// One product of a chunk: the producer warp loads, the two consumer
// warpgroups run the k-tiles of each of the CTA's tiles and its epilogue.
template <int EPI, bool AMN, bool BMN>
__global__ void __launch_bounds__(ptt_wg::kThreads, 1)
    lm_head_bwd_bf16_wg_kernel(const __grid_constant__ CUtensorMap ta,
                               const __grid_constant__ CUtensorMap tb,
                               const WgArgs p) {
  using ptt_wg::kEpiLD;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const ptt_wg::Smem sm = ptt_wg::setup(smem_raw);
  // the warp's index, known to ptxas to be the same across the warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (warp == ptt_wg::kProducerWarp) {
    if ((threadIdx.x & 31) == 0) ptt_wg::produce<AMN, BMN>(&ta, &tb, sm, p.s);
    return;
  }
  const int h = warp >> 2, tid = threadIdx.x & 127;
  const int fr = 16 * (warp & 3) + ((threadIdx.x & 31) >> 2);  // row, i = 0
  const int fc = 2 * (threadIdx.x & 3);                         // column, j 0
  float* sf = reinterpret_cast<float*>(sm.epi + h * ptt_wg::kEpiBytes);
  bf16* sb = reinterpret_cast<bf16*>(sf);
  ptt_wg::Pipe pipe;
  float acc[64];
  for (int t = blockIdx.x; t < p.s.tiles(); t += gridDim.x) {
    int m0, n0, r, kb, ke;
    p.s.tile(t, m0, n0, r, kb, ke);
    const int r0 = m0 + 64 * h;   // the warpgroup's first output row
    // kWgDlogits: this thread's two rows' lse (times log2 e), g and label,
    // loaded before the products so that their latency hides under them;
    // the label as its offset from this thread's first column of the tile,
    // -1 where it is ignored or outside the tile, so that each element
    // compares it with a constant
    float lb[2] = {0.f, 0.f}, gv[2] = {0.f, 0.f};
    int yo[2] = {-1, -1};
    if constexpr (EPI == kWgDlogits) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r0 + fr + 8 * i;
        if (row < p.M) {
          const long long y = p.labels[row] - n0 - fc;
          yo[i] = y >= 0 && y < ptt_wg::kBN ? (int)y : -1;
          lb[i] = p.lse[row] * kLog2e;
          gv[i] = p.g[row];
        }
      }
    }
    ptt_wg::mainloop<AMN, BMN>(acc, sm, pipe, h, kb, ke);
    ptt_wg::wg_sync(h);   // the staging tile is free again
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int a = 4 * j + 2 * i, so = (fr + 8 * i) * kEpiLD + 8 * j + fc;
        if constexpr (EPI == kWgDlogits) {
          // (exp(l - lse) - onehot) g, exp(l - lse) = 2^(l log2 e - lse
          // log2 e), one ex2.approx each
          const float v0 = (ex2(fmaf(acc[a], kLog2e, -lb[i])) -
                            (yo[i] == 8 * j ? 1.f : 0.f)) * gv[i];
          const float v1 = (ex2(fmaf(acc[a + 1], kLog2e, -lb[i])) -
                            (yo[i] == 8 * j + 1 ? 1.f : 0.f)) * gv[i];
          *reinterpret_cast<__nv_bfloat162*>(sb + so) =
              __floats2bfloat162_rn(v0, v1);
        } else if constexpr (EPI == kWgDx) {
          *reinterpret_cast<__nv_bfloat162*>(sb + so) =
              __floats2bfloat162_rn(acc[a], acc[a + 1]);
        } else {
          *reinterpret_cast<float2*>(sf + so) = make_float2(acc[a], acc[a + 1]);
        }
      }
    ptt_wg::wg_sync(h);
    // 64 rows of 16 chunks of 8 elements, 16 threads along a row
#pragma unroll
    for (int it = 0; it < 8; ++it) {
      const int id = tid + 128 * it, row = id >> 4, c = (id & 15) * 8;
      const int gr = r0 + row, gc = n0 + c;
      if (gr >= p.M || gc >= p.N) continue;
      const long long o = gr * p.ldo + gc;
      if constexpr (EPI == kWgDlogits || EPI == kWgDx) {
        *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + o) =
            *reinterpret_cast<const uint4*>(sb + row * kEpiLD + c);
      } else {
        const float* src = sf + row * kEpiLD + c;
        float4 v0 = *reinterpret_cast<const float4*>(src);
        float4 v1 = *reinterpret_cast<const float4*>(src + 4);
        if constexpr (EPI == kWgDxPart) {
          float* dst = static_cast<float*>(p.out) + r * p.zstride + o;
          *reinterpret_cast<float4*>(dst) = v0;
          *reinterpret_cast<float4*>(dst + 4) = v1;
        } else {
          float* s = p.sum + o;
          if (p.accumulate) {
            const float4 a0 = *reinterpret_cast<const float4*>(s);
            const float4 a1 = *reinterpret_cast<const float4*>(s + 4);
            v0 = make_float4(v0.x + a0.x, v0.y + a0.y, v0.z + a0.z,
                             v0.w + a0.w);
            v1 = make_float4(v1.x + a1.x, v1.y + a1.y, v1.z + a1.z,
                             v1.w + a1.w);
          }
          if (p.final) {
            uint4 pk;
            pk.x = ptt_bf16::pack(v0.x, v0.y);
            pk.y = ptt_bf16::pack(v0.z, v0.w);
            pk.z = ptt_bf16::pack(v1.x, v1.y);
            pk.w = ptt_bf16::pack(v1.z, v1.w);
            *reinterpret_cast<uint4*>(static_cast<bf16*>(p.out) + o) = pk;
          } else {
            *reinterpret_cast<float4*>(s) = v0;
            *reinterpret_cast<float4*>(s + 4) = v1;
          }
        }
      }
    }
  }
}

// W's two maps (K-major for dx, N-major for the recompute), the same for
// every chunk of a call: encoded once for each pointer and shape
struct WMaps {
  CUtensorMap k, mn;
  const void* w = nullptr;
  int D = 0, V = 0;
};

cudaError_t w_maps(const bf16* w, int D, int V, const WMaps*& out) {
  static thread_local WMaps c;
  if (c.w != w || c.D != D || c.V != V) {
    c.w = nullptr;
    cudaError_t err = kmajor_map(&c.k, w, V, D, V);
    if (err == cudaSuccess) err = mnmajor_map(&c.mn, w, V, D, V);
    if (err != cudaSuccess) return err;
    c.w = w;
    c.D = D;
    c.V = V;
  }
  out = &c;
  return cudaSuccess;
}

template <int EPI, bool AMN, bool BMN>
cudaError_t launch_wg(const CUtensorMap& ta, const CUtensorMap& tb,
                      const WgArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      lm_head_bwd_bf16_wg_kernel<EPI, AMN, BMN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ptt_wg::kSmemBytes);
  if (err != cudaSuccess) return err;
  const int grid = a.s.tiles() < sm_count() ? a.s.tiles() : sm_count();
  lm_head_bwd_bf16_wg_kernel<EPI, AMN, BMN>
      <<<grid, ptt_wg::kThreads, ptt_wg::kSmemBytes, s>>>(ta, tb, a);
  return cudaGetLastError();
}

// ---- the forward on wgmma_bf16.cuh's pieces (the wgmma path) ----
//
// lm_head_fwd_bf16_wg_kernel<XRES> computes what lm_head_fwd_bf16_kernel
// does, x [N, D] . W [D, V] folded into a running (max, sum of exp, gold
// logit) per row, on Hopper's warpgroup tensor cores:
//   - The split.  The grid of 128 x 128 (token tile, vocab tile) tiles is
//     flattened with the vocabulary fastest and cut into gridDim.x
//     contiguous ranges of equal length (+-1), one per persistent CTA
//     (min(132, tiles) CTAs; 32000 tiles at the training shape, 242-243 a
//     CTA).  A range's tiles of one token tile form a segment.  Each
//     segment writes its rows' (max, sum, gold) to its slot of the
//     workspace, slot = CTA - (the first CTA of that token tile), and the
//     merge launch folds a row's slots in vocabulary order.  No atomics:
//     the same bits on every call on one card.
//   - The loop.  384 threads: consumer warpgroups 0 and 1 and a producer
//     warpgroup whose warp 8 lane 0 issues the TMA loads and which gives
//     its registers to the consumers (setmaxnreg 40 / 232).  The consumers
//     ping-pong: warpgroup h takes the CTA's vocab tiles of parity h, all
//     128 rows of each (two wgmma m64n128k16 a k16 step, A = x read
//     K-major, B = W read N-major, 128 f32 accumulators a thread), and
//     they issue a tile's products in turns (named barriers), so that one
//     warpgroup's softmax runs while the other's products do, as in the
//     flash forward.  At a segment's end warpgroup 0 merges its rows'
//     states with warpgroup 1's.  XRES (D <= 640): x's 128 x D tile stays in
//     shared memory for a whole segment (cdiv(D, 64) K-major boxes of 64 k
//     x 128 rows, loaded at the segment's start: a CTA whose range crosses
//     one token-tile boundary loads x twice), and only W's k-tiles stream
//     through the mbarrier ring (6 stages of 16 KiB at D 512: 128 + 96
//     KiB).  That halves the bytes a product reads from L2, to 128 FLOP a
//     byte.  Else x's k-tile streams beside W's in each stage, as in
//     ptt_wg::mainloop.
//   - The epilogue.  Each consumer thread keeps a (max, sum, gold) of its
//     own columns for each of its rows, with no shuffle a tile: per logit
//     one select (the ragged vocabulary tail, which TMA fills with zeros,
//     becomes -1e30), one max, one FMA and one ex2.approx; the gold logit
//     is a compare of the column with the label's offset in the tile.  The
//     quad's lanes are merged once, at the segment's end, in a fixed
//     order, then the two warpgroups'.
//   - Slower forms, measured and not kept (PERF.md): x streamed where it
//     fits, and each warpgroup its own 64 rows of every vocab tile with the
//     next tile's first k-tiles issued into a second accumulator set before
//     this tile's softmax (its conditional issue meets C7518).
//   - One accumulator set carries a tile's whole k loop; a build with
//     -DPTT_WG_FLUSH=n adds every n k-tiles into a second one
//     (tools/wgmma_flush.py).  No read of an accumulator sits under a
//     branch that ptxas cannot prove uniform (C7518): every bound derives
//     from blockIdx and the arguments in 32-bit arithmetic (a 64-bit
//     division is a call), the warp index goes through __shfl_sync, and a
//     tile's products complete (wait_group 0) before its softmax reads
//     them.
namespace fwd_wg {

constexpr int kThreads = 384;
constexpr int kSmemMax = 232448;   // a block's opt-in dynamic shared memory
constexpr int kMisc = 2048;        // barriers, then the warpgroups' exchange
constexpr int kXchg = 256;         // the exchange's offset in kMisc
constexpr int kBox = ptt_wg::kTileBytes;   // 64 k x 128 rows of bf16
constexpr int kMaxStages = 8, kMinStages = 4;

constexpr int kFlush = ptt_wg::kFlush;

// The balanced split of `tiles` = q ctas + r flat tiles (t = m nt + v)
// over `ctas` CTAs: CTA c takes [begin(c), begin(c + 1)), begin(c) =
// floor(c tiles / ctas).
struct Split {
  int tiles, nt, ctas, q, r;
  __host__ __device__ int begin(int c) const { return c * q + c * r / ctas; }
  // the CTA whose range holds tile t (host and the merge launch)
  __host__ __device__ int owner(int t) const {
    return (int)(((t + 1LL) * ctas - 1) / tiles);
  }
};

struct Args {
  Split sp;
  int N, V, nk, nst;           // k-tiles of D, ring stages
  const long long* labels;
  float* part;                 // [slots][3][N]: max, sum, gold
};

// A consumer warpgroup's view of the ring: the slot its next k-tile lands
// in (iss) and the oldest slot it has not released (rel), `held` apart.
template <bool XRES>
struct Ring {
  static constexpr int kStage = XRES ? kBox : 2 * kBox;   // (x's,) W's
  uint32_t ring, xs, bars;
  int nst;
  ptt_wg::Pipe iss, rel;
  int held = 0;

  __device__ __forceinline__ uint32_t full(int s) const {
    return bars + 8 * s;
  }
  __device__ __forceinline__ uint32_t empty(int s) const {
    return bars + 8 * (kMaxStages + s);
  }
  // k-tile k's products for the tile's two 64-row halves into d0 and d1
  // (fresh: overwriting them), one commit group; waits for the k-tile
  __device__ __forceinline__ void issue(float (&d0)[64], float (&d1)[64],
                                        int k, bool fresh) {
    ptt_wg::mbar_wait(full(iss.stage), iss.phase);
    ptt_wg::wgmma_fence();
    const uint32_t st = ring + iss.stage * kStage;
    const uint32_t ta = XRES ? xs + k * kBox : st;
    const uint32_t tb = XRES ? st : st + kBox;
#pragma unroll
    for (int j = 0; j < ptt_wg::kBK / 16; ++j) {
      const uint64_t db = ptt_wg::Op<true>::desc(tb, 0, j);
      ptt_wg::wgmma<0, 1>(d0, ptt_wg::Op<false>::desc(ta, 0, j), db,
                          fresh && j == 0 ? 0 : 1);
      ptt_wg::wgmma<0, 1>(d1, ptt_wg::Op<false>::desc(ta, 64, j), db,
                          fresh && j == 0 ? 0 : 1);
    }
    ptt_wg::wgmma_commit();
    iss.next(nst);
    ++held;
  }
  // releases slots until `keep` are held (their groups have completed)
  __device__ __forceinline__ void release_to(int keep) {
    for (; held > keep; --held) {
      ptt_wg::release(empty(rel.stage));
      rel.next(nst);
    }
  }
  // moves past n k-tiles (the other warpgroup's), none held
  __device__ __forceinline__ void skip(int n) {
    for (int i = 0; i < n; ++i) {
      iss.next(nst);
      rel.next(nst);
    }
  }
};

// the consumer warpgroups' turns (ping-pong: named barriers 3 and 4, 256
// threads; one waits, the other arrives) and their exchange (barrier 5)
__device__ __forceinline__ void turn_wait(int h) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + h) : "memory");
}
__device__ __forceinline__ void turn_pass(int h) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - h) : "memory");
}
__device__ __forceinline__ void pair_sync() {
  asm volatile("bar.sync 5, 256;\n" ::: "memory");
}

// A vocab tile's products, issued in this warpgroup's turn; waits for them
// and releases their slots.  kFlush > 0 (a measurement build, whose flush
// branch reads an accumulator): every k-tile goes into p0 and p1, added to
// d0 and d1 every kFlush k-tiles and at the end.
template <bool XRES>
__device__ __forceinline__ void tile(Ring<XRES>& rg, float (&d0)[64],
                                     float (&d1)[64], int nk, int h) {
  turn_wait(h);
  if constexpr (kFlush > 0) {
    float p0[64], p1[64];
    for (int k = 0; k < nk; ++k) {
      rg.issue(p0, p1, k, k % kFlush == 0);
      if ((k + 1) % kFlush == 0 || k + 1 == nk) {
        ptt_wg::wgmma_wait<0>();
        ptt_wg::fence_acc(p0);
        ptt_wg::fence_acc(p1);
        rg.release_to(0);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          d0[i] = k < kFlush ? p0[i] : d0[i] + p0[i];
          d1[i] = k < kFlush ? p1[i] : d1[i] + p1[i];
        }
      }
    }
    turn_pass(h);
  } else {
    for (int k = 0; k < nk; ++k) {
      rg.issue(d0, d1, k, k == 0);
      ptt_wg::wgmma_wait<1>();
      rg.release_to(1);
    }
    turn_pass(h);
    ptt_wg::wgmma_wait<0>();
    ptt_wg::fence_acc(d0);
    ptt_wg::fence_acc(d1);
    rg.release_to(0);
  }
}

// Folds vocab tile n0.. of one 64-row half (acc as wgmma leaves it:
// acc[4 j + 2 i + e] is row fr + 8 i, column n0 + 8 j + fc + e) into the
// thread's running states of its two rows, whose labels are y.
__device__ __forceinline__ void fold(float (&acc)[64], RowState (&st)[2],
                                     const int (&y)[2], int n0, int V,
                                     int fc) {
  const int lim = V - n0 - fc;   // this thread's columns 8 j + e < lim
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int yo = y[i] - n0 - fc;
    float mx = kNegInf, gold = st[i].gold;
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = acc[4 * j + 2 * i + e];
        v = 8 * j + e < lim ? v : kNegInf;
        mx = fmaxf(mx, v);
        gold = 8 * j + e == yo ? v : gold;
      }
    const float m = fmaxf(st[i].m, mx), ml = m * kLog2e;
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      s0 += ex2(fmaf(acc[4 * j + 2 * i], kLog2e, -ml));
      s1 += ex2(fmaf(acc[4 * j + 2 * i + 1], kLog2e, -ml));
    }
    st[i].l = fmaf(st[i].l, ex2(fmaf(st[i].m, kLog2e, -ml)), s0 + s1);
    st[i].m = m;
    st[i].gold = gold;
  }
}

}  // namespace fwd_wg

template <bool XRES>
__global__ void __launch_bounds__(fwd_wg::kThreads, 1)
    lm_head_fwd_bf16_wg_kernel(const __grid_constant__ CUtensorMap tx,
                               const __grid_constant__ CUtensorMap tw,
                               const fwd_wg::Args a) {
  using namespace fwd_wg;
  constexpr int kStage = Ring<XRES>::kStage;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = ptt_wg::smem_addr(smem_raw);
  const uint32_t pad = (1024 - raw % 1024) % 1024;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kMaxStages + s), x's
  // full and empty after them; the exchange; x's boxes (XRES); the ring
  const uint32_t bars = raw + pad;
  const uint32_t xfull = bars + 16 * kMaxStages, xempty = xfull + 8;
  float* xchg = reinterpret_cast<float*>(smem_raw + pad + kXchg);
  const uint32_t xs = bars + kMisc;
  const uint32_t ring = xs + (XRES ? a.nk * kBox : 0);
  if (threadIdx.x == 0) {
    for (int i = 0; i < a.nst; ++i) {
      ptt_wg::mbar_init(bars + 8 * i, 1);
      // one arrival per consumer warp that reads the slot
      ptt_wg::mbar_init(bars + 8 * (kMaxStages + i), 4);
    }
    ptt_wg::mbar_init(xfull, 1);
    ptt_wg::mbar_init(xempty, 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tb = a.sp.begin(blockIdx.x), te = a.sp.begin(blockIdx.x + 1);
  const int nt = a.sp.nt;
  // the warp's index, known to ptxas to be the same across the warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != 8 || (threadIdx.x & 31) != 0) return;
    // every k-tile of every vocab tile of the range, in order; x's tile at
    // each segment's start (XRES)
    ptt_wg::Pipe p;
    int seg = 0;
    for (int t = tb; t < te; ++seg) {
      const int m = t / nt, se = min(te, (m + 1) * nt);
      if (XRES) {
        ptt_wg::mbar_wait(xempty, (seg & 1) ^ 1);
        ptt_wg::mbar_expect_tx(xfull, a.nk * kBox);
        for (int k = 0; k < a.nk; ++k)
          ptt_wg::tma_load(xs + k * kBox, &tx, xfull, k * ptt_wg::kBK,
                           m * ptt_wg::kBM);
      }
      for (; t < se; ++t) {
        const int n0 = (t - m * nt) * ptt_wg::kBN;
        for (int k = 0; k < a.nk; ++k) {
          const uint32_t full = bars + 8 * p.stage;
          const uint32_t st = ring + p.stage * kStage;
          ptt_wg::mbar_wait(bars + 8 * (kMaxStages + p.stage), p.phase ^ 1);
          ptt_wg::mbar_expect_tx(full, kStage);
          if (!XRES)
            ptt_wg::Op<false>::load(st, &tx, full, m * ptt_wg::kBM,
                                    k * ptt_wg::kBK);
          ptt_wg::Op<true>::load(st + (XRES ? 0 : kBox), &tw, full, n0,
                                 k * ptt_wg::kBK);
          p.next(a.nst);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int h = warp >> 2, lane = threadIdx.x & 31;
  const int fr = 16 * (warp & 3) + (lane >> 2);   // rows fr, fr + 8 of 64
  const int fc = 2 * (lane & 3);                  // columns fc, fc + 1 of 8
  // this thread's rows: fr + 8 i of the tile's half b
  Ring<XRES> rg;
  rg.ring = ring;
  rg.xs = xs;
  rg.bars = bars;
  rg.nst = a.nst;
  float acc0[64], acc1[64];
  if (h == 1) turn_pass(1);   // warpgroup 0 first
  int at = 0;   // the ring stands at tile tb + at's first k-tile
  int seg = 0;
  for (int t = tb; t < te; ++seg) {
    const int m = t / nt, se = min(te, (m + 1) * nt);
    const int v0 = t - m * nt, n = se - t;
    int y[2][2];
    RowState st[2][2];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = m * ptt_wg::kBM + 64 * b + fr + 8 * i;
        y[b][i] = r < a.N ? (int)a.labels[r] : -1;
        st[b][i] = RowState{kNegInf, 0.f, 0.f};
      }
    if (XRES) ptt_wg::mbar_wait(xfull, seg & 1);
    // this warpgroup's tiles of the segment: local index q of parity h
    const int q0 = t - tb;
    for (int q = q0 + ((q0 & 1) != h); q < q0 + n; q += 2) {
      rg.skip((q - at) * a.nk);
      tile(rg, acc0, acc1, a.nk, h);
      at = q + 1;
      const int n0 = (v0 + q - q0) * ptt_wg::kBN;
      fold(acc0, st[0], y[0], n0, a.V, fc);
      fold(acc1, st[1], y[1], n0, a.V, fc);
    }
    if (XRES) ptt_wg::release(xempty);   // every product of x has completed
    // the segment's slot: this CTA's place among its token tile's CTAs
    int first = blockIdx.x;
    while (first > 0 && a.sp.begin(first) > m * nt) --first;
    float* out = a.part + (long long)(blockIdx.x - first) * 3 * a.N;
    // the quad's lanes, in a fixed order; then warpgroup 0's state with
    // warpgroup 1's, through shared memory
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        RowState s = shfl_merge(st[b][i], 1);
        s = shfl_merge(s, 2);
        const int lr = 64 * b + fr + 8 * i;   // tile row
        if (h == 1 && fc == 0) {
          xchg[3 * lr] = s.m;
          xchg[3 * lr + 1] = s.l;
          xchg[3 * lr + 2] = s.gold;
        }
        st[b][i] = s;
      }
    pair_sync();
    if (h == 0 && fc == 0) {
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int lr = 64 * b + fr + 8 * i;
          const int r = m * ptt_wg::kBM + lr;
          const RowState s =
              merge(st[b][i], RowState{xchg[3 * lr], xchg[3 * lr + 1],
                                       xchg[3 * lr + 2]});
          if (r < a.N) {
            out[r] = s.m;
            out[a.N + r] = s.l;
            out[2 * a.N + r] = s.gold;
          }
        }
    }
    pair_sync();   // the exchange is free again
    t = se;
  }
}

// loss and lse of each token from its token tile's segment states, merged
// in vocabulary order (slot 0 first)
__global__ void lm_head_fwd_bf16_wg_merge_kernel(
    const float* __restrict__ part, const long long* __restrict__ labels,
    float* __restrict__ loss, float* __restrict__ lse, int N,
    fwd_wg::Split sp) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  const int t0 = r / ptt_wg::kBM * sp.nt;
  const int slots = sp.owner(t0 + sp.nt - 1) - sp.owner(t0) + 1;
  RowState s{kNegInf, 0.f, 0.f};
  for (int k = 0; k < slots; ++k) {
    const float* p = part + (long long)k * 3 * N + r;
    s = merge(s, RowState{p[0], p[N], p[2 * N]});
  }
  const float ls = s.m + logf(fmaxf(s.l, 1e-30f));
  lse[r] = ls;
  loss[r] = labels[r] >= 0 ? ls - s.gold : 0.f;
}

// The wgmma forward's plan on this card: the split over min(SMs, tiles)
// CTAs, the slots a token tile's segments take (the most over the token
// tiles), the k-tiles, whether x stays resident, the ring's stages and the
// dynamic shared memory.  ok is false where the sizes cannot be planned
// (tiles past 32 bits).  kernels/lm_head.py fwd_bf16_plan mirrors it, and
// ptt_lm_head_fwd_bf16_wgmma_plan exports it for the card's tests.
struct FwdWgPlan {
  fwd_wg::Split sp;
  int slots, nk, xres, nst, smem;
  bool ok;
};

FwdWgPlan fwd_wg_plan(int N, int D, int V) {
  using namespace fwd_wg;
  FwdWgPlan p{};
  const long long mt = cdiv(N, ptt_wg::kBM), nt = cdiv(V, ptt_wg::kBN);
  p.ok = N > 0 && D > 0 && V > 0 && mt * nt < (1LL << 30);
  if (!p.ok) return p;
  const int ctas = mt * nt < sm_count() ? (int)(mt * nt) : sm_count();
  p.sp.nt = (int)nt;
  p.sp.tiles = (int)(mt * nt);
  p.sp.ctas = ctas;
  p.sp.q = p.sp.tiles / ctas;
  p.sp.r = p.sp.tiles % ctas;
  p.nk = cdiv(D, ptt_wg::kBK);
  const long long room = kSmemMax - 1024 - kMisc;
  const long long res = (room - (long long)p.nk * kBox) / kBox;
  p.xres = res >= kMinStages;
  p.nst = (int)(p.xres ? res : room / (2 * kBox));
  p.nst = p.nst < kMaxStages ? p.nst : kMaxStages;
  p.smem = 1024 + kMisc + (p.xres ? p.nk * kBox : 0) +
           p.nst * (p.xres ? 1 : 2) * kBox;
  for (int m = 0; m < mt; ++m) {
    const int t0 = m * p.sp.nt;
    const int s = p.sp.owner(t0 + p.sp.nt - 1) - p.sp.owner(t0) + 1;
    p.slots = s > p.slots ? s : p.slots;
  }
  return p;
}

template <bool XRES>
cudaError_t launch_fwd_wg(const CUtensorMap& tx, const CUtensorMap& tw,
                          const FwdWgPlan& p, const fwd_wg::Args& a,
                          cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      lm_head_fwd_bf16_wg_kernel<XRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return err;
  lm_head_fwd_bf16_wg_kernel<XRES>
      <<<p.sp.ctas, fwd_wg::kThreads, p.smem, s>>>(tx, tw, a);
  return cudaGetLastError();
}

// the forward's vocabulary shares: tiles per share and the share count
void fwd_plan(int N, int V, int& per, int& shares) {
  const int mt = cdiv(N, kBM), nt = cdiv(V, kBN);
  int s = cdiv((long long)kWaves * sm_count(), mt);
  s = s < 1 ? 1 : (s > nt ? nt : s);
  per = cdiv(nt, s);
  shares = cdiv(nt, per);
}

// the dx product's K (vocabulary) ranges for a chunk capacity of C rows:
// range length (a multiple of kBK) and count
void dx_plan(int C, int D, int V, int& kchunk, int& ranges) {
  const int tiles = cdiv(C, kBM) * cdiv(D, kBN);
  const int kt = cdiv(V, kBK);
  int s = cdiv((long long)kWaves * sm_count(), tiles);
  s = s < 1 ? 1 : (s > kt ? kt : s);
  kchunk = cdiv(kt, s) * kBK;
  ranges = cdiv(V, kchunk);
}

// byte offsets of the backward's workspace regions for chunks of at most
// C rows: dlogits, the dx partials ([ranges][C][D] f32), the f32 dW sum,
// and the total
struct BwdWork {
  long long dl, dxp, dws, bytes;
};

BwdWork bwd_work(int C, int D, int V) {
  int kchunk, ranges;
  dx_plan(C, D, V, kchunk, ranges);
  BwdWork w;
  w.dl = 0;
  w.dxp = w.dl + align256(2LL * C * V);
  w.dws = w.dxp + align256(4LL * ranges * C * D);
  w.bytes = w.dws + align256(4LL * D * V);
  return w;
}

// byte offsets of the wgmma path's workspace for chunks of at most C rows
// and dx in `ranges` K ranges: dlogits [C][V] bf16, the dx partials
// ([ranges][C][D] f32, none for one range), the f32 dW sum, the total
BwdWork wg_work(int C, int D, int V, int ranges) {
  BwdWork w;
  w.dl = 0;
  w.dxp = w.dl + align256(2LL * C * V);
  w.dws = w.dxp + (ranges > 1 ? align256(4LL * ranges * C * D) : 0);
  w.bytes = w.dws + align256(4LL * D * V);
  return w;
}

}  // namespace

// Workspace bytes of ptt_lm_head_fwd_bf16 at these sizes: the shares'
// partial states.
extern "C" long long ptt_lm_head_fwd_bf16_workspace(int N, int D, int V) {
  int per, shares;
  fwd_plan(N, V, per, shares);
  return align256(12LL * shares * N);
}

// x [N, D], w [D, V] bf16, labels [N] int64 -> loss [N], lse [N] f32; all
// contiguous; work holds ptt_lm_head_fwd_bf16_workspace(N, D, V) bytes,
// 256-byte aligned.  Two launches: the product with its running softmax,
// the merge of the vocabulary shares.  Returns a cudaError_t as int.
extern "C" int ptt_lm_head_fwd_bf16(const void* x, const void* w,
                                    const void* labels, void* loss,
                                    void* lse, void* work, int N, int D,
                                    int V, void* stream) {
  if (N <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int per, shares;
  fwd_plan(N, V, per, shares);
  float* part = static_cast<float*>(work);
  const long long* y = static_cast<const long long*>(labels);
  cudaError_t err = allow_smem<true, true>(lm_head_fwd_bf16_kernel);
  if (err != cudaSuccess) return (int)err;
  lm_head_fwd_bf16_kernel<<<dim3(cdiv(N, kBM), shares), kThreads,
                            Layout<true, true>::kSmemBytes, s>>>(
      operand(static_cast<const bf16*>(x), D),
      operand(static_cast<const bf16*>(w), V), y, part, N, D, V, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lm_head_fwd_bf16_merge_kernel<<<cdiv(N, 256), 256, 0, s>>>(
      part, y, static_cast<float*>(loss), static_cast<float*>(lse), N,
      shares);
  return (int)cudaGetLastError();
}

// Workspace bytes of ptt_lm_head_fwd_bf16_wgmma: the segments' states,
// [slots][3][N] f32 (0 where the sizes cannot be planned).
extern "C" long long ptt_lm_head_fwd_bf16_wgmma_workspace(int N, int D,
                                                          int V) {
  const FwdWgPlan p = fwd_wg_plan(N, D, V);
  return p.ok ? align256(12LL * p.slots * N) : 0;
}

// The wgmma forward's plan on this card, for a check of its Python mirror:
// out[0..5] = CTAs, slots, k-tiles, x resident (0 or 1), ring stages,
// dynamic shared memory; begins[c] = the first flat tile of CTA c for c <=
// CTAs, as far as `nbegins` entries go.  Returns cudaErrorInvalidValue
// where the sizes cannot be planned.
extern "C" int ptt_lm_head_fwd_bf16_wgmma_plan(int N, int D, int V,
                                               int* out, int* begins,
                                               int nbegins) {
  const FwdWgPlan p = fwd_wg_plan(N, D, V);
  if (!p.ok) return (int)cudaErrorInvalidValue;
  const int v[6] = {p.sp.ctas, p.slots, p.nk, p.xres, p.nst, p.smem};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  for (int c = 0; c <= p.sp.ctas && c < nbegins; ++c)
    begins[c] = p.sp.begin(c);
  return 0;
}

// The forward on the wgmma path: the arguments of ptt_lm_head_fwd_bf16;
// min(SMs, tiles) CTAs; x and w 16-byte aligned, D and V multiples of 8,
// as TMA needs, else cudaErrorInvalidValue before any launch; work holds
// ptt_lm_head_fwd_bf16_wgmma_workspace(N, D, V) bytes, 256-byte aligned.
// Two launches: the products with the running softmax, the merge of each
// token tile's segments.  Returns a cudaError_t as int.
extern "C" int ptt_lm_head_fwd_bf16_wgmma(const void* x, const void* w,
                                          const void* labels, void* loss,
                                          void* lse, void* work, int N,
                                          int D, int V, void* stream) {
  const FwdWgPlan p = fwd_wg_plan(N, D, V);
  if (!p.ok || D % 8 || V % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(w) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const WMaps* wm;
  CUtensorMap x_k;
  cudaError_t err;
  if ((err = w_maps(static_cast<const bf16*>(w), D, V, wm)) != cudaSuccess ||
      (err = kmajor_map(&x_k, xb, D, N, D)) != cudaSuccess)
    return (int)err;
  const long long* y = static_cast<const long long*>(labels);
  float* part = static_cast<float*>(work);
  const fwd_wg::Args a{p.sp, N, V, p.nk, p.nst, y, part};
  err = p.xres ? launch_fwd_wg<true>(x_k, wm->mn, p, a, s)
               : launch_fwd_wg<false>(x_k, wm->mn, p, a, s);
  if (err != cudaSuccess) return (int)err;
  lm_head_fwd_bf16_wg_merge_kernel<<<cdiv(N, 256), 256, 0, s>>>(
      part, y, static_cast<float*>(loss), static_cast<float*>(lse), N, p.sp);
  return (int)cudaGetLastError();
}

// Workspace bytes of ptt_lm_head_bwd_chunk_bf16 for chunks of at most C
// rows.
extern "C" long long ptt_lm_head_bwd_bf16_workspace(int C, int D, int V) {
  return bwd_work(C, D, V).bytes;
}

// One token chunk of the backward: x, labels, lse and g point at the
// chunk's first row (rows rows, at most cap, the chunk size the workspace
// was sized for); dx points at the chunk's rows of [N, D] bf16; dw [D, V]
// bf16 is written by the last chunk (final), the chunks before it summing
// dW in f32 in the workspace (accumulate 0 on the first chunk).  x and w
// bf16, lse and g f32, labels int64, all contiguous; work holds
// ptt_lm_head_bwd_bf16_workspace(cap, D, V) bytes, 256-byte aligned, and
// is kept between the chunks of one backward.  Returns a cudaError_t as
// int.
extern "C" int ptt_lm_head_bwd_chunk_bf16(const void* x, const void* w,
                                          const void* labels,
                                          const void* lse, const void* g,
                                          void* work, void* dx, void* dw,
                                          int rows, int cap, int D, int V,
                                          int accumulate, int final,
                                          void* stream) {
  if (rows <= 0 || rows > cap || D <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int kchunk, ranges;
  dx_plan(cap, D, V, kchunk, ranges);
  const BwdWork off = bwd_work(cap, D, V);
  char* base = static_cast<char*>(work);
  bf16* dl = reinterpret_cast<bf16*>(base + off.dl);
  float* dxp = reinterpret_cast<float*>(base + off.dxp);
  float* dws = reinterpret_cast<float*>(base + off.dws);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);

  // (1) dlogits [rows, V], bf16
  cudaError_t err = allow_smem<true, true>(lm_head_bwd_bf16_dlogits_kernel);
  if (err != cudaSuccess) return (int)err;
  lm_head_bwd_bf16_dlogits_kernel<<<dim3(cdiv(V, kBN), cdiv(rows, kBM)),
                                    kThreads, Layout<true, true>::kSmemBytes,
                                    s>>>(
      operand(xb, D), operand(wb, V), static_cast<const long long*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g), dl, rows,
      D, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (2) dx [rows, D] = dlogits [rows, V] . W^T, where W^T (v, d) is
  // w[d V + v]: k-contiguous rows of V; the ranges' f32 partials, then
  // their sum rounded to bf16
  err = allow_smem<true, false>(lm_head_bwd_bf16_dx_kernel);
  if (err != cudaSuccess) return (int)err;
  lm_head_bwd_bf16_dx_kernel<<<dim3(cdiv(D, kBN), cdiv(rows, kBM), ranges),
                               kThreads, Layout<true, false>::kSmemBytes,
                               s>>>(operand(dl, V), operand(wb, V), dxp, D,
                                    (long long)rows * D, rows, D, V, kchunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)rows * D;
  lm_head_bwd_bf16_reduce_kernel<<<pass_blocks(n), 256, 0, s>>>(
      dxp, static_cast<bf16*>(dx), n, ranges);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (3) dW [D, V] (+)= x^T [D, rows] . dlogits [rows, V], where x^T (d, c)
  // is x[c D + d]: m-contiguous rows of D
  err = allow_smem<false, true>(lm_head_bwd_bf16_dw_kernel);
  if (err != cudaSuccess) return (int)err;
  lm_head_bwd_bf16_dw_kernel<<<dim3(cdiv(V, kBN), cdiv(D, kBM), 1), kThreads,
                               Layout<false, true>::kSmemBytes, s>>>(
      operand(xb, D), operand(dl, V), dws, static_cast<bf16*>(dw), D, V,
      rows, accumulate, final);
  return (int)cudaGetLastError();
}

// Workspace bytes of ptt_lm_head_bwd_chunk_bf16_wgmma for chunks of at most
// C rows with dx in `ranges` K ranges.
extern "C" long long ptt_lm_head_bwd_bf16_wgmma_workspace(int C, int D, int V,
                                                          int ranges) {
  return wg_work(C, D, V, ranges).bytes;
}

// One token chunk of the backward on the wgmma path: the arguments of
// ptt_lm_head_bwd_chunk_bf16, the dx product's K ranges (`ranges`, one
// that cuts the vocabulary's cdiv(V, 64) k-tiles into ranges of equal
// k-tile counts, the last shorter; the caller's plan, lm_head.py
// bwd_bf16_plan).  x, w, dx, dw and the
// workspace 16-byte aligned and D, V multiples of 8, as TMA needs; work
// holds ptt_lm_head_bwd_bf16_wgmma_workspace(cap, D, V, ranges) bytes.
// Three launches (four where ranges > 1).  Returns a cudaError_t as int.
extern "C" int ptt_lm_head_bwd_chunk_bf16_wgmma(
    const void* x, const void* w, const void* labels, const void* lse,
    const void* g, void* work, void* dx, void* dw, int rows, int cap, int D,
    int V, int accumulate, int final, int ranges, void* stream) {
  if (rows <= 0 || rows > cap || D <= 0 || V <= 0 || D % 8 || V % 8)
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[] = {x, w, work, dx, dw};
  for (const void* ptr : ptrs)
    if (reinterpret_cast<uintptr_t>(ptr) % 16)
      return (int)cudaErrorInvalidValue;
  const ptt_wg::Sched dxs = ptt_wg::sched(rows, D, V, ranges);
  if (ranges < 1 || dxs.ranges != ranges) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const BwdWork off = wg_work(cap, D, V, ranges);
  char* base = static_cast<char*>(work);
  bf16* dl = reinterpret_cast<bf16*>(base + off.dl);
  float* dxp = reinterpret_cast<float*>(base + off.dxp);
  float* dws = reinterpret_cast<float*>(base + off.dws);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w);
  const WMaps* wm;
  CUtensorMap x_k, x_mn, dl_k, dl_mn;
  cudaError_t err;
  if ((err = w_maps(wb, D, V, wm)) != cudaSuccess ||
      (err = kmajor_map(&x_k, xb, D, rows, D)) != cudaSuccess ||
      (err = mnmajor_map(&x_mn, xb, D, rows, D)) != cudaSuccess ||
      (err = kmajor_map(&dl_k, dl, V, rows, V)) != cudaSuccess ||
      (err = mnmajor_map(&dl_mn, dl, V, rows, V)) != cudaSuccess)
    return (int)err;
  WgArgs a{};

  // (1) dlogits [rows, V] bf16 = f(x [rows, D] . W [D, V])
  a.s = ptt_wg::sched(rows, V, D, 1);
  a.M = rows;
  a.N = V;
  a.ldo = V;
  a.out = dl;
  a.labels = static_cast<const long long*>(labels);
  a.lse = static_cast<const float*>(lse);
  a.g = static_cast<const float*>(g);
  err = launch_wg<kWgDlogits, false, true>(x_k, wm->mn, a, s);
  if (err != cudaSuccess) return (int)err;

  // (2) dx [rows, D] = dlogits [rows, V] . W^T [V, D]: W read K-major
  a.s = dxs;
  a.N = D;
  a.ldo = D;
  if (ranges == 1) {
    a.out = dx;
    err = launch_wg<kWgDx, false, false>(dl_k, wm->k, a, s);
    if (err != cudaSuccess) return (int)err;
  } else {
    a.out = dxp;
    a.zstride = (long long)rows * D;
    err = launch_wg<kWgDxPart, false, false>(dl_k, wm->k, a, s);
    if (err != cudaSuccess) return (int)err;
    const long long n = (long long)rows * D;
    lm_head_bwd_bf16_reduce_kernel<<<pass_blocks(n), 256, 0, s>>>(
        dxp, static_cast<bf16*>(dx), n, ranges);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // (3) dW [D, V] (+)= x^T [D, rows] . dlogits [rows, V]: x read M-major
  a.s = ptt_wg::sched(D, V, rows, 1);
  a.M = D;
  a.N = V;
  a.ldo = V;
  a.out = dw;
  a.sum = dws;
  a.accumulate = accumulate;
  a.final = final;
  return (int)launch_wg<kWgDw, true, true>(x_mn, dl_mn, a, s);
}
