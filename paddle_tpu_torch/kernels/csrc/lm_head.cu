// Streamed LM head with softmax cross-entropy, forward and backward, for
// Hopper (sm_90a), on the TF32 tensor cores in three passes (3xTF32).
//
// Replaces the Pallas TPU kernels paddle_tpu/kernels/lm_head.py:_fwd (body
// _fwd_kernel) and _bwd (body _bwd_kernel).  x [N, D], W [D, V] and labels
// [N] (int64, negative = ignored), all f32 and contiguous:
//   forward:  loss_n = lse_n - (x_n W)[y_n]  (0 where y_n < 0),
//             lse_n = logsumexp_v (x_n W)_v
//   backward: dlogits = (softmax(x W) - onehot(y)) * g   (g = 0 where y < 0)
//             dx = dlogits W^T,  dW = x^T dlogits
// The products are computed here, on gemm_tc.cuh's tile loop, not by a
// library.
//
// Bound on the H100: operations.  The forward is one product, 2*N*D*V FLOP
// (537 GFLOP at N 16384, D 512, V 32000); the backward three (recompute,
// dx, dW).  In 3xTF32 the tensor cores do three TF32 products for each f32
// one: 1.61 TFLOP forward at 495 TFLOP/s = 3.25 ms, 4.83 TFLOP backward =
// 9.76 ms.  The bytes (x, W, dx, dW once) are two orders of magnitude
// below that at these shapes.
//
// Design.  Every product runs on the 3xTF32 tile loop of gemm_tc.cuh
// (128 x 128 CTA tiles, 8 warps, a 3-stage cp.async ring).  Its operands
// are pre-split (hi, lo) pairs, so no rounding runs in the inner loop: x
// and W are split once per call by a pre-pass into the caller's workspace,
// and the backward's dlogits are written split by the epilogue that makes
// them.
//   lm_head_fwd: a CTA takes 128 tokens and one of S contiguous shares of
//     the vocabulary tiles (S chosen so that about four waves of CTAs fill
//     the SMs), and walks its share in one pipeline.  After each vocab tile
//     every lane folds its own 8 logits of each of its 8 rows (a 64 x 32
//     warp tile) into a running (max, sum of exp, gold logit): no shuffle
//     and no shared memory inside the loop.  At the end the 4 lanes of a quad, then the
//     4 warps along the vocabulary (through shared memory), merge their
//     states in a fixed order, and a second small launch merges the S
//     shares of each token in share order and writes loss and lse.  No
//     logit leaves the chip.  The vocab tail is masked by column index, so
//     V is any width.
//   lm_head_bwd, per token chunk of C rows (the op's chunk_size): the
//     first chunk splits W; each chunk splits its rows of x, then
//     (1) recomputes the logits tile and writes dlogits [C, V], split, to
//     the workspace; (2) dx = dlogits W^T, with the vocabulary (K) cut into
//     S ranges so that enough CTAs fill the SMs (C / 128 x D / 128 output
//     tiles alone are 128 CTAs at C 4096, D 512), each range's partial
//     written apart and summed in range order by a small launch;
//     (3) dW (+)= x^T dlogits, accumulated in f32 across the chunks in
//     chunk order.  Every output element is summed by one thread in a
//     fixed order: no atomics, the same bits on every run.
// Memory: the workspace of the backward holds W split (2 x 4 D V bytes),
// the chunk's x split, dlogits split (8 C V bytes: 1.05 GB at C 4096,
// V 32000, twice an f32 scratch) and the dx partials; the forward's holds
// x and W split and the shares' partial states.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"

namespace {

using namespace ptt_gemm;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kWaves = 4;   // CTAs aimed at per SM (one fits), forward and dx

// two names for one pre-pass, so a profile tells forward from backward
__global__ void lm_head_fwd_split_kernel(const float* __restrict__ src,
                                         float2* __restrict__ dst,
                                         long long n) {
  split_range(src, dst, n);
}

__global__ void lm_head_bwd_split_kernel(const float* __restrict__ src,
                                         float2* __restrict__ dst,
                                         long long n) {
  split_range(src, dst, n);
}

template <class K>
cudaError_t launch_split(K kernel, const float* src, float2* dst,
                         long long n, cudaStream_t s) {
  kernel<<<pass_blocks(n), 256, 0, s>>>(src, dst, n);
  return cudaGetLastError();
}

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
    lm_head_fwd_kernel(const Operand X, const Operand W,
                       const long long* __restrict__ labels,
                       float* __restrict__ part, int N, int D, int V,
                       int tiles_per_share) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
  const int m0 = blockIdx.x * kBM;
  const int nt = (V + kBN - 1) / kBN;
  const int first = blockIdx.y * tiles_per_share;
  const int count = min(tiles_per_share, nt - first);

  // this thread's rows: wm + 16 i + g + 8 h
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
__global__ void lm_head_fwd_merge_kernel(const float* __restrict__ part,
                                         const long long* __restrict__ labels,
                                         float* __restrict__ loss,
                                         float* __restrict__ lse, int N,
                                         int S) {
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

// dl[r, c] = (exp(x_r . w_c - lse_r) - [c == y_r]) * g_r for one chunk,
// written as (hi, lo) pairs
__global__ void __launch_bounds__(kThreads, 1)
    lm_head_bwd_dlogits_kernel(const Operand X, const Operand W,
                               const long long* __restrict__ labels,
                               const float* __restrict__ lse,
                               const float* __restrict__ gm,
                               float2* __restrict__ dl, int C, int D,
                               int V) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
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
            const long long row = (long long)r * V;
#pragma unroll
            for (int j = 0; j < kNJ; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int c = n + wn + 8 * j + 2 * t + e;
                if (c >= V) continue;
                const float v =
                    (exp2f((acc.v[i][j][2 * h + e] - ls) * kLog2e) -
                     (c == y ? 1.f : 0.f)) * gr;
                uint32_t hi, lo;
                split(v, hi, lo);
                dl[row + c] =
                    make_float2(__uint_as_float(hi), __uint_as_float(lo));
              }
          }
      });
}

// out [M, N] (row stride ldo) = A . B over k in this CTA's range
// [z kchunk, min(K, (z + 1) kchunk)), at out + z zstride; added to out's
// old value when accumulate
template <bool AK, bool BN>
__global__ void __launch_bounds__(kThreads, 1)
    lm_head_bwd_gemm_kernel(const Operand A, const Operand B,
                            float* __restrict__ out, long long ldo,
                            long long zstride, int M, int N, int K,
                            int kchunk, int accumulate) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
  const int m0 = blockIdx.y * kBM;
  const int kb = blockIdx.z * kchunk, ke = min(K, kb + kchunk);
  float* o = out + blockIdx.z * zstride;
  run_tiles<AK, BN>(
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
                if (c < N)
                  row[c] = accumulate ? row[c] + acc.v[i][j][2 * h + e]
                                      : acc.v[i][j][2 * h + e];
              }
          }
      });
}

// out[i] = sum over z < S of part[z n + i], in z order
__global__ void lm_head_bwd_reduce_kernel(const float* __restrict__ part,
                                          float* __restrict__ out,
                                          long long n, int S) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float s = part[i];
    for (int z = 1; z < S; ++z) s += part[z * n + i];
    out[i] = s;
  }
}

// the forward's vocabulary shares: tiles per share and the share count
void fwd_plan(int N, int V, int& per, int& shares) {
  const int mt = cdiv(N, kBM), nt = cdiv(V, kBN);
  int s = cdiv((long long)kWaves * sm_count(), mt);
  s = s < 1 ? 1 : (s > nt ? nt : s);
  per = cdiv(nt, s);
  shares = cdiv(nt, per);
}

// byte offsets of the forward's workspace regions: x and W split, the
// shares' partial states, and the total
struct FwdWork {
  long long x2, w2, part, bytes;
};

FwdWork fwd_work(int N, int D, int V) {
  int per, shares;
  fwd_plan(N, V, per, shares);
  FwdWork w;
  w.x2 = 0;
  w.w2 = w.x2 + align256(8LL * N * D);
  w.part = w.w2 + align256(8LL * D * V);
  w.bytes = w.part + align256(12LL * shares * N);
  return w;
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
// C rows: W split, the chunk's x split, dlogits split, the dx partials
// ([ranges][C][D] f32, only when ranges > 1), and the total
struct BwdWork {
  long long w2, x2, dl2, dxp, bytes;
};

BwdWork bwd_work(int C, int D, int V) {
  int kchunk, ranges;
  dx_plan(C, D, V, kchunk, ranges);
  BwdWork w;
  w.w2 = 0;
  w.x2 = w.w2 + align256(8LL * D * V);
  w.dl2 = w.x2 + align256(8LL * C * D);
  w.dxp = w.dl2 + align256(8LL * C * V);
  w.bytes = w.dxp + (ranges > 1 ? align256(4LL * ranges * C * D) : 0);
  return w;
}

}  // namespace

// Workspace bytes of ptt_lm_head_fwd at these sizes.
extern "C" long long ptt_lm_head_fwd_workspace(int N, int D, int V) {
  return fwd_work(N, D, V).bytes;
}

// x [N, D], w [D, V] f32, labels [N] int64 -> loss [N], lse [N] f32; all
// contiguous; work holds ptt_lm_head_fwd_workspace(N, D, V) bytes, 256-byte
// aligned.  Four launches: split x, split W, the product with its running
// softmax, the merge of the vocabulary shares.  Returns a cudaError_t as
// int.
extern "C" int ptt_lm_head_fwd(const void* x, const void* w,
                               const void* labels, void* loss, void* lse,
                               void* work, int N, int D, int V,
                               void* stream) {
  if (N <= 0 || D <= 0 || V <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int per, shares;
  fwd_plan(N, V, per, shares);
  const FwdWork off = fwd_work(N, D, V);
  char* base = static_cast<char*>(work);
  float2* x2 = reinterpret_cast<float2*>(base + off.x2);
  float2* w2 = reinterpret_cast<float2*>(base + off.w2);
  float* part = reinterpret_cast<float*>(base + off.part);
  const long long* y = static_cast<const long long*>(labels);
  cudaError_t err = launch_split(lm_head_fwd_split_kernel,
                                 static_cast<const float*>(x), x2,
                                 (long long)N * D, s);
  if (err != cudaSuccess) return (int)err;
  err = launch_split(lm_head_fwd_split_kernel, static_cast<const float*>(w),
                     w2, (long long)D * V, s);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem<true, true>(lm_head_fwd_kernel);
  if (err != cudaSuccess) return (int)err;
  lm_head_fwd_kernel<<<dim3(cdiv(N, kBM), shares), kThreads,
                       Layout<true, true>::kSmemBytes, s>>>(
      operand(x2, D), operand(w2, V), y, part, N, D, V, per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lm_head_fwd_merge_kernel<<<cdiv(N, 256), 256, 0, s>>>(
      part, y, static_cast<float*>(loss), static_cast<float*>(lse), N,
      shares);
  return (int)cudaGetLastError();
}

// Workspace bytes of ptt_lm_head_bwd_chunk for chunks of at most C rows.
extern "C" long long ptt_lm_head_bwd_workspace(int C, int D, int V) {
  return bwd_work(C, D, V).bytes;
}

// One token chunk of the backward: x, labels, lse and g point at the
// chunk's first row (rows rows, at most cap, the chunk size the workspace
// was sized for); dx points at the chunk's rows of [N, D]; dw [D, V] is
// overwritten (accumulate 0, the first chunk) or added to.  The first chunk
// also splits W into the workspace, which the later chunks read.  All f32
// and contiguous, labels int64; work holds ptt_lm_head_bwd_workspace(cap,
// D, V) bytes, 256-byte aligned, and is kept between the chunks of one
// backward.  Returns a cudaError_t as int.
extern "C" int ptt_lm_head_bwd_chunk(const void* x, const void* w,
                                     const void* labels, const void* lse,
                                     const void* g, void* work, void* dx,
                                     void* dw, int rows, int cap, int D,
                                     int V, int accumulate, void* stream) {
  if (rows <= 0 || rows > cap || D <= 0 || V <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int kchunk, ranges;
  dx_plan(cap, D, V, kchunk, ranges);
  const BwdWork off = bwd_work(cap, D, V);
  char* base = static_cast<char*>(work);
  float2* w2 = reinterpret_cast<float2*>(base + off.w2);
  float2* x2 = reinterpret_cast<float2*>(base + off.x2);
  float2* dl2 = reinterpret_cast<float2*>(base + off.dl2);
  float* dxp = reinterpret_cast<float*>(base + off.dxp);
  float* dxf = static_cast<float*>(dx);
  cudaError_t err;
  if (!accumulate) {
    err = launch_split(lm_head_bwd_split_kernel, static_cast<const float*>(w),
                       w2, (long long)D * V, s);
    if (err != cudaSuccess) return (int)err;
  }
  err = launch_split(lm_head_bwd_split_kernel, static_cast<const float*>(x),
                     x2, (long long)rows * D, s);
  if (err != cudaSuccess) return (int)err;

  // (1) dlogits [rows, V], split
  err = allow_smem<true, true>(lm_head_bwd_dlogits_kernel);
  if (err != cudaSuccess) return (int)err;
  lm_head_bwd_dlogits_kernel<<<dim3(cdiv(V, kBN), cdiv(rows, kBM)), kThreads,
                               Layout<true, true>::kSmemBytes, s>>>(
      operand(x2, D), operand(w2, V), static_cast<const long long*>(labels),
      static_cast<const float*>(lse), static_cast<const float*>(g), dl2,
      rows, D, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  // (2) dx [rows, D] = dlogits [rows, V] . W^T, where W^T (v, d) is
  // w2[d V + v]: k-contiguous rows of V pairs
  auto dxk = lm_head_bwd_gemm_kernel<true, false>;
  err = allow_smem<true, false>(dxk);
  if (err != cudaSuccess) return (int)err;
  dxk<<<dim3(cdiv(D, kBN), cdiv(rows, kBM), ranges), kThreads,
        Layout<true, false>::kSmemBytes, s>>>(
      operand(dl2, V), operand(w2, V), ranges > 1 ? dxp : dxf, D,
      (long long)rows * D, rows, D, V, kchunk, 0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (ranges > 1) {
    const long long n = (long long)rows * D;
    lm_head_bwd_reduce_kernel<<<pass_blocks(n), 256, 0, s>>>(dxp, dxf, n,
                                                            ranges);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  // (3) dW [D, V] (+)= x^T [D, rows] . dlogits [rows, V], where x^T (d, c)
  // is x2[c D + d]: m-contiguous rows of D pairs
  auto dwk = lm_head_bwd_gemm_kernel<false, true>;
  err = allow_smem<false, true>(dwk);
  if (err != cudaSuccess) return (int)err;
  dwk<<<dim3(cdiv(V, kBN), cdiv(D, kBM), 1), kThreads,
        Layout<false, true>::kSmemBytes, s>>>(
      operand(x2, D), operand(dl2, V), static_cast<float*>(dw), V, 0, D, V,
      rows, rows, accumulate);
  return (int)cudaGetLastError();
}
