// Fused pre-norm transformer block forward for Hopper (sm_90a), on the TF32
// tensor cores in three passes (3xTF32).
//
// Replaces the Pallas TPU kernel
// paddle_tpu/kernels/fused_block.py:_block_fwd_pallas (body _block_kernel).
// x [B, T, D] f32, N = B*T token rows:
//   a = LN1(x);  q, k, v = a Wq, a Wk, a Wv          (Wq/Wk/Wv [D, E])
//   o = softmax(q k^T / sqrt(dh) + mask) v per head   (dh = E / H)
//   h = x + o Wo;  f = LN2(h);  u = relu(f W1 + b1);  out = h + (u W2 + b2)
// Every product is computed here: the four projections by gemm_tc.cuh's
// tile loop, the attention by flash_attention_hdt.cu's kernel, the norms by
// layer_norm.cu's; no library computes any of them.
//
// Bound on the H100: operations.  2 N D (3E) + 2 N E D + 4 N D F FLOP of
// projections (103.08 GFLOP at N 16384, D = E 512, F 2048) plus the causal
// attention (8.61 GFLOP at B 32, T 512, H 8).  Every product runs on the
// TF32 tensor cores in three passes (three TF32 products for each f32
// one, f32-grade), so the bound is 3 x 111.69 GFLOP at 495 TFLOP/s =
// 0.677 ms; x, the 12.6 MB of weights and out move once (80 MB, 0.024 ms).
//
// Design.  The Pallas kernel keeps one query block's whole block in VMEM and
// recomputes LN1 and the K/V projections for every (query block, key block)
// pair; on Hopper no SM's 227 KB holds the 12.6 MB of weights, and that
// recompute buys nothing.  So the entry below runs a fixed chain of nine
// launches, each reading its token rows from device memory once:
//   1. split the weights into (hi, lo) pairs: [Wq|Wk|Wv] as one [D, 3E]
//      matrix, Wo, W1, W2 (one launch; once per call, since the optimizer
//      changes them every step)
//   2. LN1(x) -> a [N, D], as pairs          (layer_norm.cu's row kernel)
//   3. a [Wq|Wk|Wv] -> qkv [N, 3E] f32, q times 1/sqrt(dh)
//   4. flash attention reading q, k and v out of qkv through strides as
//      [B, T, H, dh] views, writing o [N, E] f32 the same way
//   5. o -> pairs                             (an elementwise pass)
//   6. o Wo + x -> h [N, D] f32
//   7. LN2(h) -> a, as pairs
//   8. relu(a W1 + b1) -> u [N, F], as pairs
//   9. u W2 + b2 + h -> out
// The four products are one kernel, block_gemm_kernel, on gemm_tc.cuh's
// run_tiles (128 x 128 CTA tiles of 8 warps, k-tiles of 32 in a 3-stage
// cp.async ring, one CTA an SM), with an epilogue per step.  The loop
// reads pre-split operands, so each operand is written as pairs where it
// is produced: the weights by step 1, the norms' outputs by the norm
// kernel, u by the W1 product's epilogue.  o is split by a pass of its own
// (32 MiB in, 64 MiB out at the training shape, about 0.03 ms): the flash
// kernels also serve the head-major and [B, H, T, d] calls, and a pair
// epilogue there would add a branch to every one of those paths to save
// that pass.  Each k-tile's products go to an accumulator that is added to
// a second one by f32 adds (gemm_tc.cuh): W2's k loop is 2048 long, and the
// tensor cores truncate as they accumulate.  Every output element is
// summed by one thread in a fixed order: no atomics, the same bits on every
// run.  Each operand's row length and address decide its copy path
// (16-byte copies of two pairs, or 8-byte ones for an odd D, E or F), so
// any shape the wrapper takes works.
//
// Workspace (the caller allocates ptt_transformer_block_fwd_workspace
// bytes): the weights' pairs, a as pairs [N, D], qkv [N, 3E] (whose room
// o's pairs [N, E] take once the flash kernel has read it), o [N, E],
// h [N, D], u as pairs [N, F], mean and rstd [N], lse [B, H, T]: 505 MiB
// at the training shape.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tc.cuh"

extern "C" int ptt_layer_norm_fwd_pairs(const void* x, const void* gamma,
                                        const void* beta, void* y2,
                                        void* mean, void* rstd, int N, int D,
                                        float eps, void* stream);
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int H, int D, int B, int Tq,
                             int Tk, int kv_len, int causal, float scale,
                             const long long* strides, void* stream);

namespace {

using namespace ptt_gemm;

// the six weights and where their pairs go: wq, wk, wv into the columns
// [0, E), [E, 2E), [2E, 3E) of qkv2 [D, 3E]; wo, w1, w2 as they are
struct Weights {
  const float* src[6];   // wq, wk, wv [D, E], wo [E, D], w1 [D, F], w2 [F, D]
  float2* qkv2;
  float2* dst[3];        // wo2, w12, w22
  long long n[6];        // elements of each
  int E;
};

// blockIdx.y picks the weight
__global__ void block_split_weights_kernel(const Weights w) {
  const int z = blockIdx.y;
  const float* __restrict__ src = w.src[z];
  const long long n = w.n[z];
  if (z >= 3) {
    split_range(src, w.dst[z - 3], n);
    return;
  }
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const long long r = i / w.E, c = i - r * w.E;
    uint32_t hi, lo;
    split(src[i], hi, lo);
    w.qkv2[r * 3 * w.E + z * w.E + c] =
        make_float2(__uint_as_float(hi), __uint_as_float(lo));
  }
}

__global__ void block_split_kernel(const float* __restrict__ src,
                                   float2* __restrict__ dst, long long n) {
  split_range(src, dst, n);
}

// epilogue of a block GEMM on acc = (A . B)[r, c]
enum Epilogue : int {
  kQKV = 0,         // y[r, c] = acc, times qscale for c < qcols (q)
  kResid = 1,       // y[r, c] = resid[r, c] + acc
  kBiasReluPairs = 2,  // y2[r, c] = split(max(acc + bias[c], 0))
  kBiasResid = 3,   // y[r, c] = resid[r, c] + (acc + bias[c])
};

// where an epilogue writes, with what: y (f32) or y2 (pairs) and resid
// [M, ld]; vec: ld even and every base 16-byte aligned, so the two
// neighbouring columns of a thread go by one 8-byte (f32) or 16-byte
// (pairs) access
struct Out {
  float* y;
  float2* y2;
  const float* resid;
  const float* bias;
  long long ld;
  float qscale;
  int qcols;
  int vec;
};

template <int EPI>
__device__ __forceinline__ float epi_value(const Out& o, long long at, int c,
                                           float a) {
  if constexpr (EPI == kQKV) return c < o.qcols ? a * o.qscale : a;
  if constexpr (EPI == kResid) return o.resid[at] + a;
  if constexpr (EPI == kBiasReluPairs) return fmaxf(a + o.bias[c], 0.f);
  return o.resid[at] + (a + o.bias[c]);
}

__device__ __forceinline__ float2 pair(float v) {
  uint32_t hi, lo;
  split(v, hi, lo);
  return make_float2(__uint_as_float(hi), __uint_as_float(lo));
}

// y = epilogue(A [M, K] . B [K, N]) on the tile loop; one output tile a CTA
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    block_gemm_kernel(const Operand A, const Operand B, const Out o, int M,
                      int N, int K) {
  extern __shared__ float4 smem4[];
  float2* smem = reinterpret_cast<float2*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
  const int m0 = blockIdx.y * kBM;
  run_tiles<true, true>(
      A, B, M, N, 0, K, m0, blockIdx.x * kBN, 1, smem,
      [&](const Acc& acc, int n) {
#pragma unroll
        for (int i = 0; i < kMI; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = m0 + wm + 16 * i + g + 8 * h;
            if (r >= M) continue;
#pragma unroll
            for (int j = 0; j < kNJ; ++j) {
              const int c = n + wn + 8 * j + 2 * t;   // even
              if (c >= N) continue;
              const long long at = r * o.ld + c;
              const float v0 = epi_value<EPI>(o, at, c, acc.v[i][j][2 * h]);
              if (c + 1 >= N) {
                if constexpr (EPI == kBiasReluPairs)
                  o.y2[at] = pair(v0);
                else
                  o.y[at] = v0;
                continue;
              }
              const float v1 =
                  epi_value<EPI>(o, at + 1, c + 1, acc.v[i][j][2 * h + 1]);
              if constexpr (EPI == kBiasReluPairs) {
                const float2 p0 = pair(v0), p1 = pair(v1);
                if (o.vec) {
                  *reinterpret_cast<float4*>(o.y2 + at) =
                      make_float4(p0.x, p0.y, p1.x, p1.y);
                } else {
                  o.y2[at] = p0;
                  o.y2[at + 1] = p1;
                }
              } else if (o.vec) {
                *reinterpret_cast<float2*>(o.y + at) = make_float2(v0, v1);
              } else {
                o.y[at] = v0;
                o.y[at + 1] = v1;
              }
            }
          }
      });
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// y [M, N] = epilogue(A [M, K] . B [K, N]), A and B as pairs, all
// row-major; o.ld is N
template <int EPI>
cudaError_t gemm(const float2* A, const float2* B, Out o, int M, int N,
                 int K, cudaStream_t s) {
  auto kernel = block_gemm_kernel<EPI>;
  cudaError_t err = allow_smem<true, true>(kernel);
  if (err != cudaSuccess) return err;
  o.ld = N;
  o.vec = N % 2 == 0 && aligned16(o.y) && aligned16(o.y2) &&
          aligned16(o.resid);
  kernel<<<dim3(cdiv(N, kBN), cdiv(M, kBM)), kThreads,
           Layout<true, true>::kSmemBytes, s>>>(operand(A, K), operand(B, N),
                                                o, M, N, K);
  return cudaGetLastError();
}

// byte offsets of the workspace regions, and the total
struct Work {
  long long qkv2, wo2, w12, w22, a2, qkv, o, h, u2, mean, rstd, lse, bytes;
};

Work work(int B, int T, int D, int E, int F, int H) {
  const long long N = (long long)B * T;
  Work w;
  w.qkv2 = 0;
  w.wo2 = w.qkv2 + align256(8LL * D * 3 * E);
  w.w12 = w.wo2 + align256(8LL * E * D);
  w.w22 = w.w12 + align256(8LL * D * F);
  w.a2 = w.w22 + align256(8LL * F * D);
  w.qkv = w.a2 + align256(8 * N * D);
  w.o = w.qkv + align256(4 * N * 3 * E);   // o's pairs later take qkv's room
  w.h = w.o + align256(4 * N * E);
  w.u2 = w.h + align256(4 * N * D);
  w.mean = w.u2 + align256(8 * N * F);
  w.rstd = w.mean + align256(4 * N);
  w.lse = w.rstd + align256(4 * N);
  w.bytes = w.lse + align256(4 * N * H);
  return w;
}

}  // namespace

// Workspace bytes of ptt_transformer_block_fwd at these sizes.
extern "C" long long ptt_transformer_block_fwd_workspace(int B, int T, int D,
                                                         int E, int F,
                                                         int H) {
  return work(B, T, D, E, F, H).bytes;
}

// One block forward; every tensor f32 and contiguous: x and out [B, T, D],
// ln1g, ln1b, ln2g, ln2b and b2 [D], wq, wk, wv [D, E], wo [E, D], w1 [D, F],
// b1 [F], w2 [F, D]; ws holds ptt_transformer_block_fwd_workspace(B, T, D,
// E, F, H) bytes, 256-byte aligned.  E / H is 64 or 128 and D <= 8192.
// Nine launches on `stream`.  Returns a cudaError_t as int.
extern "C" int ptt_transformer_block_fwd(
    const void* x, const void* ln1g, const void* ln1b, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* ln2g,
    const void* ln2b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, void* ws, int B, int T, int D, int E, int F,
    int H, int causal, float eps1, float eps2, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || F <= 0 || H <= 0 || E <= 0 || E % H)
    return (int)cudaErrorInvalidValue;
  const int N = B * T, dh = E / H;
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Work off = work(B, T, D, E, F, H);
  char* base = static_cast<char*>(ws);
  float2* qkv2 = reinterpret_cast<float2*>(base + off.qkv2);
  float2* wo2 = reinterpret_cast<float2*>(base + off.wo2);
  float2* w12 = reinterpret_cast<float2*>(base + off.w12);
  float2* w22 = reinterpret_cast<float2*>(base + off.w22);
  float2* a2 = reinterpret_cast<float2*>(base + off.a2);
  float* qkv = reinterpret_cast<float*>(base + off.qkv);
  float2* o2 = reinterpret_cast<float2*>(base + off.qkv);
  float* of = reinterpret_cast<float*>(base + off.o);
  float* hf = reinterpret_cast<float*>(base + off.h);
  float2* u2 = reinterpret_cast<float2*>(base + off.u2);
  float* mean = reinterpret_cast<float*>(base + off.mean);
  float* rstd = reinterpret_cast<float*>(base + off.rstd);
  float* lse = reinterpret_cast<float*>(base + off.lse);
  const float* xf = static_cast<const float*>(x);

  // 1. the weights' pairs
  using cf = const float*;
  const Weights w{{static_cast<cf>(wq), static_cast<cf>(wk),
                   static_cast<cf>(wv), static_cast<cf>(wo),
                   static_cast<cf>(w1), static_cast<cf>(w2)},
                  qkv2,
                  {wo2, w12, w22},
                  {(long long)D * E, (long long)D * E, (long long)D * E,
                   (long long)E * D, (long long)D * F, (long long)F * D},
                  E};
  const long long most = (long long)D * (E > F ? E : F);
  block_split_weights_kernel<<<dim3(pass_blocks(most), 6), 256, 0, s>>>(w);
  int err = (int)cudaGetLastError();
  if (err) return err;
  // 2. LN1
  err = ptt_layer_norm_fwd_pairs(x, ln1g, ln1b, a2, mean, rstd, N, D, eps1,
                                 stream);
  if (err) return err;
  // 3. q, k, v
  err = (int)gemm<kQKV>(a2, qkv2,
                        Out{qkv, nullptr, nullptr, nullptr, 0,
                            1.f / sqrtf((float)dh), E, 0},
                        N, 3 * E, D, s);
  if (err) return err;
  // 4. attention: q, k, v as [B, T, H, dh] views of qkv, o as one of
  // [N, E]: (batch, head, feature, token) strides; lse [B, H, T]
  const long long tq = 3LL * E, to = E;
  const long long strides[18] = {
      T * tq, dh, 1, tq,  T * tq, dh, 1, tq,  T * tq, dh, 1, tq,
      T * to, dh, 1, to,  (long long)H * T, T};
  err = ptt_flash_fwd(qkv, qkv + E, qkv + 2 * E, of, lse, H, dh, B, T, T, T,
                      causal, 1.f, strides, stream);
  if (err) return err;
  // 5. o's pairs, where qkv was
  const long long no = (long long)N * E;
  block_split_kernel<<<pass_blocks(no), 256, 0, s>>>(of, o2, no);
  err = (int)cudaGetLastError();
  if (err) return err;
  // 6. h = x + o Wo
  err = (int)gemm<kResid>(o2, wo2,
                          Out{hf, nullptr, xf, nullptr, 0, 1.f, 0, 0}, N, D,
                          E, s);
  if (err) return err;
  // 7. LN2
  err = ptt_layer_norm_fwd_pairs(hf, ln2g, ln2b, a2, mean, rstd, N, D, eps2,
                                 stream);
  if (err) return err;
  // 8. u = relu(a W1 + b1), as pairs
  err = (int)gemm<kBiasReluPairs>(
      a2, w12,
      Out{nullptr, u2, nullptr, static_cast<const float*>(b1), 0, 1.f, 0, 0},
      N, F, D, s);
  if (err) return err;
  // 9. out = h + (u W2 + b2)
  return (int)gemm<kBiasResid>(
      u2, w22,
      Out{static_cast<float*>(out), nullptr, hf,
          static_cast<const float*>(b2), 0, 1.f, 0, 0},
      N, D, F, s);
}
