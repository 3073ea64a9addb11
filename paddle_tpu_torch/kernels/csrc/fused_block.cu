// Fused pre-norm transformer block forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// paddle_tpu/kernels/fused_block.py:_block_fwd_pallas (body _block_kernel).
// x [B, T, D] f32, N = B*T token rows:
//   a = LN1(x);  q, k, v = a Wq, a Wk, a Wv          (Wq/Wk/Wv [D, E])
//   o = softmax(q k^T / sqrt(dh) + mask) v per head   (dh = E / H)
//   h = x + o Wo;  f = LN2(h);  u = relu(f W1 + b1);  out = h + (u W2 + b2)
// Every product is computed here: the GEMMs by gemm_f32.cuh's tile loop,
// the attention by flash_attention_hdt.cu's kernel, the norms by
// layer_norm.cu's; no library computes any of them.
//
// Bound on the H100: operations.  2 N D (3E) + 2 N E D + 4 N D F FLOP of
// projections (103 GFLOP at N 16384, D = E 512, F 2048) plus the causal
// attention (8.6 GFLOP at B 32, T 512, H 8), counted at the f32 CUDA cores'
// 67 TFLOP/s, on which the GEMMs run (the attention takes its products on
// the TF32 tensor cores in three passes); x, the 12.6 MB of weights and out
// move once.
//
// Design (simple first).  The Pallas kernel keeps one query block's whole
// block in VMEM and recomputes LN1 and the K/V projections for every
// (query block, key block) pair; on Hopper no SM's 227 KB holds the 12.6 MB
// of weights, and that recompute (about 4.5x the K/V work at T 512) buys
// nothing.  So the entry below runs a fixed chain of seven launches, each
// reading its token rows from device memory once:
//   1. LN1(x) -> a [N, D]                      (layer_norm.cu's kernel)
//   2. a [Wq|Wk|Wv] -> qkv [N, 3E], q times 1/sqrt(dh)   (one launch, the
//      grid's z picks the weight)
//   3. flash attention reading q, k and v out of qkv through strides as
//      [B, T, H, dh] views, writing o [N, E] the same way
//   4. o Wo + x -> h [N, D]
//   5. LN2(h) -> a (the buffer of step 1)
//   6. relu(a W1 + b1) -> u [N, F]
//   7. u W2 + b2 + h -> out
// The GEMMs are gemm_f32.cuh's 128 x 128 tile loop with an epilogue per
// step.  Scratch (the caller allocates it): a, h [N, D], qkv [N, 3E],
// o [N, E], u [N, F], mean and rstd [N], lse [B, H, T].  Fusing the chain
// into fewer launches (LN into the GEMM prologue, flash with Wo) is later
// work.
#include <cuda_runtime.h>

#include "gemm_f32.cuh"

extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int N, int D, float eps,
                                  int is_bf16, void* stream);
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int H, int D, int B, int Tq,
                             int Tk, int kv_len, int causal, float scale,
                             const long long* strides, void* stream);

namespace {

// epilogue of a block GEMM; acc = (A . B)[r, c]
enum Epilogue : int {
  kQKV = 0,        // C[r, z*N + c] = acc, times qscale for z == 0 (q)
  kResid = 1,      // C[r, c] = resid[r, c] + acc
  kBiasRelu = 2,   // C[r, c] = max(acc + bias[c], 0)
  kBiasResid = 3,  // C[r, c] = resid[r, c] + (acc + bias[c])
};

template <int EPI>
__global__ void __launch_bounds__(NT)
    block_gemm_kernel(const Mat A, const Mat B0, const Mat B1, const Mat B2,
                      float* __restrict__ C, long long ldc, int M, int N,
                      int K, const float* __restrict__ bias,
                      const float* __restrict__ resid, long long ldr,
                      float qscale) {
  __shared__ __align__(16) float As[BK * AS];
  __shared__ __align__(16) float Bs[BK * BS];
  const int tr = threadIdx.x / (BN / TN), tc = threadIdx.x % (BN / TN);
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM, z = blockIdx.z;
  const Mat B = z == 0 ? B0 : (z == 1 ? B1 : B2);
  float acc[TM][TN];
  tile_product(A, B, M, N, K, m0, n0, acc, As, Bs);
  const float mul = (EPI == kQKV && z == 0) ? qscale : 1.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = m0 + split_idx(tr, i);
    if (r >= M) continue;
    float* row = C + (long long)r * ldc + (long long)z * N;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = n0 + split_idx(tc, j);
      if (c >= N) continue;
      const float a = acc[i][j];
      if constexpr (EPI == kQKV) {
        row[c] = a * mul;
      } else if constexpr (EPI == kResid) {
        row[c] = resid[(long long)r * ldr + c] + a;
      } else if constexpr (EPI == kBiasRelu) {
        row[c] = fmaxf(a + bias[c], 0.f);
      } else {
        row[c] = resid[(long long)r * ldr + c] + (a + bias[c]);
      }
    }
  }
}

// C [M, N per z] = epilogue(A [M, K] . B_z [K, N]), all row-major.
template <int EPI>
int gemm(const float* A, const float* B0, const float* B1, const float* B2,
         int nz, float* C, long long ldc, int M, int N, int K,
         const float* bias, const float* resid, long long ldr, float qscale,
         cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, nz);
  block_gemm_kernel<EPI><<<grid, NT, 0, s>>>(
      Mat{A, K, 1}, Mat{B0, N, 1}, Mat{B1, N, 1}, Mat{B2, N, 1}, C, ldc, M,
      N, K, bias, resid, ldr, qscale);
  return (int)cudaGetLastError();
}

}  // namespace

// One block forward; every tensor f32 and contiguous: x and out [B, T, D],
// ln1g, ln1b, ln2g, ln2b and b2 [D], wq, wk, wv [D, E], wo [E, D], w1 [D, F],
// b1 [F], w2 [F, D]; scratch a and h [N, D], qkv [N, 3E], o [N, E], u [N, F],
// mean and rstd [N], lse [B, H, T], with N = B*T.  E / H is 64 or 128 and
// D <= 8192.  Seven launches on `stream`.  Returns a cudaError_t as int.
extern "C" int ptt_transformer_block_fwd(
    const void* x, const void* ln1g, const void* ln1b, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* ln2g,
    const void* ln2b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, void* a, void* qkv, void* o, void* h, void* u,
    void* mean, void* rstd, void* lse, int B, int T, int D, int E, int F,
    int H, int causal, float eps1, float eps2, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || F <= 0 || H <= 0 || E % H)
    return (int)cudaErrorInvalidValue;
  const int N = B * T, dh = E / H;
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* af = static_cast<float*>(a);
  float* qkvf = static_cast<float*>(qkv);
  float* of = static_cast<float*>(o);
  float* hf = static_cast<float*>(h);
  float* uf = static_cast<float*>(u);
  int err = ptt_layer_norm_fwd(x, ln1g, ln1b, a, mean, rstd, N, D, eps1, 0,
                               stream);
  if (err) return err;
  err = gemm<kQKV>(af, static_cast<const float*>(wq),
                   static_cast<const float*>(wk),
                   static_cast<const float*>(wv), 3, qkvf, 3LL * E, N, E, D,
                   nullptr, nullptr, 0, 1.f / sqrtf((float)dh), s);
  if (err) return err;
  // q, k, v as [B, T, H, dh] views of qkv, o as one of [N, E]: (batch,
  // head, feature, token) strides; lse [B, H, T]
  const long long tq = 3LL * E, to = E;
  const long long strides[18] = {
      T * tq, dh, 1, tq,  T * tq, dh, 1, tq,  T * tq, dh, 1, tq,
      T * to, dh, 1, to,  (long long)H * T, T};
  err = ptt_flash_fwd(qkvf, qkvf + E, qkvf + 2 * E, of, lse, H, dh, B, T, T,
                      T, causal, 1.f, strides, stream);
  if (err) return err;
  err = gemm<kResid>(of, static_cast<const float*>(wo), nullptr, nullptr, 1,
                     hf, D, N, D, E, nullptr, xf, D, 1.f, s);
  if (err) return err;
  err = ptt_layer_norm_fwd(h, ln2g, ln2b, a, mean, rstd, N, D, eps2, 0,
                           stream);
  if (err) return err;
  err = gemm<kBiasRelu>(af, static_cast<const float*>(w1), nullptr, nullptr,
                        1, uf, F, N, F, D, static_cast<const float*>(b1),
                        nullptr, 0, 1.f, s);
  if (err) return err;
  return gemm<kBiasResid>(uf, static_cast<const float*>(w2), nullptr, nullptr,
                          1, static_cast<float*>(out), D, N, D, F,
                          static_cast<const float*>(b2), hf, D, 1.f, s);
}
