// Fused pre-norm transformer block forward in bf16 for Hopper (sm_90a), on
// the bf16 tensor cores: the block kernel of the fuse_block program under
// FLAGS_amp_bf16.
//
// Replaces the Pallas TPU kernel
// paddle_tpu/kernels/fused_block.py:_block_fwd_pallas (body _block_kernel)
// as it runs on the bf16 x and matrices that fused_transformer_block hands
// it under AMP; the layer norms' scales and biases and b1, b2 stay f32.
// x [B, T, D] bf16, N = B*T token rows, dh = E / H, scale = 1/sqrt(dh):
//   a = bf16(LN1(x))                                (f32 statistics)
//   q = bf16(f32(a Wq) * scale),  k = bf16(a Wk),  v = bf16(a Wv)
//   o = bf16 flash attention of (q, k, v) with scale 1
//   h = bf16(x + f32(o Wo));   f = bf16(LN2(h))
//   u = bf16(relu(f32(f W1) + b1));   out = bf16(h + (f32(u W2) + b2))
// Every product accumulates in f32 and each result is rounded once, where
// _block_kernel rounds (fused_block.py:131-136, :163, :181-197).  The
// flash kernel (flash_attention_bf16.cu) forms q' = bf16(q * bf16(scale));
// called with scale 1 it keeps q, which is then the Pallas kernel's
// bf16(f32(a Wq) * scale) exactly.  Every product is computed here, on
// gemm_bf16.cuh's tile loop and the flash kernel; no library computes any.
//
// Bound on the H100 at B 32, T 512, D = E 512, F 2048, H 8: operations.
// 111.69 GFLOP (fused_block.cu's count: the four projections and the
// causal attention) at 989 TFLOP/s bf16 dense take 0.113 ms; x, the
// weights in bf16 and out move once (40 MB, 0.012 ms).
//
// Design.  fused_block.cu's chain: no SM holds the weights, so a fixed
// chain of launches, each reading its token rows from device memory once:
//   1. LN1(x) -> a [N, D] bf16               (layer_norm.cu's row kernel)
//   2. a [Wq|Wk|Wv] -> qkv [N, 3E] bf16, q times scale in the epilogue
//   3. flash attention reading q, k and v out of qkv as [B, T, H, dh]
//      views through strides, writing o [N, E] bf16 the same way
//   4. o Wo + x -> h [N, D] bf16
//   5. LN2(h) -> f [N, D] bf16, in a's room
//   6. relu(f W1 + b1) -> u [N, F] bf16
//   7. u W2 + b2 + h -> out
// Seven launches: the tile loop takes bf16 operands as they are, so the
// f32 chain's operand splits (its launches 1 and 5) have no counterpart.
// The four products are one kernel, block_gemm_bf16_kernel<EPI>, on
// run_tiles (128 x 128 CTA tiles of 8 warps, k-tiles of 64 in a 4-stage
// cp.async ring, one m16n8k16 mma.sync per product, each k-tile's products
// flushed into a second f32 accumulator: the tensor cores truncate as they
// accumulate, and W2's k loop is 2048 long).  q, k and v take no
// concatenated weight and no copy: the q/k/v launch has 3 x ceil(E / 128)
// column tiles, and a CTA's column index picks Wq, Wk or Wv and the tile
// within it, so no tile straddles two weights, for any E, and each weight
// is read where it lies (a three-GEMM chain would add two launches for
// the same tiles).  The flash kernel sees feature stride 1 on every
// operand, so it stages token-row tiles by 16-byte cp.async.  Every
// output element is summed by one thread in a fixed order: no atomics, the
// same bits on every run.  An epilogue writes a thread's two neighbouring
// columns by one 4-byte store where rows hold an even number of them;
// operands whose rows are not 16-byte aligned (an odd D, E or F) are
// staged element by element, so any shape the wrapper takes works.
//
// Workspace (the caller allocates ptt_transformer_block_bf16_fwd_workspace
// bytes): a (then f) [N, D], qkv [N, 3E], o [N, E], h [N, D], u [N, F] in
// bf16, mean and rstd [N] and lse [B, H, T] in f32: 161 MiB at the
// training shape (the f32 chain's is 505 MiB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"

extern "C" int ptt_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, void* mean,
                                  void* rstd, int N, int D, float eps,
                                  int is_bf16, void* stream);
extern "C" int ptt_flash_fwd_bf16(const void* q, const void* k,
                                  const void* v, void* o, void* lse, int H,
                                  int D, int B, int Tq, int Tk, int kv_len,
                                  int causal, float scale,
                                  const long long* strides, int path,
                                  void* stream);

namespace {

using ptt_bf16::bf16;
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
using ptt_gemm_bf16::Layout;
using ptt_gemm_bf16::Operand;
using ptt_gemm_bf16::allow_smem;
using ptt_gemm_bf16::operand;
using ptt_gemm_bf16::run_tiles;

// epilogue of a block GEMM on acc = (A . B)[r, c], rounded once to bf16
enum Epilogue : int {
  kQKV = 0,        // y[r, z E + c] = acc, times qscale for z = 0 (q)
  kResid = 1,      // y[r, c] = resid[r, c] + acc
  kBiasRelu = 2,   // y[r, c] = max(acc + bias[c], 0)
  kBiasResid = 3,  // y[r, c] = resid[r, c] + (acc + bias[c])
};

// where an epilogue writes, with what: y and resid [M, ld] bf16, bias f32;
// pair: ld and every column offset even, y and resid 4-byte aligned, so a
// thread's two neighbouring columns go by one 4-byte access
struct Out {
  bf16* y;
  const bf16* resid;
  const float* bias;
  long long ld;
  float qscale;
  int pair;
};

// the B operands: Wq, Wk, Wv for kQKV (blockIdx.x picks one), else w[0]
struct Weights {
  Operand w[3];
};

template <int EPI>
__device__ __forceinline__ float epi_value(const Out& o, float resid, int c,
                                           float a, float mul) {
  if constexpr (EPI == kQKV) return a * mul;
  if constexpr (EPI == kResid) return resid + a;
  if constexpr (EPI == kBiasRelu) return fmaxf(a + o.bias[c], 0.f);
  return resid + (a + o.bias[c]);
}

// y = epilogue(A [M, K] . B [K, N]) on the tile loop; one output tile a
// CTA, blockIdx.x = z * ntiles + the tile's column index in weight z
template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    block_gemm_bf16_kernel(const Operand A, const Weights W, const Out o,
                           int M, int N, int K, int ntiles) {
  constexpr bool kRes = EPI == kResid || EPI == kBiasResid;
  extern __shared__ float4 smem4[];
  bf16* smem = reinterpret_cast<bf16*>(smem4);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / kWarpsN * kWM, wn = warp % kWarpsN * kWN;
  const int m0 = blockIdx.y * kBM;
  const int z = blockIdx.x / ntiles;
  const Operand B = z == 0 ? W.w[0] : (z == 1 ? W.w[1] : W.w[2]);
  const float mul = EPI == kQKV && z == 0 ? o.qscale : 1.f;
  const long long col0 = (long long)z * N;   // weight z's first column in y
  run_tiles<true, true>(
      A, B, M, N, 0, K, m0, (blockIdx.x - z * ntiles) * kBN, 1, smem,
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
              const long long at = r * o.ld + col0 + c;
              if (c + 1 < N && o.pair) {
                float2 res = make_float2(0.f, 0.f);
                if constexpr (kRes)
                  res = __bfloat1622float2(
                      *reinterpret_cast<const __nv_bfloat162*>(o.resid + at));
                *reinterpret_cast<__nv_bfloat162*>(o.y + at) =
                    __floats2bfloat162_rn(
                        epi_value<EPI>(o, res.x, c, acc.v[i][j][2 * h], mul),
                        epi_value<EPI>(o, res.y, c + 1,
                                       acc.v[i][j][2 * h + 1], mul));
                continue;
              }
#pragma unroll
              for (int e = 0; e < 2 && c + e < N; ++e) {
                const float res =
                    kRes ? __bfloat162float(o.resid[at + e]) : 0.f;
                o.y[at + e] = __float2bfloat16_rn(epi_value<EPI>(
                    o, res, c + e, acc.v[i][j][2 * h + e], mul));
              }
            }
          }
      });
}

bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

// y [M, nw N] = epilogue(A [M, K] . [W0 | ... ]) with nw weights [K, N],
// all row-major bf16
template <int EPI>
cudaError_t gemm(const bf16* A, const bf16* const (&w)[3], int nw, Out o,
                 int M, int N, int K, cudaStream_t s) {
  auto kernel = block_gemm_bf16_kernel<EPI>;
  cudaError_t err = allow_smem<true, true>(kernel);
  if (err != cudaSuccess) return err;
  Weights W;
  for (int z = 0; z < 3; ++z) W.w[z] = operand(w[z < nw ? z : 0], N);
  o.ld = (long long)nw * N;
  o.pair = o.ld % 2 == 0 && N % 2 == 0 && aligned4(o.y) &&
           (o.resid == nullptr || aligned4(o.resid));
  const int nt = cdiv(N, kBN);
  kernel<<<dim3(nw * nt, cdiv(M, kBM)), kThreads,
           Layout<true, true>::kSmemBytes, s>>>(operand(A, K), W, o, M, N,
                                                K, nt);
  return cudaGetLastError();
}

// byte offsets of the workspace regions, and the total
struct Work {
  long long a, qkv, o, h, u, mean, rstd, lse, bytes;
};

Work work(int B, int T, int D, int E, int F, int H) {
  const long long N = (long long)B * T;
  Work w;
  w.a = 0;
  w.qkv = w.a + align256(2 * N * D);
  w.o = w.qkv + align256(2 * N * 3 * E);
  w.h = w.o + align256(2 * N * E);
  w.u = w.h + align256(2 * N * D);
  w.mean = w.u + align256(2 * N * F);
  w.rstd = w.mean + align256(4 * N);
  w.lse = w.rstd + align256(4 * N);
  w.bytes = w.lse + align256(4 * N * H);
  return w;
}

}  // namespace

// Workspace bytes of ptt_transformer_block_bf16_fwd at these sizes.
extern "C" long long ptt_transformer_block_bf16_fwd_workspace(int B, int T,
                                                              int D, int E,
                                                              int F, int H) {
  return work(B, T, D, E, F, H).bytes;
}

// One block forward; every tensor contiguous: x and out [B, T, D], wq, wk,
// wv [D, E], wo [E, D], w1 [D, F] and w2 [F, D] bf16; ln1g, ln1b, ln2g,
// ln2b and b2 [D] and b1 [F] f32; ws holds
// ptt_transformer_block_bf16_fwd_workspace(B, T, D, E, F, H) bytes,
// 256-byte aligned.  E / H is 64 or 128 and D <= 8192.  flash_path is step
// 3's path argument of ptt_flash_fwd_bf16 (1 wgmma, 0 mma.sync), chosen by
// the caller from the q, k, v and o views of the workspace
// (kernels/fused_block.py flash_path_in_block).  Seven launches on `stream`.
// Returns a cudaError_t as int.
extern "C" int ptt_transformer_block_bf16_fwd(
    const void* x, const void* ln1g, const void* ln1b, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* ln2g,
    const void* ln2b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, void* ws, int B, int T, int D, int E, int F,
    int H, int causal, float eps1, float eps2, int flash_path, void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || F <= 0 || H <= 0 || E <= 0 || E % H)
    return (int)cudaErrorInvalidValue;
  const int N = B * T, dh = E / H;
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Work off = work(B, T, D, E, F, H);
  char* base = static_cast<char*>(ws);
  bf16* a = reinterpret_cast<bf16*>(base + off.a);
  bf16* qkv = reinterpret_cast<bf16*>(base + off.qkv);
  bf16* o = reinterpret_cast<bf16*>(base + off.o);
  bf16* h = reinterpret_cast<bf16*>(base + off.h);
  bf16* u = reinterpret_cast<bf16*>(base + off.u);
  float* mean = reinterpret_cast<float*>(base + off.mean);
  float* rstd = reinterpret_cast<float*>(base + off.rstd);
  float* lse = reinterpret_cast<float*>(base + off.lse);
  using cb = const bf16*;
  const bf16* xb = static_cast<cb>(x);

  // 1. LN1
  int err = ptt_layer_norm_fwd(x, ln1g, ln1b, a, mean, rstd, N, D, eps1, 1,
                               stream);
  if (err) return err;
  // 2. q, k, v
  const bf16* const wqkv[3] = {static_cast<cb>(wq), static_cast<cb>(wk),
                               static_cast<cb>(wv)};
  err = (int)gemm<kQKV>(a, wqkv, 3,
                        Out{qkv, nullptr, nullptr, 0,
                            1.f / sqrtf((float)dh), 0},
                        N, E, D, s);
  if (err) return err;
  // 3. attention, scale 1 (q carries it): q, k, v as [B, T, H, dh] views
  // of qkv, o as one of [N, E]: (batch, head, feature, token) strides;
  // lse [B, H, T]
  const long long tq = 3LL * E, to = E;
  const long long strides[18] = {
      T * tq, dh, 1, tq,  T * tq, dh, 1, tq,  T * tq, dh, 1, tq,
      T * to, dh, 1, to,  (long long)H * T, T};
  err = ptt_flash_fwd_bf16(qkv, qkv + E, qkv + 2 * E, o, lse, H, dh, B, T,
                           T, T, causal, 1.f, strides, flash_path, stream);
  if (err) return err;
  // 4. h = x + o Wo
  const bf16* const wob[3] = {static_cast<cb>(wo), nullptr, nullptr};
  err = (int)gemm<kResid>(o, wob, 1, Out{h, xb, nullptr, 0, 1.f, 0}, N, D,
                          E, s);
  if (err) return err;
  // 5. LN2, into a's room
  err = ptt_layer_norm_fwd(h, ln2g, ln2b, a, mean, rstd, N, D, eps2, 1,
                           stream);
  if (err) return err;
  // 6. u = relu(f W1 + b1)
  const bf16* const w1b[3] = {static_cast<cb>(w1), nullptr, nullptr};
  err = (int)gemm<kBiasRelu>(
      a, w1b, 1,
      Out{u, nullptr, static_cast<const float*>(b1), 0, 1.f, 0}, N, F, D,
      s);
  if (err) return err;
  // 7. out = h + (u W2 + b2)
  const bf16* const w2b[3] = {static_cast<cb>(w2), nullptr, nullptr};
  return (int)gemm<kBiasResid>(
      u, w2b, 1,
      Out{static_cast<bf16*>(out), h, static_cast<const float*>(b2), 0, 1.f,
          0},
      N, D, F, s);
}
