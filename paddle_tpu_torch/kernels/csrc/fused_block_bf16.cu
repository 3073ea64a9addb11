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
// the four GEMM launches and the flash kernel; no library computes any.
//
// Bound on the H100 at B 32, T 512, D = E 512, F 2048, H 8: operations.
// 111.69 GFLOP (fused_block.cu's count: the four projections and the
// causal attention) at 989 TFLOP/s bf16 dense take 0.113 ms; x, the
// weights in bf16 and out move once (40 MB, 0.012 ms).
//
// Design.  fused_block.cu's chain: no SM holds the weights, so a fixed
// chain of launches, each reading its token rows from device memory once:
//   1. LN1(x) -> a [N, D] bf16               (layer_norm.cu's row kernels:
//      v16 where D % 8 == 0 and x, a 16-byte aligned, else scalar)
//   2. a [Wq|Wk|Wv] -> qkv [N, 3E] bf16, q times scale in the epilogue
//   3. flash attention reading q, k and v out of qkv as [B, T, H, dh]
//      views through strides, writing o [N, E] bf16 the same way
//   4. o Wo + x -> h [N, D] bf16
//   5. LN2(h) -> f [N, D] bf16, in a's room
//   6. relu(f W1 + b1) -> u [N, F] bf16
//   7. u W2 + b2 + h -> out
// Seven launches: the tile loops take bf16 operands as they are, so the
// f32 chain's operand splits (its launches 1 and 5) have no counterpart.
// q, k and v take no concatenated weight and no copy: the q/k/v launch has
// 3 x ceil(E / 128) column tiles a row tile, and a tile's column index
// picks Wq, Wk or Wv and the tile within it, so no tile straddles two
// weights, for any E, and each weight is read where it lies (a three-GEMM
// chain would add two launches for the same tiles).  The flash kernel sees
// feature stride 1 on every operand, so it stages token-row tiles by
// 16-byte cp.async.  Every output element is summed by one thread in a
// fixed order: no atomics, the same bits on every run.
//
// The four products have two paths, chosen on the host before the launch
// (kernels/fused_block.py block_gemm_path; all four take one):
//   - wgmma, where TMA and 16-byte accesses can describe every operand (D,
//     E and F multiples of 8, x, out, the matrices and ws 16-byte
//     aligned): block_gemm_bf16_wg_kernel<EPI> on wgmma_bf16.cuh's pieces
//     (TMA into an mbarrier ring, wgmma m64n128k16, a producer warp and
//     two consumer warpgroups that take alternate 128 x 128 tiles of a
//     persistent CTA and issue their products in turns, ping-pong), each
//     tile's k loop in one f32 accumulator; the epilogue's residual and
//     bias are loaded before the products.  At the training shape:
//     q/k/v 1536 tiles, Wo 512, W1 2048, W2 512, on 132 CTAs.
//   - sync, for the rest (an odd D, E or F): block_gemm_bf16_kernel<EPI> on
//     gemm_bf16.cuh's run_tiles (128 x 128 CTA tiles of 8 warps, k-tiles
//     of 64 in a 4-stage cp.async ring, one m16n8k16 mma.sync per product,
//     each k-tile's products flushed into a second f32 accumulator).  Its
//     epilogue writes a thread's two neighbouring columns by one 4-byte
//     store where rows hold an even number of them; operands whose rows
//     are not 16-byte aligned are staged element by element, so any shape
//     the wrapper takes works.
// Both apply one epilogue (epi: _block_kernel's float order) to the f32
// sum and round once.  Measured on the H100 (PERF.md, tools/
// block_gemm_ab.py): the ping-pong form beat both warpgroups on one tile
// (cooperative, ptt_wg::mainloop) by 8 % of the block's time, and loading
// the residual and bias ahead beat loading them in the epilogue by 11 %;
// one accumulator gives the block the errors of a per-k-tile flush
// (tools/wgmma_flush.py).  The flush stays behind ptt_wg::kFlush, as in
// every wgmma kernel of the LM head: 0 in the shipped build, which
// compiles only the one-accumulator loop; tools/wgmma_flush.py builds it
// with -DPTT_WG_FLUSH=n to repeat that check where K or the products
// change (W2's K is F, which a configuration may raise).
//
// Workspace (the caller allocates ptt_transformer_block_bf16_fwd_workspace
// bytes): a (then f) [N, D], qkv [N, 3E], o [N, E], h [N, D], u [N, F] in
// bf16, mean and rstd [N] and lse [B, H, T] in f32: 161 MiB at the
// training shape (the f32 chain's is 505 MiB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_bf16.cuh"
#include "tma_maps.cuh"
#include "wgmma_bf16.cuh"

extern "C" int ptt_layer_norm_bf16_path(const void* x, const void* y, int D);
extern "C" int ptt_layer_norm_fwd_bf16(const void* x, const void* gamma,
                                       const void* beta, void* y, void* mean,
                                       void* rstd, int N, int D, float eps,
                                       int path, void* stream);
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
using ptt_gemm::sm_count;
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

// one output element from acc (rounded once by the caller), in
// _block_kernel's float order; res and bias are read only where EPI has
// them
template <int EPI>
__device__ __forceinline__ float epi(float acc, float res, float bias,
                                     float mul) {
  if constexpr (EPI == kQKV) return acc * mul;
  if constexpr (EPI == kResid) return res + acc;
  if constexpr (EPI == kBiasRelu) return fmaxf(acc + bias, 0.f);
  return res + (acc + bias);
}

template <int EPI>
__device__ __forceinline__ float epi_value(const Out& o, float resid, int c,
                                           float a, float mul) {
  constexpr bool kBias = EPI == kBiasRelu || EPI == kBiasResid;
  return epi<EPI>(a, resid, kBias ? o.bias[c] : 0.f, mul);
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

// ---- the four products on wgmma_bf16.cuh's pieces (the wgmma path) ----
//
// block_gemm_bf16_wg_kernel<EPI> computes what block_gemm_bf16_kernel<EPI>
// does, y = epilogue(A [M, K] . W_z [K, N]), on Hopper's warpgroup tensor
// cores.  A (a, o, f or u of the workspace) is read K-major through one
// TMA map, each weight N-major through its own (Wq, Wk and Wv for q/k/v),
// all three maps __grid_constant__ parameters; TMA fills zeros past M, N
// and K.  Tiles of 128 x 128 in the order (m tile, weight z, column tile
// of weight z), columns fastest, so that the CTAs running at one time share
// A's row tiles (W2's A, u, is 64 MiB at the training shape, more than
// the L2) and a tile never straddles two weights; CTA c of min(SMs,
// tiles) takes tiles c, c + gridDim.x, ... (kernels/fused_block.py
// block_gemm_plan mirrors it, ptt_block_gemm_bf16_wgmma_plan exports it).
// The producer warp's lane 0 loads every k-tile of the CTA's tiles into
// the mbarrier ring (ptt_wg::Smem), picking weight z's map per tile.
namespace blk_wg {

using ptt_wg::kEpiLD;

// the three weights' maps (one for every product but q/k/v)
struct Maps {
  CUtensorMap w[3];
};

struct Args {
  Out o;                  // y, resid, bias, ld, qscale
  int M, N;               // A's rows, each weight's columns (N % 8 == 0)
  int nt, ntot, tiles;    // column tiles a weight, of all weights, tiles
  int nk;                 // k-tiles
};

// tile t: its first row, its weight and its first column in that weight
__device__ __forceinline__ void tile_of(const Args& a, int t, int& m0,
                                        int& z, int& n0) {
  const int m = t / a.ntot, j = t - m * a.ntot;
  z = j / a.nt;
  m0 = m * ptt_wg::kBM;
  n0 = (j - z * a.nt) * ptt_wg::kBN;
}

// The producer (one thread): every k-tile of the CTA's tiles, in order.
__device__ __forceinline__ void produce(const CUtensorMap* ta,
                                        const Maps& tw,
                                        const ptt_wg::Smem& sm,
                                        const Args& a) {
  ptt_wg::Pipe p;
  for (int t = blockIdx.x; t < a.tiles; t += gridDim.x) {
    int m0, z, n0;
    tile_of(a, t, m0, z, n0);
    const CUtensorMap* tb = &tw.w[z];
    for (int k = 0; k < a.nk; ++k) {
      ptt_wg::mbar_wait(sm.empty(p.stage), p.phase ^ 1);
      ptt_wg::mbar_expect_tx(sm.full(p.stage), ptt_wg::kStageBytes);
      ptt_wg::Op<false>::load(sm.a(p.stage), ta, sm.full(p.stage), m0,
                              k * ptt_wg::kBK);
      ptt_wg::Op<true>::load(sm.b(p.stage), tb, sm.full(p.stage), n0,
                             k * ptt_wg::kBK);
      p.next();
    }
  }
}

__device__ __forceinline__ void unpack8(const uint4& u, float (&v)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// A thread's share of a warpgroup's 64-row half tile in the epilogue:
// the 8-column chunk (tid % 16) * 8 of rows tid / 16 + 8 it, it < 8.  Its
// residual (kResid, kBiasResid) and bias (kBiasRelu, kBiasResid) are
// loaded ahead, so that their latency runs under the products or the
// staging: the residual by 16-byte reads along the row, the bias as f32 by
// column, zeros past M and N and where EPI has none.
template <int EPI>
__device__ __forceinline__ void load_resid(uint4 (&res)[8], const Args& a,
                                           int r0, int z, int n0) {
  const int tid = threadIdx.x & 127, gc = n0 + (tid & 15) * 8;
  const long long col0 = (long long)z * a.N + gc;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int gr = r0 + (tid >> 4) + 8 * it;
    res[it] = (EPI == kResid || EPI == kBiasResid) && gr < a.M && gc < a.N
                  ? *reinterpret_cast<const uint4*>(a.o.resid +
                                                    gr * a.o.ld + col0)
                  : make_uint4(0, 0, 0, 0);
  }
}

template <int EPI>
__device__ __forceinline__ void load_bias(float (&bias)[8], const Args& a,
                                          int n0) {
  const int gc = n0 + (threadIdx.x & 15) * 8;
#pragma unroll
  for (int e = 0; e < 8; ++e)
    bias[e] = (EPI == kBiasRelu || EPI == kBiasResid) && gc + e < a.N
                  ? a.o.bias[gc + e]
                  : 0.f;
}

// A warpgroup's 64 x 128 accumulators (acc[4 j + 2 i + e]: row fr + 8 i,
// column 8 j + fc + e) through its staging tile sf into rows r0.. of y,
// with the residual and bias loaded ahead: each thread's 8-column chunks,
// the epilogue in epi_value's order, rounded once, one 16-byte store each.
// Rows >= M and columns >= N are masked by chunk (N % 8 == 0).
template <int EPI>
__device__ __forceinline__ void epilogue(const float (&acc)[64], float* sf,
                                         const Args& a, int r0, int z,
                                         int n0, int h,
                                         const uint4 (&ahead)[8],
                                         const float (&bias)[8]) {
  const int lane = threadIdx.x & 31, tid = threadIdx.x & 127;
  const int fr = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int fc = 2 * (lane & 3);
  ptt_wg::wg_sync(h);   // the staging tile is free again
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(sf + (fr + 8 * i) * kEpiLD + 8 * j + fc) =
          make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  ptt_wg::wg_sync(h);
  const float mul = EPI == kQKV && z == 0 ? a.o.qscale : 1.f;
  const int c = (tid & 15) * 8, gc = n0 + c;
  const long long col0 = (long long)z * a.N + gc;
#pragma unroll
  for (int it = 0; it < 8; ++it) {
    const int row = (tid >> 4) + 8 * it, gr = r0 + row;
    if (gr >= a.M || gc >= a.N) continue;
    const float* src = sf + row * kEpiLD + c;
    const float4 s0 = *reinterpret_cast<const float4*>(src);
    const float4 s1 = *reinterpret_cast<const float4*>(src + 4);
    const float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float res[8];
    unpack8(ahead[it], res);
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = epi<EPI>(v[e], res[e], bias[e], mul);
    uint4 pk;
    pk.x = ptt_bf16::pack(y[0], y[1]);
    pk.y = ptt_bf16::pack(y[2], y[3]);
    pk.z = ptt_bf16::pack(y[4], y[5]);
    pk.w = ptt_bf16::pack(y[6], y[7]);
    *reinterpret_cast<uint4*>(a.o.y + gr * a.o.ld + col0) = pk;
  }
}

// Ping-pong: 384 threads, consumer warpgroups 0 and 1 and a producer
// warpgroup (warp 8's lane 0 loads; the warpgroup gives its registers to
// the consumers, setmaxnreg 40 / 232).  Warpgroup h takes the CTA's tiles
// of local parity h, all 128 rows of each (two wgmma m64n128k16 a k16
// step, 128 f32 accumulators a thread), and the two issue a tile's products
// in turns (named barriers 3 and 4), so that one's epilogue runs under the
// other's products.  Each slot is read by one warpgroup: its empty barrier
// counts 4 warps.  A tile's epilogue runs in two 64-row halves through the
// warpgroup's staging tile; the first half's residual and the bias are
// loaded before the warpgroup's turn, the second half's before the first
// half's epilogue.
constexpr int kThreads = 384;

__device__ __forceinline__ void turn_wait(int h) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(3 + h) : "memory");
}
__device__ __forceinline__ void turn_pass(int h) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(4 - h) : "memory");
}

// k-tile of the slot at `iss` into d0 (rows 0-63) and d1 (64-127), one
// commit group; fresh: the first product overwrites them
__device__ __forceinline__ void issue(float (&d0)[64], float (&d1)[64],
                                      const ptt_wg::Smem& sm,
                                      const ptt_wg::Pipe& iss, bool fresh) {
  ptt_wg::mbar_wait(sm.full(iss.stage), iss.phase);
  ptt_wg::wgmma_fence();
  const uint32_t sa = sm.a(iss.stage), sb = sm.b(iss.stage);
#pragma unroll
  for (int j = 0; j < ptt_wg::kBK / 16; ++j) {
    const uint64_t db = ptt_wg::Op<true>::desc(sb, 0, j);
    ptt_wg::wgmma<0, 1>(d0, ptt_wg::Op<false>::desc(sa, 0, j), db,
                        fresh && j == 0 ? 0 : 1);
    ptt_wg::wgmma<0, 1>(d1, ptt_wg::Op<false>::desc(sa, 64, j), db,
                        fresh && j == 0 ? 0 : 1);
  }
  ptt_wg::wgmma_commit();
}

template <int EPI>
__global__ void __launch_bounds__(kThreads, 1)
    block_gemm_bf16_wg_kernel(const __grid_constant__ CUtensorMap ta,
                              const __grid_constant__ Maps tw,
                              const Args a) {
  constexpr int kFlush = ptt_wg::kFlush;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const ptt_wg::Smem sm = ptt_wg::setup(smem_raw, 4);
  // the warp's index, known to ptxas to be the same across the warp
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp == 8 && (threadIdx.x & 31) == 0) produce(&ta, tw, sm, a);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int h = warp >> 2;
  float* sf = reinterpret_cast<float*>(sm.epi + h * ptt_wg::kEpiBytes);
  // the ring positions of this warpgroup's next issue and next release;
  // warpgroup 1 starts past warpgroup 0's first tile
  ptt_wg::Pipe iss, rel;
  for (int i = 0; i < h * a.nk; ++i) {
    iss.next();
    rel.next();
  }
  float acc0[64], acc1[64];
  if (h == 1) turn_pass(1);   // warpgroup 0 first
  for (int t = blockIdx.x + h * gridDim.x; t < a.tiles;
       t += 2 * gridDim.x) {
    int m0, z, n0;
    tile_of(a, t, m0, z, n0);
    // the first half's residual and the bias, in flight under the products
    uint4 res0[8], res1[8];
    float bias[8];
    load_resid<EPI>(res0, a, m0, z, n0);
    load_bias<EPI>(bias, a, n0);
    turn_wait(h);
    if constexpr (kFlush > 0) {
      // a measurement build: products into p0, p1, added to acc0, acc1
      // every kFlush k-tiles and at the end
      float p0[64], p1[64];
      for (int k = 0; k < a.nk; ++k) {
        issue(p0, p1, sm, iss, k % kFlush == 0);
        iss.next();
        if ((k + 1) % kFlush == 0 || k + 1 == a.nk) {
          ptt_wg::wgmma_wait<0>();
          ptt_wg::fence_acc(p0);
          ptt_wg::fence_acc(p1);
          for (; rel.stage != iss.stage || rel.phase != iss.phase;
               rel.next())
            ptt_wg::release(sm.empty(rel.stage));
#pragma unroll
          for (int i = 0; i < 64; ++i) {
            acc0[i] = k < kFlush ? p0[i] : acc0[i] + p0[i];
            acc1[i] = k < kFlush ? p1[i] : acc1[i] + p1[i];
          }
        }
      }
      turn_pass(h);
    } else {
      for (int k = 0; k < a.nk; ++k) {
        issue(acc0, acc1, sm, iss, k == 0);
        iss.next();
        ptt_wg::wgmma_wait<1>();   // the previous k-tile's group is done
        if (k > 0) {
          ptt_wg::release(sm.empty(rel.stage));
          rel.next();
        }
      }
      turn_pass(h);
      ptt_wg::wgmma_wait<0>();
      ptt_wg::fence_acc(acc0);
      ptt_wg::fence_acc(acc1);
      ptt_wg::release(sm.empty(rel.stage));
      rel.next();
    }
    // past the other warpgroup's next tile
    for (int i = 0; i < a.nk; ++i) {
      iss.next();
      rel.next();
    }
    // the second half's residual, in flight under the first's epilogue
    load_resid<EPI>(res1, a, m0 + 64, z, n0);
    epilogue<EPI>(acc0, sf, a, m0, z, n0, h, res0, bias);
    epilogue<EPI>(acc1, sf, a, m0 + 64, z, n0, h, res1, bias);
  }
}

// The schedule of one product on this card: tiles and CTAs.  ok is false
// where the tile count passes 2^30.
struct Plan {
  int mt, nt, nw, tiles, ctas, nk;
  bool ok;
};

Plan plan(int M, int N, int K, int nw) {
  Plan p{};
  const long long mt = cdiv(M, ptt_wg::kBM), nt = cdiv(N, ptt_wg::kBN);
  p.ok = M > 0 && N > 0 && K > 0 && nw >= 1 && nw <= 3 &&
         mt * nw * nt < (1LL << 30);
  if (!p.ok) return p;
  p.mt = (int)mt;
  p.nt = (int)nt;
  p.nw = nw;
  p.tiles = (int)(mt * nw * nt);
  p.ctas = p.tiles < sm_count() ? p.tiles : sm_count();
  p.nk = cdiv(K, ptt_wg::kBK);
  return p;
}

}  // namespace blk_wg

// y [M, nw N] = epilogue(A [M, K] . [W0 | ... ]) on the wgmma path; every
// operand 16-byte aligned with rows of a multiple of 8 elements (the
// caller checks)
template <int EPI>
cudaError_t gemm_wg(const bf16* A, const bf16* const (&w)[3], int nw, Out o,
                    int M, int N, int K, cudaStream_t s) {
  const blk_wg::Plan p = blk_wg::plan(M, N, K, nw);
  if (!p.ok) return cudaErrorInvalidValue;
  CUtensorMap ta;
  blk_wg::Maps tw{};
  cudaError_t err = ptt_tma::kmajor_map(&ta, A, K, M, K);
  for (int z = 0; z < nw && err == cudaSuccess; ++z)
    err = ptt_tma::mnmajor_map(&tw.w[z], w[z], N, K, N);
  if (err != cudaSuccess) return err;
  o.ld = (long long)nw * N;
  const blk_wg::Args a{o, M, N, p.nt, nw * p.nt, p.tiles, p.nk};
  auto kernel = blk_wg::block_gemm_bf16_wg_kernel<EPI>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             ptt_wg::kSmemBytes);
  if (err != cudaSuccess) return err;
  kernel<<<p.ctas, blk_wg::kThreads, ptt_wg::kSmemBytes, s>>>(ta, tw, a);
  return cudaGetLastError();
}

// one product on the chosen path (1 wgmma, 0 mma.sync)
template <int EPI>
cudaError_t product(int path, const bf16* A, const bf16* const (&w)[3],
                    int nw, Out o, int M, int N, int K, cudaStream_t s) {
  return path ? gemm_wg<EPI>(A, w, nw, o, M, N, K, s)
              : gemm<EPI>(A, w, nw, o, M, N, K, s);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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

// The wgmma path's schedule of one product, A [M, K] . nw weights [K, N],
// on this card: out[0..5] = row tiles, column tiles a weight, weights,
// tiles, CTAs, k-tiles (kernels/fused_block.py block_gemm_plan mirrors it).
extern "C" int ptt_block_gemm_bf16_wgmma_plan(int M, int N, int K, int nw,
                                              int* out) {
  const blk_wg::Plan p = blk_wg::plan(M, N, K, nw);
  if (!p.ok) return (int)cudaErrorInvalidValue;
  const int v[6] = {p.mt, p.nt, p.nw, p.tiles, p.ctas, p.nk};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

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
// (kernels/fused_block.py flash_path_in_block).  gemm_path is the four
// products' path (1 wgmma, 0 mma.sync; kernels/fused_block.py
// block_gemm_path): wgmma only where D, E and F are multiples of 8 and x,
// out, the six matrices and ws are 16-byte aligned, else
// cudaErrorInvalidValue before any launch.  Seven launches on `stream`.
// Returns a cudaError_t as int.
extern "C" int ptt_transformer_block_bf16_fwd(
    const void* x, const void* ln1g, const void* ln1b, const void* wq,
    const void* wk, const void* wv, const void* wo, const void* ln2g,
    const void* ln2b, const void* w1, const void* b1, const void* w2,
    const void* b2, void* out, void* ws, int B, int T, int D, int E, int F,
    int H, int causal, float eps1, float eps2, int flash_path, int gemm_path,
    void* stream) {
  if (B <= 0 || T <= 0 || D <= 0 || F <= 0 || H <= 0 || E <= 0 || E % H)
    return (int)cudaErrorInvalidValue;
  const int N = B * T, dh = E / H;
  if (dh != 64 && dh != 128) return (int)cudaErrorInvalidValue;
  // the wgmma path only where TMA and the 16-byte epilogue can describe
  // every operand
  const void* const wide[9] = {x, wq, wk, wv, wo, w1, w2, out, ws};
  bool described = D % 8 == 0 && E % 8 == 0 && F % 8 == 0;
  for (const void* p : wide) described = described && aligned16(p);
  if (gemm_path != 0 && (gemm_path != 1 || !described))
    return (int)cudaErrorInvalidValue;
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

  // 1. LN1, on the path layer_norm.cu's rule gives x and a
  int err = ptt_layer_norm_fwd_bf16(x, ln1g, ln1b, a, mean, rstd, N, D, eps1,
                                    ptt_layer_norm_bf16_path(x, a, D), stream);
  if (err) return err;
  // 2. q, k, v
  const bf16* const wqkv[3] = {static_cast<cb>(wq), static_cast<cb>(wk),
                               static_cast<cb>(wv)};
  err = (int)product<kQKV>(gemm_path, a, wqkv, 3,
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
  err = (int)product<kResid>(gemm_path, o, wob, 1,
                             Out{h, xb, nullptr, 0, 1.f, 0}, N, D, E, s);
  if (err) return err;
  // 5. LN2, into a's room
  err = ptt_layer_norm_fwd_bf16(h, ln2g, ln2b, a, mean, rstd, N, D, eps2,
                                ptt_layer_norm_bf16_path(h, a, D), stream);
  if (err) return err;
  // 6. u = relu(f W1 + b1)
  const bf16* const w1b[3] = {static_cast<cb>(w1), nullptr, nullptr};
  err = (int)product<kBiasRelu>(
      gemm_path, a, w1b, 1,
      Out{u, nullptr, static_cast<const float*>(b1), 0, 1.f, 0}, N, F, D,
      s);
  if (err) return err;
  // 7. out = h + (u W2 + b2)
  const bf16* const w2b[3] = {static_cast<cb>(w2), nullptr, nullptr};
  return (int)product<kBiasResid>(
      gemm_path, u, w2b, 1,
      Out{static_cast<bf16*>(out), h, static_cast<const float*>(b2), 0, 1.f,
          0},
      N, D, F, s);
}
