// Flash-attention forward for Hopper (sm_90a), for any layout, on the
// tensor cores.
//
// Replaces the Pallas TPU kernels
// paddle_tpu/kernels/flash_attention.py:_flash_fwd_hdt (body
// _fwd_kernel_hdt) and _flash_fwd (body _fwd_kernel).  For each head h and
// batch row b:
//   o = softmax(scale * q k^T + mask) v,   lse = logsumexp(scale * q k^T + mask)
// f32.  Every operand comes with element strides for (batch, head,
// feature, token), so the one kernel reads and writes the head-major
// [H, d, B*T] layout that fused_mha's projections produce, the [B, H, T, d]
// layout of flash_attention, and the [B, T, H, d] views of [B*T, E]
// projections, without a transpose copy.  lse [.., T] has token stride 1.
// Masked: keys after the query (causal) and keys >= kv_len.
//
// Bound on the H100: operations.  The causal work is 4 d FLOP per kept
// (query, key) pair for q k^T and p v (8.607 GFLOP at B 32, H 8, T 512,
// d 64); in 3xTF32 the tensor cores do three times that, 25.8 GFLOP at
// 495 TFLOP/s = 0.052 ms.  q, k, v, o and lse move once: 134 MB at
// 3.35 TB/s = 0.040 ms.
//
// Design: FlashAttention-2 on mma.sync m16n8k8 TF32 with the 3xTF32 split
// (flash_mma.cuh has the numerics, the fragment maps and the staging).
// Triton is not used: the kernel needs exact control of the three-pass
// split and of the fragment layout that lets p feed the p v product from
// registers.
// - A CTA of 4 warps takes 64 queries of one (batch row, head), 16 a warp.
//   The grid is (B*H, query tiles) with the last query tile first, so the
//   longest causal rows start first.
// - The query tile is staged once; each warp keeps its 16 rows, times
//   scale, in registers as f32 A fragments (split per use).
// - Key and value tiles of 64 tokens are double-buffered in shared memory
//   by cp.async: tile i + 1's copy is in flight while tile i's products run.
//   The staging path (16-byte along features, 4-byte along tokens, or
//   4-byte generic) is chosen per operand from its strides and alignment;
//   all three fill the same [64][d + 4] tile.
// - A key tile is taken in two blocks of 32 keys (fewer live registers);
//   s = q k^T for the warp's 16 x 32 block stays in accumulator registers.
//   The row max and row sum of the online softmax are reduced over the 4
//   lanes of a quad with __shfl_xor_sync, and the o accumulator is rescaled
//   once per block.  On the causal diagonal a warp skips the block whose
//   keys all lie after its rows.  p is the A operand of p v as it stands in the s
//   accumulators (k relabelled within each 8-block, v's B rows read as 2t
//   and 2t + 1): no round trip through shared memory.
// - The loop over key tiles stops at the diagonal tile (causal) and at
//   kv_len; masks are applied only in tiles that need them; ragged tiles
//   are zero-filled and masked here, so the caller pads nothing.
//   lse = m + log(l) is written at the end.
// Shared memory: 4 tiles of [64][d + 4] floats (k and v, two stages; the
// query tile is staged into the second stage first), 69,632 bytes at d 64
// and 135,168 at d 128.  Occupancy (ptxas, printed by chip_smoke.py's
// build phase): at d 64 168 registers and no spills, so 3 CTAs (12 warps)
// share an SM, as many as shared memory allows; at d 128 shared memory
// allows 1 CTA (4 warps), and the 64 + 64 registers of q and o fragments
// take all 255 with a few dozen bytes of spills.
#include <cuda_runtime.h>

#include "flash_mma.cuh"

namespace {

using namespace ptt_flash;

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_hdt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int H, int Tq, int Tk,
                         int kv_len, int causal, float scale, Strides qs,
                         Strides ks, Strides vs, Strides os, long long ls_b,
                         long long ls_h, int mq, int mk, int mv) {
  constexpr int TF = Tile<D>::kFloats, NF = D / 8;
  constexpr int KN = 32, NJ = KN / 8;   // keys per online-softmax step
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);  // stage s: k at 2s TF, v after

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  const int wr = 16 * warp;                     // the warp's first row
  const int qr0 = q0 + wr + g, qr1 = qr0 + 8;   // this lane's two queries

  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;
  int kend = min(Tk, kv_len);
  if (causal) kend = min(kend, q0 + kTile);
  const int ntiles = (kend + kTile - 1) / kTile;

  stage<D>(sm + 2 * TF, q + b * qs.b + h * qs.h, qs, q0, Tq, mq);
  stage<D>(sm, kh, ks, 0, kend, mk);
  stage<D>(sm + TF, vh, vs, 0, kend, mv);
  cp_commit();
  cp_wait<0>();
  __syncthreads();
  float qf[NF][4];   // the warp's rows times scale, as A fragments
#pragma unroll
  for (int kk = 0; kk < NF; ++kk)
    load_a<D>(qf[kk], sm + 2 * TF, wr + g, 8 * kk, t, scale);
  __syncthreads();   // the query tile's stage is reused for keys

  float acc[NF][4];
#pragma unroll
  for (int f = 0; f < NF; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int k0 = it * kTile;
    if (it + 1 < ntiles) {
      float* nb = sm + ((it + 1) & 1) * 2 * TF;
      stage<D>(nb, kh, ks, k0 + kTile, kend, mk);
      stage<D>(nb + TF, vh, vs, k0 + kTile, kend, mv);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* Ks = sm + (it & 1) * 2 * TF;
    const float* Vs = Ks + TF;

#pragma unroll 1
    for (int c0 = 0; c0 < kTile; c0 += KN) {
      const int kb = k0 + c0;   // the block's first key
      // nothing to do where every key is masked for the warp's rows
      if (kb >= kend || (causal && kb > q0 + wr + 15)) continue;
      float s[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < NF; ++kk) {
        FragA a;
        a.set(qf[kk]);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          FragB bk;
          load_b_rows<D>(bk, Ks, c0 + 8 * j, 8 * kk, g, t);
          mma3(s[j], a, bk);
        }
      }

      if (kb + KN > kend || (causal && kb + KN - 1 > q0 + wr)) {
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = kb + 8 * j + 2 * t + (e & 1);
            const int row = e < 2 ? qr0 : qr1;
            if (key >= kend || (causal && key > row)) s[j][e] = kNegInf;
          }
      }

      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0r = exp2f((m0 - mx0) * kLog2e);
      const float c1r = exp2f((m1 - mx1) * kLog2e);
      m0 = mx0;
      m1 = mx1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        s[j][0] = exp2f((s[j][0] - mx0) * kLog2e);
        s[j][1] = exp2f((s[j][1] - mx0) * kLog2e);
        s[j][2] = exp2f((s[j][2] - mx1) * kLog2e);
        s[j][3] = exp2f((s[j][3] - mx1) * kLog2e);
        ps0 += s[j][0] + s[j][1];
        ps1 += s[j][2] + s[j][3];
      }
      l0 = l0 * c0r + ps0;   // this lane's share; the quad's sum at the end
      l1 = l1 * c1r + ps1;
#pragma unroll
      for (int f = 0; f < NF; ++f) {
        acc[f][0] *= c0r;
        acc[f][1] *= c0r;
        acc[f][2] *= c1r;
        acc[f][3] *= c1r;
      }

      // o += p v: k runs over the block's keys, p's A operand is s as it
      // stands
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        FragA a;
        a_from_c(a, s[j]);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          FragB bv;
          load_b_cols<D>(bv, Vs, c0 + 8 * j, 8 * f, g, t);
          mma3(acc[f], a, bv);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  l0 = fmaxf(l0, 1e-30f);
  l1 = fmaxf(l1, 1e-30f);
  float* oh = o + b * os.b + h * os.h;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? qr1 : qr0;
    if (row >= Tq) continue;
    const float l = half ? l1 : l0;
    float* orow = oh + (long long)row * os.t;
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      orow[(long long)(8 * f + 2 * t) * os.d] = acc[f][2 * half] / l;
      orow[(long long)(8 * f + 2 * t + 1) * os.d] = acc[f][2 * half + 1] / l;
    }
    if (t == 0) lse[b * ls_b + h * ls_h + row] = (half ? m1 : m0) + logf(l);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int H, int B, int Tq, int Tk, int kv_len, int causal,
           float scale, const Strides* st, long long ls_b, long long ls_h,
           cudaStream_t stream) {
  const int smem = 4 * Tile<D>::kFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_hdt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + kTile - 1) / kTile);
  flash_fwd_hdt_kernel<D><<<grid, kThreads, smem, stream>>>(
      q, k, v, o, lse, H, Tq, Tk, kv_len, causal, scale, st[0], st[1], st[2],
      st[3], ls_b, ls_h, stage_mode(q, st[0]), stage_mode(k, st[1]),
      stage_mode(v, st[2]));
  return (int)cudaGetLastError();
}

}  // namespace

// q [B, H, Tq, D], k and v [B, H, Tk, D] and o [B, H, Tq, D] in any layout:
// strides[16] holds (batch, head, feature, token) element strides for q,
// k, v and o in that order, strides[16:18] lse's batch and head strides
// (lse [B, H, Tq] has token stride 1).  f32; D is 64 or 128;
// 1 <= kv_len <= Tk.  Returns a cudaError_t as int.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int H, int D, int B, int Tq,
                             int Tk, int kv_len, int causal, float scale,
                             const long long* strides, void* stream) {
  if (H <= 0 || B <= 0 || Tq <= 0 || Tk <= 0 || kv_len < 1 || kv_len > Tk)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i)
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                    strides[4 * i + 3]};
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return launch<64>(qf, kf, vf, of, lf, H, B, Tq, Tk, kv_len, causal,
                        scale, st, strides[16], strides[17], s);
    case 128:
      return launch<128>(qf, kf, vf, of, lf, H, B, Tq, Tk, kv_len, causal,
                         scale, st, strides[16], strides[17], s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
