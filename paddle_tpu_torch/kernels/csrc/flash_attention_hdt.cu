// Flash-attention forward for Hopper (sm_90a), for any layout.
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
// Bound on the H100: operations.  The causal work is about
// 2 * B * H * T^2 * d multiply-adds' worth of FLOPs for q k^T and p v
// together, against q, k, v, o read or written once.  This kernel uses the
// f32 CUDA cores (67 TFLOP/s peak), not the tensor cores.
//
// Design (simple first; no wgmma and no TMA yet): one CTA of 64 threads per
// (64-query tile, batch row, head); thread t owns query row t.  The query
// tile, pre-multiplied by scale, and each 64-key tile of k and v are staged
// in shared memory as [d][64]: neighbouring threads load neighbouring
// tokens, a coalesced copy when the token stride is 1 (the head-major
// layout) and a strided one otherwise.  A thread takes its scores 16 keys
// at a time into registers: the k values are read as float4 broadcasts
// shared by the whole warp.  The online softmax keeps the running max m
// and sum l and the output accumulator (d floats) in registers and
// rescales the accumulator once per 16 keys.  The loop over key tiles stops
// at the diagonal tile (causal) and at kv_len; ragged tiles are zero-filled
// and masked here, so the caller pads nothing.  lse = m + log(l) is written
// at the end.
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;   // queries per CTA, one per thread
constexpr int kBK = 64;   // keys per shared-memory tile
constexpr int kCH = 16;   // keys per online-softmax step
constexpr float kNegInf = -1e30f;

// element strides of one operand: batch row, head, feature, token
struct Strides {
  long long b, h, d, t;
};

template <int D>
__global__ void __launch_bounds__(kBQ)
    flash_fwd_hdt_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int Tq, int Tk, int kv_len,
                         int causal, float scale, Strides qs, Strides ks,
                         Strides vs, Strides os, long long ls_b,
                         long long ls_h) {
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [D][kBQ], times scale
  float* Ks = Qs + D * kBQ;                     // [D][kBK]
  float* Vs = Ks + D * kBK;                     // [D][kBK]

  const int t = threadIdx.x;
  const int q0 = blockIdx.x * kBQ;
  const int b = blockIdx.y;
  const int h = blockIdx.z;
  const int qpos = q0 + t;

  const float* qh = q + b * qs.b + h * qs.h;
  const float* kh = k + b * ks.b + h * ks.h;
  const float* vh = v + b * vs.b + h * vs.h;

  // Thread t stages query column t and is the only reader of it.
#pragma unroll 8
  for (int j = 0; j < D; ++j)
    Qs[j * kBQ + t] =
        qpos < Tq ? qh[j * qs.d + (long long)qpos * qs.t] * scale : 0.f;

  float acc[D];
#pragma unroll
  for (int j = 0; j < D; ++j) acc[j] = 0.f;
  float m = kNegInf, l = 0.f;

  int kend = causal ? min(Tk, q0 + kBQ) : Tk;
  kend = min(kend, kv_len);
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = t; idx < D * kBK; idx += kBQ) {
      const int j = idx / kBK, c = idx % kBK;
      const int kp = k0 + c;
      const bool in = kp < kend;
      Ks[idx] = in ? kh[j * ks.d + (long long)kp * ks.t] : 0.f;
      Vs[idx] = in ? vh[j * vs.d + (long long)kp * vs.t] : 0.f;
    }
    __syncthreads();

    for (int c0 = 0; c0 < kBK && k0 + c0 < kend; c0 += kCH) {
      float s[kCH];
#pragma unroll
      for (int c = 0; c < kCH; ++c) s[c] = 0.f;
#pragma unroll 16
      for (int j = 0; j < D; ++j) {
        const float qj = Qs[j * kBQ + t];
        const float4* kr = reinterpret_cast<const float4*>(Ks + j * kBK + c0);
#pragma unroll
        for (int c4 = 0; c4 < kCH / 4; ++c4) {
          const float4 kk = kr[c4];
          s[4 * c4 + 0] = fmaf(qj, kk.x, s[4 * c4 + 0]);
          s[4 * c4 + 1] = fmaf(qj, kk.y, s[4 * c4 + 1]);
          s[4 * c4 + 2] = fmaf(qj, kk.z, s[4 * c4 + 2]);
          s[4 * c4 + 3] = fmaf(qj, kk.w, s[4 * c4 + 3]);
        }
      }
      float cmax = kNegInf;
#pragma unroll
      for (int c = 0; c < kCH; ++c) {
        const int kp = k0 + c0 + c;
        const bool valid = kp < kend && (!causal || kp <= qpos);
        s[c] = valid ? s[c] : kNegInf;
        cmax = fmaxf(cmax, s[c]);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < kCH; ++c) {
        s[c] = expf(s[c] - m_new);
        psum += s[c];
      }
      l = l * corr + psum;
      m = m_new;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float4* vr = reinterpret_cast<const float4*>(Vs + j * kBK + c0);
        float a = acc[j] * corr;
#pragma unroll
        for (int c4 = 0; c4 < kCH / 4; ++c4) {
          const float4 vv = vr[c4];
          a = fmaf(s[4 * c4 + 0], vv.x, a);
          a = fmaf(s[4 * c4 + 1], vv.y, a);
          a = fmaf(s[4 * c4 + 2], vv.z, a);
          a = fmaf(s[4 * c4 + 3], vv.w, a);
        }
        acc[j] = a;
      }
    }
  }

  if (qpos < Tq) {
    const float lsafe = fmaxf(l, 1e-30f);
    float* oc = o + b * os.b + h * os.h + (long long)qpos * os.t;
#pragma unroll
    for (int j = 0; j < D; ++j) oc[j * os.d] = acc[j] / lsafe;
    lse[b * ls_b + h * ls_h + qpos] = m + logf(lsafe);
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int H, int B, int Tq, int Tk, int kv_len, int causal,
           float scale, const Strides* st, long long ls_b, long long ls_h,
           cudaStream_t stream) {
  const int smem = (D * kBQ + 2 * D * kBK) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_hdt_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + kBQ - 1) / kBQ, B, H);
  flash_fwd_hdt_kernel<D><<<grid, kBQ, smem, stream>>>(
      q, k, v, o, lse, Tq, Tk, kv_len, causal, scale, st[0], st[1], st[2],
      st[3], ls_b, ls_h);
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
