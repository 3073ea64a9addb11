// Host side of the TMA loads: the tensor maps (CUtensorMap) that the
// wgmma kernels' producer warps read their tiles through, shared by
// lm_head_bf16.cu (the LM head's backward) and flash_attention_bf16.cu (the
// flash forward).  cuTensorMapEncodeTiled is a driver function; it is looked
// up at run time through the CUDA runtime's entry-point query, so the
// library links no libcuda.  Every map is of bf16 elements with 128-byte
// swizzle (the layout wgmma_bf16.cuh's descriptors name) and zero fill
// outside the tensor.
#pragma once

#include <cuda.h>   // CUtensorMap (the types only: libcuda is not linked)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "wgmma_bf16.cuh"

namespace ptt_tma {

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                            &q);
#endif
    return q == cudaDriverEntryPointSuccess ? (EncodeTiled)f : nullptr;
  }();
  return fn;
}

// The map of a rank-`rank` (at most 5) bf16 tensor at p: dims[0] is the
// contiguous index, strides[i] (elements, multiples of 8) the stride of
// dims[i + 1]; boxes of box[] elements, box[0] * 2 <= 128 bytes.
inline cudaError_t tensor_map(CUtensorMap* m, const __nv_bfloat16* p,
                              int rank, const long long* dims,
                              const long long* strides, const int* box) {
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorSymbolNotFound;
  if (rank < 1 || rank > 5) return cudaErrorInvalidValue;
  cuuint64_t d[5], s[4];
  cuuint32_t b[5], one[5];
  for (int i = 0; i < rank; ++i) {
    d[i] = (cuuint64_t)dims[i];
    b[i] = (cuuint32_t)box[i];
    one[i] = 1;
    if (i > 0) s[i - 1] = (cuuint64_t)strides[i - 1] * 2;
  }
  const CUresult r = enc(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                         const_cast<__nv_bfloat16*>(p), d, s, b, one,
                         CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_128B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the map of a bf16 [outer, inner] matrix (rows of ld elements) in boxes of
// box_inner x box_outer
inline cudaError_t matrix_map(CUtensorMap* m, const __nv_bfloat16* p,
                              long long inner, long long outer, long long ld,
                              int box_inner, int box_outer) {
  const long long dims[2] = {inner, outer};
  const int box[2] = {box_inner, box_outer};
  return tensor_map(m, p, 2, dims, &ld, box);
}

// the map of an operand of wgmma_bf16.cuh's tile loop read K-major (boxes
// of 64 k x 128 rows) or MN-major (64 mn x 64 k), k or mn the contiguous
// index
inline cudaError_t kmajor_map(CUtensorMap* m, const __nv_bfloat16* p,
                              long long inner, long long outer,
                              long long ld) {
  return matrix_map(m, p, inner, outer, ld, ptt_wg::kBK, ptt_wg::kBM);
}

inline cudaError_t mnmajor_map(CUtensorMap* m, const __nv_bfloat16* p,
                               long long inner, long long outer,
                               long long ld) {
  return matrix_map(m, p, inner, outer, ld, 64, ptt_wg::kBK);
}

}  // namespace ptt_tma
