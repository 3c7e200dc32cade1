// Value-type helpers shared by the SpMV kernels (ell_spmv.cu, dia_spmv.cu):
// the accumulator type of each storage type, widening loads, the fused
// multiply-add in that type, and the rounding store.
//
// fp64 and f32 accumulate in their own type with a single-rounding fma/fmaf.
// bf16 storage accumulates in float32 and rounds the result once to bf16,
// like the TPU kernels' f32-compute bf16 path.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace spmv {

constexpr int kThreads = 256;

template <typename V> struct Accum { using type = V; };
template <> struct Accum<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ double mad(double a, double b, double c) {
  return fma(a, b, c);
}
__device__ __forceinline__ float mad(float a, float b, float c) {
  return fmaf(a, b, c);
}

__device__ __forceinline__ void store(double* p, double v) { *p = v; }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Blocks of kThreads for one thread per row; at least one block, so that
// every call launches and goes through the launch check, even with no rows.
inline int64_t row_blocks(int64_t num_rows) {
  return num_rows > 0 ? (num_rows + kThreads - 1) / kThreads : 1;
}

}  // namespace spmv
