// ELLPACK SpMV for Hopper (sm_90a): y_out := A*x + y_in in one pass.
//
// Replaces the TPU kernel ellspmv_tpu/ops/ell_pallas.py::_make_kernel (K1),
// launched there by _run_f32 and _run_dd, together with the epilogue that XLA
// fused after it (ell_spmv_pallas: the split diagonal and y). For each row
// i < num_rows:
//
//   y_out[i] = sum_{s < rowsize} values[s, i] * x[colidx[s, i]]
//              + diag[i] * x[min(i, num_columns - 1)]   (when diag is given)
//              + y_in[i]                                 (when y_in is given)
//
// What bounds it: device-memory bytes. Each slot costs 12 B in fp64/int32
// (8 B value, 4 B index) against 2 flops, far below the card's balance
// point, plus x and y once each when the gather hits in cache. So the design
// is about moving those bytes once, in full sectors:
//
// - values and colidx are slot-major, (rowsize, padded_rows). One thread
//   owns one row; a warp owns 32 consecutive rows and reads each slot with
//   one coalesced load. This simple layout already streams values and colidx
//   exactly once. They are loaded with the evict-first hint (__ldcs): they
//   are never read again, and x should keep the cache.
// - x is gathered through the read-only path (__ldg), so the columns that
//   neighbouring rows share hit in L1, and x (16.6 MB in fp64 at 2M columns)
//   stays in the 50 MB L2.
// - fp64 runs in native fp64 FMA: the TPU kernel's double-double arithmetic
//   exists only because the TPU has no fp64. bf16 storage accumulates in
//   float32 and rounds the result to bf16, like the TPU kernel's f32-compute
//   bf16 path.
// - Offsets are computed in 64 bits (size_t), so slot * padded_rows cannot
//   wrap at scale.
//
// The TPU kernel's window plan (ops/plan.py) exists to turn every gather into
// a 128-lane gather from VMEM; on Hopper the cache does that job, so this
// kernel takes the plain ELL arrays.
//
// Binding: plain C entry points, one per (value, index) type, loaded with
// ctypes. Each launches on the stream it is given, does not synchronise, and
// returns cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "spmv_common.cuh"

namespace {

using spmv::Accum;
using spmv::kThreads;
using spmv::mad;
using spmv::store;
using spmv::widen;

template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const I* __restrict__ colidx, const V* __restrict__ values,
                const V* __restrict__ diag, const V* __restrict__ x,
                const V* __restrict__ y_in, V* __restrict__ y_out,
                int64_t num_rows, int64_t padded_rows, int64_t rowsize,
                int64_t num_columns) {
  using A = typename Accum<V>::type;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_rows) return;
  const size_t stride = static_cast<size_t>(padded_rows);
  const I* c = colidx + i;
  const V* v = values + i;
  A acc = A(0);
#pragma unroll 4
  for (int64_t s = 0; s < rowsize; ++s) {
    const size_t off = static_cast<size_t>(s) * stride;
    const I col = __ldcs(c + off);
    acc = mad(widen(__ldcs(v + off)), widen(__ldg(x + col)), acc);
  }
  if (diag != nullptr && num_columns > 0) {
    const int64_t j = i < num_columns - 1 ? i : num_columns - 1;
    acc = mad(widen(diag[i]), widen(__ldg(x + j)), acc);
  }
  if (y_in != nullptr) acc += widen(y_in[i]);
  store(y_out + i, acc);
}

template <typename V, typename I>
int launch(const void* colidx, const void* values, const void* diag,
           const void* x, const void* y_in, void* y_out, int64_t num_rows,
           int64_t padded_rows, int64_t rowsize, int64_t num_columns,
           void* stream) {
  const int64_t blocks = spmv::row_blocks(num_rows);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  ell_spmv_kernel<V, I>
      <<<static_cast<unsigned>(blocks), kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const I*>(colidx), static_cast<const V*>(values),
          static_cast<const V*>(diag), static_cast<const V*>(x),
          static_cast<const V*>(y_in), static_cast<V*>(y_out), num_rows,
          padded_rows, rowsize, num_columns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ELL_SPMV_ENTRY(NAME, V, I)                                          \
  extern "C" int NAME(const void* colidx, const void* values,              \
                      const void* diag, const void* x, const void* y_in,   \
                      void* y_out, int64_t num_rows, int64_t padded_rows,  \
                      int64_t rowsize, int64_t num_columns, void* stream) { \
    return launch<V, I>(colidx, values, diag, x, y_in, y_out, num_rows,    \
                        padded_rows, rowsize, num_columns, stream);        \
  }

ELL_SPMV_ENTRY(ell_spmv_f64_i32, double, int)
ELL_SPMV_ENTRY(ell_spmv_f64_i64, double, long long)
ELL_SPMV_ENTRY(ell_spmv_f32_i32, float, int)
ELL_SPMV_ENTRY(ell_spmv_f32_i64, float, long long)
ELL_SPMV_ENTRY(ell_spmv_bf16_i32, __nv_bfloat16, int)
ELL_SPMV_ENTRY(ell_spmv_bf16_i64, __nv_bfloat16, long long)

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
