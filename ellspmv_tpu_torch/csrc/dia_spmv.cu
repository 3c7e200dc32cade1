// DIA SpMV for Hopper (sm_90a): y_out := A*x + y_in in one pass.
//
// Replaces the TPU kernel ellspmv_tpu/ops/dia_pallas.py::_make_dia_kernel
// (K2), launched there by _dia_run_dd and _dia_run_f32, together with the
// y epilogue that dia_spmv_pallas adds after it. For each row i < num_rows:
//
//   y_out[i] = sum_{d < num_diags} data[d, i] * x[i + offsets[d]]
//                                  (terms whose column leaves [0, m) skipped)
//              + y_in[i]           (when y_in is given)
//
// What bounds it: device-memory bytes. Each stored value costs its 8 B
// (fp64) against 2 flops and no index at all, plus x and y once each when
// the shifted reads of x hit in cache. So the design moves those bytes once:
//
// - data is (num_diags, num_rows), row-contiguous per diagonal. One thread
//   owns one row; a warp reads 32 consecutive rows of a diagonal with one
//   coalesced load. In the general form each value is read once, with the
//   evict-first hint (__ldcs), so that x keeps the cache.
// - x[i + off] is a coalesced shifted read through the read-only path
//   (__ldg). Neighbouring diagonals of one warp share cache lines in L1, and
//   x (16.6 MB in fp64 at 2M columns) fits the 50 MB L2, so its re-reads
//   across diagonals should not reach device memory.
// - The column is guarded: the first and last |off| rows of a diagonal
//   point outside [0, num_columns), where data holds 0 and x must not be
//   read.
// - The symmetric form, for a square matrix whose diagonal -e holds
//   diagonal +e's values bit for bit (formats/dia.py::mirrored, checked once
//   on the host): the offsets ascend in +-e pairs, so term d < lower (offset
//   -e) reads diagonal num_diags - 1 - d (offset +e) at row i - e, its
//   column, where it holds data[d, i]. So only the offsets >= 0 come from
//   device memory, each value read twice: at row i, and e rows later. The
//   re-read reaches back e rows (5,222 at lynx68, 65,793 in HPCG at 256^3:
//   0.5 and 7.4 MB of values), well inside L2. Both loads take the
//   read-only path (__ldg), whose lines stay in L2 (and in L1 for small e):
//   on an H100, an evict-first re-read (__ldcs) made K2 0.494 against 0.335
//   ms at lynx68, and one loop whose hint changed with the term's sign kept
//   the unrolled loads apart (0.412 ms; scripts/kernel_variants.py). So the
//   mirrored terms take a loop of their own, and the loop over the offsets
//   >= 0 is the general form's with the hint chosen at compile time. The
//   terms, their order and their operands are the general form's, so y is
//   the same bit for bit.
// - The offsets (at most kMaxDiags, the TPU kernel's MAX_DIAGS) travel by
//   value in the kernel's parameter block (516 B of the 4 KB allowed).
// - fp64 runs in native fp64 FMA, bf16 storage accumulates in float32 and
//   rounds once (spmv_common.cuh). y is fused in.
//
// The TPU kernel's roll/select per diagonal, its resident and windowed x
// staging in VMEM and its double-double arithmetic exist for the TPU's
// memory and types; on Hopper the cache stages x, so this kernel takes the
// plain DIA arrays.
//
// Binding: plain C entry points, one per value type, loaded with ctypes.
// Each launches on the stream it is given, does not synchronise, and
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

constexpr int kMaxDiags = 64;

struct Terms {
  long long offset[kMaxDiags];
  int lower;    // the terms with offset < 0, read mirrored (symmetric form)
};

template <typename V, bool kSymmetric>
__global__ void __launch_bounds__(kThreads)
dia_spmv_kernel(const V* __restrict__ data, const V* __restrict__ x,
                const V* __restrict__ y_in, V* __restrict__ y_out,
                int64_t num_rows, int64_t num_columns, int num_diags,
                const Terms terms) {
  using A = typename Accum<V>::type;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= num_rows) return;
  const size_t stride = static_cast<size_t>(num_rows);
  const V* v = data + i;
  A acc = A(0);
  int d = 0;
  if (kSymmetric) {
    // Term d (offset -e) reads row j = i - e of the +e diagonal (row 0
    // where j < 0, which the guard drops).
#pragma unroll 4
    for (; d < terms.lower; ++d) {
      const int64_t j = i + terms.offset[d];
      const V a = __ldg(data + static_cast<size_t>(num_diags - 1 - d) *
                                   stride + (j > 0 ? j : 0));
      if (j >= 0 && j < num_columns) {
        acc = mad(widen(a), widen(__ldg(x + j)), acc);
      }
    }
  }
  // The terms that read their own diagonal: each value's only read in the
  // general form, its first in the symmetric form.
#pragma unroll 4
  for (; d < num_diags; ++d) {
    const V* p = v + static_cast<size_t>(d) * stride;
    const V a = kSymmetric ? __ldg(p) : __ldcs(p);
    const int64_t j = i + terms.offset[d];
    if (j >= 0 && j < num_columns) {
      acc = mad(widen(a), widen(__ldg(x + j)), acc);
    }
  }
  if (y_in != nullptr) acc += widen(y_in[i]);
  store(y_out + i, acc);
}

// `symmetric` nonzero takes the symmetric form, which needs a square matrix
// whose offsets ascend in +-e pairs: term d < lower then reads a row in
// [0, i] of diagonal num_diags - 1 - d, and those terms come first.
template <typename V>
int launch(const void* data, const void* x, const void* y_in, void* y_out,
           int64_t num_rows, int64_t num_columns, int64_t num_diags,
           const int64_t* offsets, int64_t symmetric, void* stream) {
  if (num_diags < 0 || num_diags > kMaxDiags)
    return static_cast<int>(cudaErrorInvalidValue);
  if (symmetric && num_rows != num_columns)
    return static_cast<int>(cudaErrorInvalidValue);
  Terms terms = {};
  for (int64_t d = 0; d < num_diags; ++d) {
    terms.offset[d] = offsets[d];
    if (symmetric) {
      if ((d > 0 && offsets[d] <= offsets[d - 1]) ||
          offsets[d] != -offsets[num_diags - 1 - d])
        return static_cast<int>(cudaErrorInvalidValue);
      terms.lower += offsets[d] < 0;
    }
  }
  const int64_t blocks = spmv::row_blocks(num_rows);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel =
      symmetric ? dia_spmv_kernel<V, true> : dia_spmv_kernel<V, false>;
  kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const V*>(data), static_cast<const V*>(x),
      static_cast<const V*>(y_in), static_cast<V*>(y_out), num_rows,
      num_columns, static_cast<int>(num_diags), terms);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define DIA_SPMV_ENTRY(NAME, V)                                             \
  extern "C" int NAME(const void* data, const void* x, const void* y_in,   \
                      void* y_out, int64_t num_rows, int64_t num_columns,  \
                      int64_t num_diags, const int64_t* offsets,           \
                      int64_t symmetric, void* stream) {                   \
    return launch<V>(data, x, y_in, y_out, num_rows, num_columns,          \
                     num_diags, offsets, symmetric, stream);               \
  }

DIA_SPMV_ENTRY(dia_spmv_f64, double)
DIA_SPMV_ENTRY(dia_spmv_f32, float)
DIA_SPMV_ENTRY(dia_spmv_bf16, __nv_bfloat16)
