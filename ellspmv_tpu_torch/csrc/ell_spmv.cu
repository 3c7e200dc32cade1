// ELLPACK SpMV for Hopper (sm_90a): y_out := A*x + y_in in one pass.
//
// Replaces the TPU kernel ellspmv_tpu/ops/ell_pallas.py::_make_kernel (K1),
// launched there by _run_f32 and _run_dd, together with the epilogue that XLA
// fused after it (ell_spmv_pallas: the split diagonal and y). For each row
// i < num_rows:
//
//   y_out[i] = sum_{s < rowsize} values[s, i] * x[col(s, i)]
//              + diag[i] * x[min(i, num_columns - 1)]   (when diag is given)
//              + y_in[i]                                 (when y_in is given)
//
// slots in ascending order, one fma each, then the diagonal, then y.
//
// What bounds it: device-memory bytes. Each slot costs its value (8 B in
// fp64) and its column against 2 flops, far below the card's balance point,
// plus x and y once each when the gather hits in cache. The first version
// (one thread per row, 4-byte columns, four slots unrolled) ran at 85% of
// its bytes bound and 7% behind cuSPARSE on fem_mesh_2d(1440) fp64, and
// what it moved was the problem:
//
// - The column index was a third of the bytes. In the narrow layout
//   (formats/ell.py: where every block of kLBlock rows spans fewer than
//   65,536 columns, padding slots included) each slot's column is a 16-bit
//   offset from its block's least column, col = lbase[i / kLBlock] +
//   lcol[s, i]: 2 bytes a slot instead of 4 or 8, the counterpart of the TPU
//   plan's wbase128 and int16 lcol (ops/plan.py:393-414, widened in the TPU
//   kernel at ell_pallas.py:301-310). Where a block spans more, the matrix
//   keeps its int32/int64 columns and this kernel reads those. This is the
//   gain: on 4-byte columns this kernel takes about the first version's time.
// - The loads: one thread owns two neighbouring rows, so each slot is one
//   16-byte load of values (double2; float2, bf162) and one 4-byte
//   (ushort2; int2, longlong2) load of columns per thread, and it issues
//   the loads of kSlotBatch slots, then their 2 * kSlotBatch gathers of x,
//   before any fma; the slots after the last whole batch go one at a time.
//   A block is 256 threads, 512 rows. Batches of 8 or 16, a launch bound
//   of 4 blocks per SM, or a grid-stride loop over a grid sized for the
//   132 SMs measured no faster (scripts/kernel_variants.py, PERF.md).
//
// The TPU kernel stages each tile's window of x in VMEM. Its counterpart
// here, the block's slice of x staged in shared memory by a TMA bulk copy
// and indexed by the local columns, was measured slower than this kernel's
// gather on fem_mesh_2d(1440) and on the stream format's products, and is
// not kept (PERF.md): the slice comes from L2 on top of the matrix, 64 KB of
// shared memory leave three blocks per SM, and the gather already hits in
// L1/L2.
//
// values and columns are slot-major (rowsize, padded_rows), padded_rows a
// multiple of 8, so a warp reads each slot with coalesced 16-byte loads at
// 16-byte aligned addresses. They are read with the evict-first hint
// (__ldcs): they are never read again, and x should keep the cache. x is
// gathered through the read-only path (__ldg), so the columns that
// neighbouring rows share hit in L1, and x (16.6 MB in fp64 at 2M columns)
// stays in the 50 MB L2. fp64 runs in native fp64 FMA: the TPU kernel's
// double-double arithmetic exists only because the TPU has no fp64. bf16
// storage accumulates in float32 and rounds the result to bf16, like the
// TPU kernel's f32-compute bf16 path. Offsets are computed in 64 bits.
//
// Binding: plain C entry points, one per (layout, value, index) type, all
// with one signature, loaded with ctypes. Each launches on the stream it is
// given, does not synchronise, and returns cudaGetLastError(). The host
// reads the layout's constants back (ell_spmv_rows_per_base,
// ell_spmv_narrow_span) and checks them against its own.

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

constexpr int kRowsPerThread = 2;
constexpr int kBlockRows = kThreads * kRowsPerThread;   // 512
constexpr int kLBlock = 256;      // rows per lbase entry
constexpr int kSlotBatch = 4;     // slots whose loads are in flight together

// The type that holds one value or column of two neighbouring rows.
template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Pair<int> { using type = int2; };
template <> struct Pair<long long> { using type = longlong2; };
template <> struct Pair<unsigned short> { using type = ushort2; };

// Rows i and i + 1 of each thread (i even, i < num_rows). C is the stored
// column type: a slot's column is base + the stored value, base the row
// block's lbase entry in the narrow layout (lbase non-null), else 0.
template <typename V, typename I, typename C>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const C* __restrict__ cols, const I* __restrict__ lbase,
                const V* __restrict__ values, const V* __restrict__ diag,
                const V* __restrict__ x, const V* __restrict__ y_in,
                V* __restrict__ y_out, int64_t num_rows, int64_t padded_rows,
                int64_t rowsize, int64_t num_columns) {
  using A = typename Accum<V>::type;
  using VP = typename Pair<V>::type;
  using CP = typename Pair<C>::type;
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 2;
  if (i >= num_rows) return;
  const I base = lbase != nullptr ? __ldg(lbase + i / kLBlock) : I(0);
  const size_t stride = static_cast<size_t>(padded_rows / 2);   // in pairs
  const CP* c = reinterpret_cast<const CP*>(cols + i);
  const VP* v = reinterpret_cast<const VP*>(values + i);
  A acc0 = A(0), acc1 = A(0);
  int64_t s = 0;
  for (; s + kSlotBatch <= rowsize; s += kSlotBatch) {
    CP cc[kSlotBatch];
    VP vv[kSlotBatch];
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) {
      const size_t off = static_cast<size_t>(s + k) * stride;
      cc[k] = __ldcs(c + off);
      vv[k] = __ldcs(v + off);
    }
    V x0[kSlotBatch], x1[kSlotBatch];
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) {
      x0[k] = __ldg(x + static_cast<int64_t>(base + static_cast<I>(cc[k].x)));
      x1[k] = __ldg(x + static_cast<int64_t>(base + static_cast<I>(cc[k].y)));
    }
#pragma unroll
    for (int k = 0; k < kSlotBatch; ++k) {
      acc0 = mad(widen(vv[k].x), widen(x0[k]), acc0);
      acc1 = mad(widen(vv[k].y), widen(x1[k]), acc1);
    }
  }
  for (; s < rowsize; ++s) {
    const size_t off = static_cast<size_t>(s) * stride;
    const CP cc = __ldcs(c + off);
    const VP vv = __ldcs(v + off);
    const V x0 = __ldg(x + static_cast<int64_t>(base + static_cast<I>(cc.x)));
    const V x1 = __ldg(x + static_cast<int64_t>(base + static_cast<I>(cc.y)));
    acc0 = mad(widen(vv.x), widen(x0), acc0);
    acc1 = mad(widen(vv.y), widen(x1), acc1);
  }
  const bool second = i + 1 < num_rows;
  if (diag != nullptr && num_columns > 0) {
    const int64_t last = num_columns - 1;
    acc0 = mad(widen(diag[i]), widen(__ldg(x + (i < last ? i : last))), acc0);
    acc1 = mad(widen(diag[i + 1]),
               widen(__ldg(x + (i + 1 < last ? i + 1 : last))), acc1);
  }
  if (y_in != nullptr) {
    acc0 += widen(y_in[i]);
    if (second) acc1 += widen(y_in[i + 1]);
  }
  store(y_out + i, acc0);
  if (second) store(y_out + i + 1, acc1);
}

template <typename V, typename I, typename C>
int launch(const void* cols, const void* lbase, const void* values,
           const void* diag, const void* x, const void* y_in, void* y_out,
           int64_t num_rows, int64_t padded_rows, int64_t rowsize,
           int64_t num_columns, void* stream) {
  if (padded_rows % 8 != 0 || num_rows > padded_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks =
      num_rows > 0 ? (num_rows + kBlockRows - 1) / kBlockRows : 1;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  ell_spmv_kernel<V, I, C><<<grid, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const C*>(cols), static_cast<const I*>(lbase),
      static_cast<const V*>(values), static_cast<const V*>(diag),
      static_cast<const V*>(x), static_cast<const V*>(y_in),
      static_cast<V*>(y_out), num_rows, padded_rows, rowsize, num_columns);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wide: cols are the int32/int64 colidx and lbase is null; narrow: cols
// are the uint16 lcol and lbase the blocks' bases. One signature for all.
#define ELL_SPMV_ENTRY(NAME, V, I, C)                                        \
  extern "C" int NAME(const void* cols, const void* lbase,                  \
                      const void* values, const void* diag, const void* x,  \
                      const void* y_in, void* y_out, int64_t num_rows,      \
                      int64_t padded_rows, int64_t rowsize,                 \
                      int64_t num_columns, void* stream) {                  \
    return launch<V, I, C>(cols, lbase, values, diag, x, y_in, y_out,      \
                           num_rows, padded_rows, rowsize, num_columns,    \
                           stream);                                         \
  }

#define ELL_SPMV_ENTRIES(VTAG, V)                                           \
  ELL_SPMV_ENTRY(ell_spmv_##VTAG##_i32, V, int, int)                       \
  ELL_SPMV_ENTRY(ell_spmv_##VTAG##_i64, V, long long, long long)           \
  ELL_SPMV_ENTRY(ell_spmv_narrow_##VTAG##_i32, V, int, unsigned short)     \
  ELL_SPMV_ENTRY(ell_spmv_narrow_##VTAG##_i64, V, long long, unsigned short)

ELL_SPMV_ENTRIES(f64, double)
ELL_SPMV_ENTRIES(f32, float)
ELL_SPMV_ENTRIES(bf16, __nv_bfloat16)

// Rows per lbase entry, and the column span below which a block's offsets
// fit the narrow layout's uint16.
extern "C" int ell_spmv_rows_per_base() { return kLBlock; }
extern "C" int ell_spmv_narrow_span() {
  return 1 << (8 * sizeof(unsigned short));
}

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
