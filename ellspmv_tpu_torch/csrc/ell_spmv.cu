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
// slots in ascending order, one fma each, then the diagonal, then y; in the
// sliced layout the sum stops at the row's slice's width.
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
//   A block is kThreads (256) threads, 512 rows, on the padded layout. Batches of 8
//   or 16, a launch bound of 4 blocks per SM, or a grid-stride loop over a
//   grid sized for the 132 SMs measured no faster there
//   (scripts/kernel_variants.py, PERF.md).
// - The padding. The whole matrix pads every row to its longest, so a
//   matrix whose rows differ in length moves 2-3x its nonzeros' bytes. In
//   the sliced layout (formats/ell.py, where it stores fewer slots) the
//   rows of each window of kWindow rows are put in order by length, longest
//   first, and each slice of kSliceRows consecutive rows in that order
//   stores only as many slots as its own longest row, slot-major, at its
//   own offset: a row keeps its entries at the same slot numbers in the
//   same order and loses only trailing padding slots, each of which added
//   0 * x, so y is the padded layout's (up to the sign of a zero). Each
//   position also reads its row's number within the window (2 bytes) and
//   its slice's width and offset, and reads y and the diagonal and writes
//   y at that row. No row leaves its window, so x keeps the locality of the
//   matrix's numbering.
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
// multiple of 8, or slot-major within each slice, so a warp reads each
// slot with coalesced 16-byte loads at 16-byte aligned addresses. They are
// read with the evict-first hint (__ldcs): they are never read again, and
// x should keep the cache. x is gathered through the read-only path
// (__ldg), so the columns that neighbouring rows share hit in L1, and x
// (16.6 MB in fp64 at 2M columns) stays in the 50 MB L2. fp64 runs in
// native fp64 FMA: the TPU kernel's double-double arithmetic exists only
// because the TPU has no fp64. bf16 storage accumulates in float32 and
// rounds the result to bf16, like the TPU kernel's f32-compute bf16 path.
// Offsets are computed in 64 bits.
//
// Binding: plain C entry points, one per (layout, value, index) type, all
// with one signature, loaded with ctypes. Each launches on the stream it is
// given, does not synchronise, and returns cudaGetLastError(). The host
// reads the layout's constants back (ell_spmv_rows_per_base,
// ell_spmv_narrow_span, ell_spmv_slice_rows, ell_spmv_slice_window) and
// checks them against its own.

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
constexpr int kLBlock = 256;      // rows per lbase entry
constexpr int kSlotBatch = 4;     // slots whose loads are in flight together
constexpr int kSliceRows = 32;    // rows per slice of the sliced layout
constexpr int kWindow = 512;      // rows ordered by length within one window
constexpr int kSlicedThreads = 64; // threads per block, sliced

// The type that holds one value or column of two neighbouring rows.
template <typename T> struct Pair;
template <> struct Pair<double> { using type = double2; };
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Pair<int> { using type = int2; };
template <> struct Pair<long long> { using type = longlong2; };
template <> struct Pair<unsigned short> { using type = ushort2; };

// Positions i and i + 1 of each thread (i even). C is the stored column
// type: a slot's column is base + the stored value, base the lbase entry of
// position i's block of kLBlock positions in the narrow layout (lbase
// non-null), else 0.
//
// Padded layout: position i is row i, i < num_rows; the slots of row i lie
// at s * padded_rows + i, s < rowsize.
// Sliced layout: position i < padded_rows lies in slice i / kSliceRows,
// whose slots lie at slice_start[slice] + s * kSliceRows + i % kSliceRows,
// s < slice_width[slice], and holds row (i / kWindow) * kWindow +
// row_ids[i]; a row at num_rows or past it is padding and stores nothing.
template <typename V, typename I, typename C, bool kSliced>
__device__ __forceinline__ void spmv_pair(
    const C* __restrict__ cols, const I* __restrict__ lbase,
    const V* __restrict__ values, const int* __restrict__ slice_width,
    const int64_t* __restrict__ slice_start,
    const unsigned short* __restrict__ row_ids, const V* __restrict__ diag,
    const V* __restrict__ x, const V* __restrict__ y_in,
    V* __restrict__ y_out, int64_t num_rows, int64_t padded_rows,
    int64_t rowsize, int64_t num_columns) {
  using A = typename Accum<V>::type;
  using VP = typename Pair<V>::type;
  using CP = typename Pair<C>::type;
  const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) * 2;
  int64_t row0 = i, row1 = i + 1, first = i, width = rowsize;
  size_t stride = static_cast<size_t>(padded_rows / 2);   // in pairs
  if constexpr (kSliced) {
    if (i >= padded_rows) return;
    const int64_t slice = i / kSliceRows;
    width = __ldg(slice_width + slice);
    first = __ldg(slice_start + slice) + i % kSliceRows;
    stride = kSliceRows / 2;
    const ushort2 ids = __ldg(reinterpret_cast<const ushort2*>(row_ids + i));
    const int64_t window = i / kWindow * kWindow;
    row0 = window + ids.x;
    row1 = window + ids.y;
  } else {
    if (i >= num_rows) return;
  }
  const I base = lbase != nullptr ? __ldg(lbase + i / kLBlock) : I(0);
  const CP* c = reinterpret_cast<const CP*>(cols + first);
  const VP* v = reinterpret_cast<const VP*>(values + first);
  A acc0 = A(0), acc1 = A(0);
  int64_t s = 0;
  for (; s + kSlotBatch <= width; s += kSlotBatch) {
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
  for (; s < width; ++s) {
    const size_t off = static_cast<size_t>(s) * stride;
    const CP cc = __ldcs(c + off);
    const VP vv = __ldcs(v + off);
    const V x0 = __ldg(x + static_cast<int64_t>(base + static_cast<I>(cc.x)));
    const V x1 = __ldg(x + static_cast<int64_t>(base + static_cast<I>(cc.y)));
    acc0 = mad(widen(vv.x), widen(x0), acc0);
    acc1 = mad(widen(vv.y), widen(x1), acc1);
  }
  if (diag != nullptr && num_columns > 0) {
    const int64_t last = num_columns - 1;
    acc0 = mad(widen(diag[row0]),
               widen(__ldg(x + (row0 < last ? row0 : last))), acc0);
    acc1 = mad(widen(diag[row1]),
               widen(__ldg(x + (row1 < last ? row1 : last))), acc1);
  }
  if (row0 < num_rows) {
    if (y_in != nullptr) acc0 += widen(y_in[row0]);
    store(y_out + row0, acc0);
  }
  if (row1 < num_rows) {
    if (y_in != nullptr) acc1 += widen(y_in[row1]);
    store(y_out + row1, acc1);
  }
}

// The padded layout, in blocks of kThreads.
template <typename V, typename I, typename C>
__global__ void __launch_bounds__(kThreads)
ell_spmv_kernel(const C* __restrict__ cols, const I* __restrict__ lbase,
                const V* __restrict__ values, const V* __restrict__ diag,
                const V* __restrict__ x, const V* __restrict__ y_in,
                V* __restrict__ y_out, int64_t num_rows, int64_t padded_rows,
                int64_t rowsize, int64_t num_columns) {
  spmv_pair<V, I, C, false>(cols, lbase, values, nullptr, nullptr, nullptr,
                            diag, x, y_in, y_out, num_rows, padded_rows,
                            rowsize, num_columns);
}

// The sliced layout, in blocks of kSlicedThreads: on NPB CG's class C
// matrix (293 windows on 132 SMs) blocks of 256 leave some SMs a third
// window, and on rgg_n_2_24 the size moved it by under 1%. Its registers
// are held to what 16 such blocks leave each thread (64; it takes 56-64),
// which made it 12% faster on the NPB matrix and 4.6% on rgg_n_2_24; 12 or
// 24 blocks were no better on both (scripts/kernel_variants.py, PERF.md).
template <typename V, typename I, typename C>
__global__ void __launch_bounds__(kSlicedThreads, 16)
ell_spmv_kernel_sliced(const C* __restrict__ cols,
                       const I* __restrict__ lbase,
                       const V* __restrict__ values,
                       const int* __restrict__ slice_width,
                       const int64_t* __restrict__ slice_start,
                       const unsigned short* __restrict__ row_ids,
                       const V* __restrict__ diag, const V* __restrict__ x,
                       const V* __restrict__ y_in, V* __restrict__ y_out,
                       int64_t num_rows, int64_t padded_rows,
                       int64_t num_columns) {
  spmv_pair<V, I, C, true>(cols, lbase, values, slice_width, slice_start,
                           row_ids, diag, x, y_in, y_out, num_rows,
                           padded_rows, 0, num_columns);
}

template <typename V, typename I, typename C>
int launch(const void* cols, const void* lbase, const void* values,
           const void* slice_width, const void* slice_start,
           const void* row_ids, const void* diag, const void* x,
           const void* y_in, void* y_out, int64_t num_rows,
           int64_t padded_rows, int64_t rowsize, int64_t num_columns,
           void* stream) {
  const bool sliced = slice_width != nullptr;
  if (padded_rows % 8 != 0 || num_rows > padded_rows ||
      sliced != (slice_start != nullptr) || sliced != (row_ids != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t threads = sliced ? kSlicedThreads : kThreads;
  // positions: the rows, or every padded row of the slices
  const int64_t positions = sliced ? padded_rows : num_rows;
  const int64_t rows_per_block = threads * kRowsPerThread;
  const int64_t blocks =
      positions > 0 ? (positions + rows_per_block - 1) / rows_per_block : 1;
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const auto grid = static_cast<unsigned>(blocks);
  const auto block = static_cast<unsigned>(threads);
  const auto on = static_cast<cudaStream_t>(stream);
  if (sliced) {
    ell_spmv_kernel_sliced<V, I, C><<<grid, block, 0, on>>>(
        static_cast<const C*>(cols), static_cast<const I*>(lbase),
        static_cast<const V*>(values), static_cast<const int*>(slice_width),
        static_cast<const int64_t*>(slice_start),
        static_cast<const unsigned short*>(row_ids),
        static_cast<const V*>(diag), static_cast<const V*>(x),
        static_cast<const V*>(y_in), static_cast<V*>(y_out), num_rows,
        padded_rows, num_columns);
  } else {
    ell_spmv_kernel<V, I, C><<<grid, block, 0, on>>>(
        static_cast<const C*>(cols), static_cast<const I*>(lbase),
        static_cast<const V*>(values), static_cast<const V*>(diag),
        static_cast<const V*>(x), static_cast<const V*>(y_in),
        static_cast<V*>(y_out), num_rows, padded_rows, rowsize,
        num_columns);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// wide: cols are the int32/int64 colidx and lbase is null; narrow: cols
// are the uint16 lcol and lbase the blocks' bases. slice_width,
// slice_start and row_ids are all null (the padded layout) or all given (the
// sliced layout). One signature for all.
#define ELL_SPMV_ENTRY(NAME, V, I, C)                                        \
  extern "C" int NAME(const void* cols, const void* lbase,                  \
                      const void* values, const void* slice_width,          \
                      const void* slice_start, const void* row_ids,         \
                      const void* diag, const void* x, const void* y_in,    \
                      void* y_out, int64_t num_rows, int64_t padded_rows,   \
                      int64_t rowsize, int64_t num_columns, void* stream) { \
    return launch<V, I, C>(cols, lbase, values, slice_width, slice_start,   \
                           row_ids, diag, x, y_in, y_out, num_rows,         \
                           padded_rows, rowsize, num_columns, stream);      \
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
// fit the narrow layout's uint16; the sliced layout's rows per slice and
// per window.
extern "C" int ell_spmv_rows_per_base() { return kLBlock; }
extern "C" int ell_spmv_slice_rows() { return kSliceRows; }
extern "C" int ell_spmv_slice_window() { return kWindow; }
extern "C" int ell_spmv_narrow_span() {
  return 1 << (8 * sizeof(unsigned short));
}

extern "C" const char* ell_spmv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
