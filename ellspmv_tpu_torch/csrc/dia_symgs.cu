// One colour of a Gauss-Seidel sweep on a level's colour-major stencil
// values, in place (K8), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no smoother. It was added for
// HPCG's multigrid preconditioner (models/multigrid.py), whose symmetric
// Gauss-Seidel sweeps are most of a PCG iteration's matrix passes. The
// points of an nx*ny*nz grid in natural order (row (iz*ny + iy)*nx + ix)
// whose coordinates have the parities (px, py, pz) form one colour: on a
// stencil that couples only points at most 1 apart in each coordinate, no
// two of them couple, so each row of the colour is updated independently:
//
//   x[i] = (r[i] - sum_{d != diag} a[d, i] * x[i + offsets[d]]) / a[diag, i]
//                                  (terms whose column leaves [0, n) skipped)
//
// reading x of the other colours as the earlier launches left it.
//
// What bounds it: device-memory bytes. Each of the row's stored values is
// read once (8 B in fp64, 2 flops), and r, the diagonal and x once each.
// The design:
//
// - one thread owns one row of the colour; consecutive threads take
//   consecutive points of the colour along x (every other point of the
//   grid). The values come from the level's colour-major copy
//   (ops/symgs_cuda.ColourMajor): the colour's block (num_diags, count),
//   whose column t is the natural-order DIA column of thread t's row. So a
//   warp reads 32 consecutive values of each diagonal and uses every sector
//   it loads. Read from the natural-order DIA array, as K2 reads it, each
//   32-byte sector would hold two values of the colour and two of the other
//   x-parity, and a sweep would move twice the level's values. The natural
//   array stays beside the copy, since K2 multiplies it: the copy costs the
//   level's DIA storage once more. x and r stay in natural order.
// - the values are read with the evict-first hint (__ldcs): each is read
//   once a sweep, and x should keep the cache. x is read with plain loads:
//   this launch writes x (rows of its own colour only, which it never
//   reads).
// - the offsets (at most kMaxDiags) travel by value in the parameter block,
//   as in K2 (dia_spmv.cu).
// - fp64 in native fp64 FMA, one division a row.
//
// Binding: a plain C entry point, loaded with ctypes. It launches on the
// stream it is given, does not synchronise, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "spmv_common.cuh"

namespace {

using spmv::kThreads;

constexpr int kMaxDiags = 64;

struct Offsets {
  long long v[kMaxDiags];
};

// `values` is the colour's block: (num_diags, count), row-major.
__global__ void __launch_bounds__(kThreads)
dia_symgs_kernel(const double* __restrict__ values,
                 const double* __restrict__ r, double* x, int64_t nx,
                 int64_t ny, int64_t px, int64_t py, int64_t pz, int64_t hx,
                 int64_t hy, int64_t count, int64_t num_rows, int num_diags,
                 int diag_slot, const Offsets offsets) {
  const int64_t t =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= count) return;
  const int64_t ix = px + 2 * (t % hx);
  const int64_t rest = t / hx;
  const int64_t iy = py + 2 * (rest % hy);
  const int64_t iz = pz + 2 * (rest / hy);
  const int64_t i = (iz * ny + iy) * nx + ix;
  const size_t stride = static_cast<size_t>(count);
  const double* v = values + t;
  double acc = 0.0;
#pragma unroll 4
  for (int d = 0; d < num_diags; ++d) {
    if (d == diag_slot) continue;
    const double a = __ldcs(v + static_cast<size_t>(d) * stride);
    const int64_t j = i + offsets.v[d];
    if (j >= 0 && j < num_rows) acc = fma(a, x[j], acc);
  }
  x[i] = (r[i] - acc) / v[static_cast<size_t>(diag_slot) * stride];
}

}  // namespace

extern "C" int dia_symgs_f64(const void* values, const void* r, void* x,
                             int64_t nx, int64_t ny, int64_t nz, int64_t px,
                             int64_t py, int64_t pz, int64_t num_diags,
                             int64_t diag_slot, const int64_t* offsets,
                             void* stream) {
  if (num_diags < 1 || num_diags > kMaxDiags || diag_slot < 0 ||
      diag_slot >= num_diags || px < 0 || px > 1 || py < 0 || py > 1 ||
      pz < 0 || pz > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Offsets offs = {};
  for (int64_t d = 0; d < num_diags; ++d) offs.v[d] = offsets[d];
  const int64_t hx = (nx - px + 1) / 2, hy = (ny - py + 1) / 2,
                hz = (nz - pz + 1) / 2;
  const int64_t count = hx * hy * hz;
  const int64_t blocks = spmv::row_blocks(count);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  dia_symgs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(values), static_cast<const double*>(r),
      static_cast<double*>(x), nx, ny, px, py, pz, hx > 0 ? hx : 1,
      hy > 0 ? hy : 1, count, nx * ny * nz, static_cast<int>(num_diags),
      static_cast<int>(diag_slot), offs);
  return static_cast<int>(cudaGetLastError());
}
