// fp64 dot product for Hopper (sm_90a): out = sum_i x[i] * y[i].
//
// Replaces the TPU kernel ellspmv_tpu/ops/dd_reduce.py::_dot_kernel (K6),
// launched there by _run_dot for dd_vdot and dd_vdot_split, which the fp64
// CG solver calls twice per iteration. The TPU kernel walks the vectors in
// (8, 128) blocks, one grid step each, carries a double-double (f32 hi/lo)
// accumulator of 1024 partial sums in VMEM from step to step, and leaves the
// final sum of those 1024 partials to XLA. The double-double arithmetic
// exists only because the TPU has no fp64; this card has it, so the kernel
// takes fp64 vectors and accumulates with native fma.
//
// What bounds it: device-memory bytes, 16 B read per element against 2 flops
// (at 2,073,600 elements, 33 MB or 9.9 us at 3.35 TB/s). At that size a
// launch's latency is a large share of the time, so the design is kept
// simple and right rather than fast.
//
// Design. Blocks run in parallel and in no order, so nothing can carry a
// sum from one block to the next as the TPU grid does. Instead:
//
// 1. dot_partial_kernel: a fixed partition. The number of blocks depends on
//    n alone (one per kThreads elements, at most the caller's partials
//    capacity); each thread sums its grid-stride share with fma in a fixed
//    order, each warp reduces with shuffles, and the warps' sums meet in
//    shared memory; block b writes partials[b].
// 2. dot_final_kernel: one block sums the partials in the same way and
//    writes out. This is the counterpart of the XLA sum of the 1024 partials.
//
// No atomics: the order of every addition depends on n alone, so the result
// is the same, bit for bit, from launch to launch (a CG run's iteration count
// then repeats). Any n >= 0 works; n = 0 gives 0.
//
// Binding: a plain C entry point, loaded with ctypes. It launches both
// kernels on the stream it is given, does not synchronise, and returns
// cudaGetLastError(). The caller allocates the partials (capacity entries)
// and the output.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The sum of v over the block, in thread 0; the order is fixed.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kWarps];
  for (int offset = 16; offset > 0; offset >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, offset);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  v = 0.0;
  if (warp == 0) {
    v = lane < kWarps ? warp_sums[lane] : 0.0;
    for (int offset = 16; offset > 0; offset >>= 1)
      v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
dot_partial_kernel(const double* __restrict__ x, const double* __restrict__ y,
                   double* __restrict__ partials, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  double acc = 0.0;
#pragma unroll 4
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride)
    acc = fma(__ldg(x + i), __ldg(y + i), acc);
  acc = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

__global__ void __launch_bounds__(kThreads)
dot_final_kernel(const double* __restrict__ partials, int num_partials,
                 double* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < num_partials; i += kThreads)
    acc += partials[i];
  acc = block_sum(acc);
  if (threadIdx.x == 0) *out = acc;
}

}  // namespace

extern "C" int dot_f64(const void* x, const void* y, void* partials,
                       void* out, int64_t n, int64_t capacity, void* stream) {
  if (n < 0 || capacity < 1 || capacity > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t per_thread_block = (n + kThreads - 1) / kThreads;
  const int blocks = static_cast<int>(
      per_thread_block < 1 ? 1
                           : (per_thread_block < capacity ? per_thread_block
                                                          : capacity));
  const auto s = static_cast<cudaStream_t>(stream);
  dot_partial_kernel<<<blocks, kThreads, 0, s>>>(
      static_cast<const double*>(x), static_cast<const double*>(y),
      static_cast<double*>(partials), n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dot_final_kernel<<<1, kThreads, 0, s>>>(static_cast<const double*>(partials),
                                          blocks, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}
