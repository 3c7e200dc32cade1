// Fused multiply-add probe for Hopper (sm_90a): out[i] = fmaf(a[i], b[i], -p)
// with p = a[i]*b[i] rounded to float32.
//
// Replaces the TPU kernel ellspmv_tpu/ops/ell_pallas.py::
// fma_contraction_available (K7, its inner kernel k), which the fp64 path runs
// once before its first SpMV. There the probe asks whether Mosaic contracts
// a*b - p into a fused multiply-add, which decides how the double-double
// arithmetic takes its products. In CUDA C++ the fused operation is named
// (fmaf and fma, as the ELL kernel's mad() calls them), so this probe asks
// whether that operation rounds once on this card: when it does, out[i] is
// the exact residual of the product, a*b - fl(a*b), which the caller checks
// against the same residual computed in float64.
//
// One block of kThreads threads strides over the n inputs (8 x 128 = 1024
// on the fp64 path, as on the TPU). __fmul_rn keeps p a rounded product: nvcc
// may not contract it into the fmaf.
//
// Binding: a plain C entry point, loaded with ctypes; it launches on the
// stream it is given, does not synchronise, and returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
fma_probe_kernel(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ out, int64_t n) {
  for (int64_t i = threadIdx.x; i < n; i += kThreads) {
    const float p = __fmul_rn(a[i], b[i]);
    out[i] = fmaf(a[i], b[i], -p);
  }
}

}  // namespace

extern "C" int fma_probe_f32(const void* a, const void* b, void* out,
                             int64_t n, void* stream) {
  fma_probe_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
