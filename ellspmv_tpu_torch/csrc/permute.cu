// Static stream permutation for Hopper (sm_90a): out[j] = in[src[j]], and 0
// where src[j] < 0.
//
// Replaces two TPU kernel pairs that compute the same static permutation
// out[target[k]] = in[k] of the stream format's value streams:
//
// - K4, ellspmv_tpu/ops/permute.py::_make_w1_kernel (:531, launched by _w1)
//   and ::_make_w2_kernel (:547, launched by _w2), with the XLA row take
//   between them (apply_permute, :774);
// - K5, the uniform-cell pair ::_make_w1_cells_kernel (:600, _w1_cells) and
//   ::_make_w2_cells_kernel (:665, _w2_cells), where W1 writes the middle
//   array destination-major and so replaces the take.
//
// The TPU has no sublane gather, so the JAX package routes every element
// through lane gathers and (128, 128) transposes, steered by int8/int16 maps
// from two bipartite edge colourings planned on the host, with half-block
// budgets that force a reorder of the stream. This card has a gather: the
// host composes the inverse map once (ops/permute.py gather_from_targets,
// src[target[k]] = k), and one thread per output moves one element. A fp64
// payload moves as one value, where the TPU routes the hi and lo halves of
// its double-double pair separately. On the stream path it delivers each
// row's sum from the sum levels' output buffer into row order; the levels'
// own inputs arrive by the products' layout (formats/stream.py) and by K3's
// map loads (csrc/stream_sum.cu).
//
// What bounds it: device-memory bytes. Per output, 4 B of src and one value
// written, plus one value read where src >= 0; no arithmetic. The design
// keeps every access that can be coalesced coalesced: src and out are read
// and written by neighbouring threads at neighbouring addresses (src with
// the evict-first hint, as it is read once), and only the payload read is a
// gather, through the read-only path. Each output is written exactly once,
// so no atomics and no ordering are needed.
//
// Binding: plain C entry points, one per payload width (fp64, f32, and one
// 16-bit instance that moves bf16 bit patterns, for the hybrid format's
// gather of a bf16 x), loaded with ctypes.
// Each launches on the stream it is given, does not synchronise, and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

#include "spmv_common.cuh"

namespace {

using spmv::kThreads;

template <typename V>
__global__ void __launch_bounds__(kThreads)
permute_kernel(const int* __restrict__ src, const V* __restrict__ in,
               V* __restrict__ out, int64_t n_out) {
  const int64_t j =
      static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (j >= n_out) return;
  const int s = __ldcs(src + j);
  out[j] = s >= 0 ? __ldg(in + s) : V(0);
}

template <typename V>
int launch(const void* src, const void* in, void* out, int64_t n_out,
           void* stream) {
  if (n_out < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = spmv::row_blocks(n_out);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  permute_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(src), static_cast<const V*>(in),
      static_cast<V*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int permute_f64(const void* src, const void* in, void* out,
                           int64_t n_out, void* stream) {
  return launch<double>(src, in, out, n_out, stream);
}

extern "C" int permute_f32(const void* src, const void* in, void* out,
                           int64_t n_out, void* stream) {
  return launch<float>(src, in, out, n_out, stream);
}

extern "C" int permute_b16(const void* src, const void* in, void* out,
                           int64_t n_out, void* stream) {
  return launch<unsigned short>(src, in, out, n_out, stream);
}
