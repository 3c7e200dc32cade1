// Segmented sums of the stream format for Hopper (sm_90a): one sum level of
// ops/stream_sum.py in one launch.
//
// Replaces the TPU kernel ellspmv_tpu/ops/stream_sum.py::_make_sum_kernel
// (K3, :65), launched there once per bucket of a level by _runsum_dd (:207)
// and _runsum_f32 (:232). A level's output is a row of subtiles of 1024
// positions (the TPU tile's 8 x 128). Each subtile u owns a list of runs in
// the level's stream, one per slot, each starting at a 128-aligned position
// with a count c of live elements. For r < 1024:
//
//   out[u * 1024 + r] = sum over the subtile's runs s, in order, of
//                       stream[start_s + r] where r < c_s
//
// (the JAX kernel's window slice, (o >> 7) + g rows into its VMEM window,
// masked by flat index < c, written as a flat read: run element r is window
// row r >> 7, lane r & 127). The host flattens a level's buckets into one
// table in CSR form: slot_ptr[u] .. slot_ptr[u+1] index the subtile's runs
// in run_start / run_count, and run_start already holds estart * 128 + o.
// The TPU kernel's grid of one step per tile (or per `sub` folded tiles),
// its double-buffered window DMA and its per-bucket launches become one grid
// of one block per subtile over the whole level, so a level costs one
// launch path instead of one per bucket.
//
// Arithmetic: native fp64 or f32, one accumulator per output, runs added in
// ascending order. The TPU kernel carries a double-double (f32 hi/lo) pair
// because the TPU has no fp64, and interleaves `nacc` accumulators to hide
// its dd-add latency; neither carries over. With one accumulator in a fixed
// order the kernel and its plain version (ops/stream_sum.stream_sum_torch)
// agree bit for bit.
//
// What bounds it: device-memory bytes. Each live stream element is read once
// and each output written once (8 B or 4 B each), plus the table; one add
// per element. Neighbouring threads take neighbouring positions r, so every
// run is read with coalesced loads from a 128-aligned start (evict-first,
// as the stream is read once), and the writes are coalesced. Subtiles with
// few runs finish early; the table lists no run of count 0.
//
// Binding: plain C entry points, one per value type, loaded with ctypes.
// Each launches on the stream it is given, does not synchronise, and returns
// cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 1024;         // outputs per subtile
constexpr int kThreads = 256;
constexpr int kPerThread = kRows / kThreads;

template <typename V>
__global__ void __launch_bounds__(kThreads)
stream_sum_kernel(const int* __restrict__ slot_ptr,
                  const int* __restrict__ run_start,
                  const int* __restrict__ run_count,
                  const V* __restrict__ stream, V* __restrict__ out) {
  const int64_t u = blockIdx.x;
  const int first = __ldg(slot_ptr + u);
  const int last = __ldg(slot_ptr + u + 1);
  V acc[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) acc[k] = V(0);
  for (int s = first; s < last; ++s) {
    const int64_t start = __ldg(run_start + s);
    const int count = __ldg(run_count + s);
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int r = threadIdx.x + k * kThreads;
      if (r < count) acc[k] += __ldcs(stream + start + r);
    }
  }
  V* o = out + u * kRows;
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) o[threadIdx.x + k * kThreads] = acc[k];
}

template <typename V>
int launch(const void* slot_ptr, const void* run_start, const void* run_count,
           const void* stream_in, void* out, int64_t num_subtiles,
           void* stream) {
  if (num_subtiles < 1 || num_subtiles > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  stream_sum_kernel<V><<<static_cast<unsigned>(num_subtiles), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(slot_ptr), static_cast<const int*>(run_start),
      static_cast<const int*>(run_count), static_cast<const V*>(stream_in),
      static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int stream_sum_f64(const void* slot_ptr, const void* run_start,
                              const void* run_count, const void* stream_in,
                              void* out, int64_t num_subtiles, void* stream) {
  return launch<double>(slot_ptr, run_start, run_count, stream_in, out,
                        num_subtiles, stream);
}

extern "C" int stream_sum_f32(const void* slot_ptr, const void* run_start,
                              const void* run_count, const void* stream_in,
                              void* out, int64_t num_subtiles, void* stream) {
  return launch<float>(slot_ptr, run_start, run_count, stream_in, out,
                       num_subtiles, stream);
}
