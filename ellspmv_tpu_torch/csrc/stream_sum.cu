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
// over the whole level (eight blocks per subtile, below), so a level costs
// one launch path instead of one per bucket.
//
// Arithmetic: native fp64 or f32, one accumulator per output, runs added in
// ascending order. The TPU kernel carries a double-double (f32 hi/lo) pair
// because the TPU has no fp64, and interleaves `nacc` accumulators to hide
// its dd-add latency; neither carries over. With one accumulator in a fixed
// order the kernel and its plain version (ops/stream_sum.stream_sum_torch)
// agree bit for bit. (A masked run adds +0.0, which leaves every sum as it
// is: an accumulator that starts at +0.0 never holds -0.0.)
//
// What bounds it: device-memory bytes, one read of each live stream element
// and one write of each output, plus the table; one add per element. The
// first version (one block of 256 threads per 1024-output subtile, each
// block walking its runs one after another) reached 29% of that bound on
// config3's level 1 and 3% on level 2: its time followed the longest block,
// not the bytes. A subtile holds 1 to 128 runs, and each step of a block's
// walk was a chain of dependent loads (the run's start and count, then the
// stream, then the add), with nothing of the next run in flight; level 2 has
// 68 subtiles for 132 SMs. The design answers each:
//
// - The grid is split by outputs, not subtiles: a block takes an eighth of
//   a subtile, 128 outputs, one per thread, and only the runs whose count
//   reaches its first output (a run is prefix-masked, so the others add
//   nothing there). The long subtiles' dead tails cost nothing and level
//   2's 68 subtiles become 544 blocks.
// - Blocks launch longest first: the host orders them by live positions,
//   descending (`order`, the part at each launch position, with its
//   first run and run count beside it), so the long blocks start in the
//   first wave and the short ones fill in behind them. Outputs still land
//   at fixed places.
// - The block's run table (start, count) is loaded into shared memory once.
//   Each thread reads a batch of kBatch runs' starts and counts from it
//   (8 in fp64, 4 in f32), then issues their loads of the stream into
//   registers, each under a predicate (r < count) and not a branch, then
//   adds them in order: a batch costs one trip to shared memory and one to
//   device memory. (With a branch per run, ptxas put two dependent
//   shared-memory reads in front of every load, and a block's time grew by
//   one such chain per run: config3's level 2, whose longest block reads
//   128 runs, took 12 us.) A block waits on its place, its table, then the
//   stream, a batch a round, where the first version waited on two loads
//   per run.
//
// The first version's f32 ran slower than its fp64 (config3 level 1: 0.1088
// against 0.0702 ms): ptxas scheduled each f32 run's first add right after
// its load and loaded the next output's element into the same register, so
// an f32 run took two trips to memory where fp64 issued its four loads
// together. Here the kBatch loads go into an array before any add, in both
// types.
//
// Neighbouring threads take neighbouring positions, so each run is read with
// coalesced loads from a 128-aligned start (evict-first, as the stream is
// read once), and the writes are coalesced.
//
// Reading through a map (the stream_sum_src_* entry points). A deeper
// level's input is the level before's outputs in another order: position p
// of the level holds in[src[p]]. (The TPU moves the values there first, with
// the route of ellspmv_tpu/ops/permute.py: K4, _make_w1_kernel :531 and
// _make_w2_kernel :547, and the XLA take between them.) K3 reads src[p]
// where the in-place form reads stream[p] (coalesced, evict-first: the map
// is read once), then in[src[p]] through the read-only path, both under the
// run's predicate. A batch's value loads go out together with the next
// batch's map loads (kMapBatch runs each), all before the batch's first add,
// so that a batch does not wait on two trips to memory (timed against that
// form with scripts/kernel_variants.py). The adds and their order are the
// in-place form's, so the result is bit-equal to the plain version
// (ops/stream_sum.py stream_sum_torch with src). Two conditions, which the
// host's plan holds, make this safe:
// - no map entry under a run's predicate is -1: the plan refuses a map in
//   which a position below a run's count has no source (_check_sources);
// - the output and the sources it reads are disjoint: each level writes its
//   own slice of one buffer and reads only the slice of the level before,
//   as the read-only loads need.
//
// The products form (the stream_sum_prod_* entry points). Level 1's input
// is the stream format's products a_k * x[col_k], laid out in its position
// order on the host (formats/stream.py). They used to reach K3 through
// device memory: K1 over the products' rowsize-1 ELL (csrc/ell_spmv.cu)
// read each value and column, gathered x and wrote each product, and K3 in
// place read the product back, in the same order, in the next launch: 28
// bytes a position in fp64 (K1's 8 + 4 read and 8 written, K3's 8 read), and
// two launches. Here K3 reads position p as values[p] * x[col(p)] itself:
// col(p) is the products' int32 column, or in the narrow layout (where every
// block of kLBlock positions spans fewer than 65,536 columns)
// lbase[p / kLBlock] + the uint16 lcol[p]. That is 12 bytes a position
// (6 + the block's base, narrow) plus x, which a column chunk keeps in L2,
// and one launch. Values and columns are read evict-first, as the stream
// was; x through the read-only path. A batch's gathers of x go out with
// the next batch's value and column loads, all before the batch's first
// multiply. Batches of kProdBatch = 4 runs, timed with
// scripts/kernel_variants.py on an H100 80GB HBM3 at 700 W: level 1 of
// the Graph500 graph at SCALE 21 (63.7M positions, fp64) took 0.5075 ms
// at 4, 0.5022 at 2, 0.5209 at 8 and 0.6160 at 16; config3's 0.0654 ms
// at 4 and 0.0694 at 8. No batch or load order moved it far: what bounds
// it is the gathers of x, one 32-byte L2 sector each, not the bytes. Its
// f32 form, with a third fewer bytes, takes 0.4535 ms; K1 over the same
// products, the same gathers, took about 0.5 ms alone, and K1 then K3 in
// place 0.6978 ms.
//
// The result is K1 then K3 in place, bit for bit. K1 forms each product as
// fma(v, x, +0.0), which is v * x rounded once (and +0.0 for a product of
// -0.0, which no sum can tell apart: an accumulator that starts at +0.0
// never holds -0.0). So the product here is an explicit round-to-nearest
// multiply (__dmul_rn, __fmul_rn), which nvcc does not contract with the
// add that follows into an fma, and the runs are added in the in-place
// form's order. Alignment gaps (value 0, the column of the slot before)
// lie outside every run's count and are not read.
//
// Binding: plain C entry points, one per value type and form, loaded with
// ctypes. Each launches on the stream it is given, does not synchronise, and
// returns cudaGetLastError(). The output may be a slice of a larger buffer
// that also holds the map's sources, at other addresses. The host reads the
// grid's constants back (stream_sum_rows, stream_sum_parts,
// stream_sum_rows_per_base) and checks its table and layout against them.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 1024;         // outputs per subtile
constexpr int kParts = 8;           // blocks per subtile
constexpr int kThreads = kRows / kParts;   // one output each
// runs whose loads are in flight together, by value type (measured with
// scripts/kernel_variants.py)
template <typename V>
constexpr int kBatch = sizeof(V) == 8 ? 8 : 4;
constexpr int kMapBatch = 8;        // the same, read through a map
constexpr int kProdBatch = 4;       // the same, read as products
constexpr int kTable = kThreads;    // runs staged in shared memory at a time
constexpr int kLBlock = 256;        // positions per lbase entry (narrow)

// How a level's position p is read: stream[p] (level 1 given in position
// order), stream[src[p]] (a deeper level, through its map), or
// stream[p] * x[col(p)] (level 1 as products; stream holds the values).
constexpr int kInPlace = 0;
constexpr int kThroughMap = 1;
constexpr int kProducts = 2;

// The stream element at a where p holds, else +0.0: an evict-first load
// under a predicate, not a branch, so that a batch's loads all issue before
// its first add.
__device__ __forceinline__ double load_if(bool p, const double* a) {
  double v = 0.0;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.cs.f64 %0, [%1];\n}"
      : "+d"(v)
      : "l"(a), "r"(static_cast<unsigned>(p)));
  return v;
}
__device__ __forceinline__ float load_if(bool p, const float* a) {
  float v = 0.0f;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.cs.f32 %0, [%1];\n}"
      : "+f"(v)
      : "l"(a), "r"(static_cast<unsigned>(p)));
  return v;
}
__device__ __forceinline__ int load_if(bool p, const int* a) {
  int v = 0;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.cs.s32 %0, [%1];\n}"
      : "+r"(v)
      : "l"(a), "r"(static_cast<unsigned>(p)));
  return v;
}

__device__ __forceinline__ unsigned short load_if(bool p,
                                                  const unsigned short* a) {
  unsigned short v = 0;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.cs.u16 %0, [%1];\n}"
      : "+h"(v)
      : "l"(a), "r"(static_cast<unsigned>(p)));
  return v;
}

// The value at a where p holds, else +0.0, through the read-only path (the
// gathered reads of the map's sources and of x, the narrow bases).
__device__ __forceinline__ double load_nc_if(bool p, const double* a) {
  double v = 0.0;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.nc.f64 %0, [%1];\n}"
      : "+d"(v)
      : "l"(a), "r"(static_cast<unsigned>(p)));
  return v;
}
__device__ __forceinline__ float load_nc_if(bool p, const float* a) {
  float v = 0.0f;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.nc.f32 %0, [%1];\n}"
      : "+f"(v)
      : "l"(a), "r"(static_cast<unsigned>(p)));
  return v;
}

__device__ __forceinline__ int load_nc_if(bool p, const int* a) {
  int v = 0;
  asm("{\n .reg .pred q;\n setp.ne.u32 q, %2, 0;\n"
      " @q ld.global.nc.s32 %0, [%1];\n}"
      : "+r"(v)
      : "l"(a), "r"(static_cast<unsigned>(p)));
  return v;
}

// A product rounded once, never contracted into the add that takes it.
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

// The map entries of the runs s0 .. s0 + kMapBatch - 1 of the staged table
// (src[start + r]), each under its run's predicate, which `live` keeps for
// the value loads.
__device__ __forceinline__ void map_batch(int s0, int nt, int r,
                                          const int* s_start,
                                          const int* s_count, const int* src,
                                          bool (&live)[kMapBatch],
                                          int (&from)[kMapBatch]) {
#pragma unroll
  for (int k = 0; k < kMapBatch; ++k) {
    const int s = min(s0 + k, nt - 1);
    live[k] = s0 + k < nt && r < s_count[s];
    from[k] = load_if(live[k], src + static_cast<int64_t>(s_start[s]) + r);
  }
}

// The values and columns of the runs s0 .. s0 + kProdBatch - 1 of the
// staged table (values[start + r] and col(start + r)), each under its run's
// predicate, which `live` keeps for the gathers of x. C is the stored
// column type: int (col = cols[p]) or unsigned short (narrow: col =
// lbase[p / kLBlock] + cols[p], the base one load a warp, as a warp's
// positions lie in one block).
template <typename V, typename C>
__device__ __forceinline__ void product_batch(
    int s0, int nt, int r, const int* s_start, const int* s_count,
    const V* values, const C* cols, const int* lbase,
    bool (&live)[kProdBatch], V (&val)[kProdBatch], int (&col)[kProdBatch]) {
#pragma unroll
  for (int k = 0; k < kProdBatch; ++k) {
    const int s = min(s0 + k, nt - 1);
    live[k] = s0 + k < nt && r < s_count[s];
    const int64_t p = static_cast<int64_t>(s_start[s]) + r;
    val[k] = load_if(live[k], values + p);
    if constexpr (sizeof(C) == sizeof(int)) {
      col[k] = load_if(live[k], cols + p);
    } else {
      col[k] = load_nc_if(live[k], lbase + p / kLBlock) +
               static_cast<int>(load_if(live[k], cols + p));
    }
  }
}

// kForm: how position p is read (kInPlace, kThroughMap, kProducts); C: the
// products' column type (unused by the other forms).
template <typename V, int kForm, typename C>
__global__ void __launch_bounds__(kThreads)
stream_sum_kernel(const int* __restrict__ run_start,
                  const int* __restrict__ run_count,
                  const int* __restrict__ order,
                  const int* __restrict__ block_first,
                  const int* __restrict__ block_runs,
                  const int* __restrict__ src,
                  const V* __restrict__ stream, const C* __restrict__ cols,
                  const int* __restrict__ lbase, const V* __restrict__ x,
                  V* __restrict__ out) {
  __shared__ int s_start[kTable];
  __shared__ int s_count[kTable];
  // the block's part j, its first run and its run count, all indexed by
  // the launch position so that the three loads go out together
  const int j = __ldg(order + blockIdx.x);
  const int first = __ldg(block_first + blockIdx.x);
  const int runs = __ldg(block_runs + blockIdx.x);
  const int64_t u = j / kParts;                     // its subtile
  const int r = (j % kParts) * kThreads + threadIdx.x;   // output in u
  V acc = V(0);
  for (int t0 = 0; t0 < runs; t0 += kTable) {
    const int nt = min(kTable, runs - t0);
    __syncthreads();                 // the previous chunk's reads are done
    if (threadIdx.x < nt) {
      s_start[threadIdx.x] = __ldg(run_start + first + t0 + threadIdx.x);
      s_count[threadIdx.x] = __ldg(run_count + first + t0 + threadIdx.x);
    }
    __syncthreads();
    if constexpr (kForm == kThroughMap) {
      // a batch's values go out with the next batch's map entries: one
      // trip to memory a batch, where loading the map, then the values,
      // took two
      bool live[kMapBatch];
      int from[kMapBatch];
      map_batch(0, nt, r, s_start, s_count, src, live, from);
      for (int s0 = 0; s0 < nt; s0 += kMapBatch) {
        V v[kMapBatch];
#pragma unroll
        for (int k = 0; k < kMapBatch; ++k)
          v[k] = load_nc_if(live[k], stream + from[k]);
        map_batch(s0 + kMapBatch, nt, r, s_start, s_count, src, live, from);
#pragma unroll
        for (int k = 0; k < kMapBatch; ++k) acc += v[k];
      }
    } else if constexpr (kForm == kProducts) {
      // a batch's gathers of x go out with the next batch's values and
      // columns, as the map form's value loads do with its map entries
      bool live[kProdBatch];
      V val[kProdBatch];
      int col[kProdBatch];
      product_batch(0, nt, r, s_start, s_count, stream, cols, lbase, live,
                    val, col);
      for (int s0 = 0; s0 < nt; s0 += kProdBatch) {
        V a[kProdBatch], b[kProdBatch];
#pragma unroll
        for (int k = 0; k < kProdBatch; ++k) {
          a[k] = val[k];
          b[k] = load_nc_if(live[k], x + col[k]);
        }
        product_batch(s0 + kProdBatch, nt, r, s_start, s_count, stream, cols,
                      lbase, live, val, col);
#pragma unroll
        for (int k = 0; k < kProdBatch; ++k) acc += mul_rn(a[k], b[k]);
      }
    } else {
      for (int s0 = 0; s0 < nt; s0 += kBatch<V>) {
        int start[kBatch<V>], count[kBatch<V>];
#pragma unroll
        for (int k = 0; k < kBatch<V>; ++k) {
          const int s = min(s0 + k, nt - 1);
          start[k] = s_start[s];
          count[k] = s0 + k < nt ? s_count[s] : 0;
        }
        V v[kBatch<V>];
#pragma unroll
        for (int k = 0; k < kBatch<V>; ++k)
          v[k] = load_if(r < count[k],
                         stream + static_cast<int64_t>(start[k]) + r);
#pragma unroll
        for (int k = 0; k < kBatch<V>; ++k) acc += v[k];
      }
    }
  }
  out[u * kRows + r] = acc;
}

template <typename V, int kForm, typename C = int>
int launch(const void* run_start, const void* run_count, const void* order,
           const void* block_first, const void* block_runs, const void* src,
           const void* stream_in, const void* cols, const void* lbase,
           const void* x, void* out, int64_t num_blocks, void* stream) {
  if (num_blocks < 1 || num_blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  stream_sum_kernel<V, kForm, C><<<static_cast<unsigned>(num_blocks),
                                   kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(run_start), static_cast<const int*>(run_count),
      static_cast<const int*>(order), static_cast<const int*>(block_first),
      static_cast<const int*>(block_runs), static_cast<const int*>(src),
      static_cast<const V*>(stream_in), static_cast<const C*>(cols),
      static_cast<const int*>(lbase), static_cast<const V*>(x),
      static_cast<V*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define STREAM_SUM_ENTRY(NAME, V)                                            \
  extern "C" int NAME(const void* run_start, const void* run_count,          \
                      const void* order, const void* block_first,            \
                      const void* block_runs, const void* stream_in,         \
                      void* out, int64_t num_blocks, void* stream) {         \
    return launch<V, kInPlace>(run_start, run_count, order, block_first,     \
                               block_runs, nullptr, stream_in, nullptr,      \
                               nullptr, nullptr, out, num_blocks, stream);   \
  }

#define STREAM_SUM_SRC_ENTRY(NAME, V)                                        \
  extern "C" int NAME(const void* run_start, const void* run_count,          \
                      const void* order, const void* block_first,            \
                      const void* block_runs, const void* src,               \
                      const void* stream_in, void* out, int64_t num_blocks,  \
                      void* stream) {                                        \
    return launch<V, kThroughMap>(run_start, run_count, order, block_first,  \
                                  block_runs, src, stream_in, nullptr,       \
                                  nullptr, nullptr, out, num_blocks,         \
                                  stream);                                   \
  }

// values: the products' values in position order; cols: their int32
// columns with lbase null, or the narrow layout's uint16 offsets from
// lbase's int32 bases, one per kLBlock positions.
#define STREAM_SUM_PROD_ENTRY(NAME, V)                                       \
  extern "C" int NAME(const void* run_start, const void* run_count,          \
                      const void* order, const void* block_first,            \
                      const void* block_runs, const void* values,            \
                      const void* cols, const void* lbase, const void* x,    \
                      void* out, int64_t num_blocks, void* stream) {         \
    if (lbase == nullptr)                                                    \
      return launch<V, kProducts, int>(run_start, run_count, order,          \
                                       block_first, block_runs, nullptr,     \
                                       values, cols, nullptr, x, out,        \
                                       num_blocks, stream);                  \
    return launch<V, kProducts, unsigned short>(                             \
        run_start, run_count, order, block_first, block_runs, nullptr,       \
        values, cols, lbase, x, out, num_blocks, stream);                    \
  }

STREAM_SUM_ENTRY(stream_sum_f64, double)
STREAM_SUM_ENTRY(stream_sum_f32, float)
STREAM_SUM_SRC_ENTRY(stream_sum_src_f64, double)
STREAM_SUM_SRC_ENTRY(stream_sum_src_f32, float)
STREAM_SUM_PROD_ENTRY(stream_sum_prod_f64, double)
STREAM_SUM_PROD_ENTRY(stream_sum_prod_f32, float)

// Outputs per subtile, and blocks per subtile.
extern "C" int stream_sum_rows() { return kRows; }
extern "C" int stream_sum_parts() { return kParts; }
// Positions per base of the products' narrow columns.
extern "C" int stream_sum_rows_per_base() { return kLBlock; }
