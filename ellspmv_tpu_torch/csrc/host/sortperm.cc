// LSD radix argsort over unsigned integer keys, returning the int32
// permutation that sorts them (stable). Plan-build hot path: the stream
// format's host-side planner (ellspmv_tpu/formats/stream.py,
// ops/stream_sum.py) sorts multi-million-entry integer key arrays several
// times per conversion; numpy's introsort-based argsort costs ~1 s per
// 7M-key pass on the single-core host while a byte-wise LSD radix with an
// index payload does it in a few sequential sweeps. The reference's
// conversion hot path is the analogous rowsort/histogram machinery
// (ellspmv.c:931-1079) — this is its plan-time counterpart.
//
// Only the bytes that actually vary are processed: pass k is skipped when
// all keys share the same byte k (common for keys far below the dtype
// max, e.g. 22-bit combined group keys in a 64-bit carrier).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

template <typename K>
static void radix_argsort(int64_t n, const K *keys, int32_t *order) {
  std::vector<int32_t> a(n), b(n);
  for (int64_t i = 0; i < n; i++) a[i] = (int32_t)i;
  // per-byte histograms in one sweep
  constexpr int NB = (int)sizeof(K);
  std::vector<int64_t> hist(NB * 256, 0);
  for (int64_t i = 0; i < n; i++) {
    K k = keys[i];
    for (int p = 0; p < NB; p++) hist[p * 256 + ((k >> (8 * p)) & 0xff)]++;
  }
  int32_t *src = a.data(), *dst = b.data();
  for (int p = 0; p < NB; p++) {
    int64_t *h = &hist[p * 256];
    // skip passes where every key shares this byte
    bool trivial = false;
    for (int v = 0; v < 256; v++)
      if (h[v] == n) { trivial = true; break; }
    if (trivial) continue;
    int64_t pos[256], run = 0;
    for (int v = 0; v < 256; v++) { pos[v] = run; run += h[v]; }
    const int shift = 8 * p;
    for (int64_t i = 0; i < n; i++) {
      const int32_t e = src[i];
      dst[pos[(keys[e] >> shift) & 0xff]++] = e;
    }
    std::swap(src, dst);
  }
  std::memcpy(order, src, n * sizeof(int32_t));
}

}  // namespace

extern "C" {

int mtxio_argsort_u32(int64_t n, const uint32_t *keys, int32_t *order) {
  if (n > INT32_MAX) return 1;
  if (n) radix_argsort<uint32_t>(n, keys, order);
  return 0;
}

int mtxio_argsort_u64(int64_t n, const uint64_t *keys, int32_t *order) {
  if (n > INT32_MAX) return 1;
  if (n) radix_argsort<uint64_t>(n, keys, order);
  return 0;
}

}  // extern "C"
