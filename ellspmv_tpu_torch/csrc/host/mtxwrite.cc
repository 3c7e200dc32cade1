// Fast Matrix Market COO writer (native counterpart of io/mtx.py
// write_matrix). The reference has no writer; this exists so the
// reference-scale benchmark (README:130's 116M-nonzero class) can
// materialize real .mtx files in seconds instead of hours of python
// string formatting. Values print with %.17g-equivalent shortest
// round-trip formatting via std::to_chars.

#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

extern "C" {

// Returns 0 on success, errno-style code otherwise. Indices are 0-based
// and written 1-based. vals may be null (pattern field).
int mtxio_write_coo(const char *path, int64_t num_rows, int64_t num_cols,
                    int64_t nnz, const int64_t *rowidx,
                    const int64_t *colidx, const double *vals,
                    int32_t symmetric) {
  FILE *f = std::fopen(path, "wb");
  if (!f) return 1;
  std::setvbuf(f, nullptr, _IOFBF, 1 << 22);
  std::fprintf(f, "%%%%MatrixMarket matrix coordinate %s %s\n",
               vals ? "real" : "pattern",
               symmetric ? "symmetric" : "general");
  std::fprintf(f, "%lld %lld %lld\n", (long long)num_rows,
               (long long)num_cols, (long long)nnz);

  constexpr int64_t CHUNK = 1 << 16;
  std::vector<char> buf;
  buf.resize(CHUNK * 64 + 64);
  for (int64_t base = 0; base < nnz; base += CHUNK) {
    int64_t hi = base + CHUNK < nnz ? base + CHUNK : nnz;
    char *p = buf.data();
    for (int64_t k = base; k < hi; k++) {
      auto r1 = std::to_chars(p, p + 24, rowidx[k] + 1);
      p = r1.ptr;
      *p++ = ' ';
      auto r2 = std::to_chars(p, p + 24, colidx[k] + 1);
      p = r2.ptr;
      if (vals) {
        *p++ = ' ';
        auto r3 = std::to_chars(p, p + 40, vals[k]);
        p = r3.ptr;
      }
      *p++ = '\n';
    }
    if (std::fwrite(buf.data(), 1, p - buf.data(), f)
        != (size_t)(p - buf.data())) {
      std::fclose(f);
      return 2;
    }
  }
  if (std::fclose(f)) return 3;
  return 0;
}

}  // extern "C"
