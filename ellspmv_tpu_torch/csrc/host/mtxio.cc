// Native Matrix Market parser for ellspmv_tpu (ctypes ABI).
//
// The reference parses line-at-a-time with fgets+strtod
// (mtxfile_fread_matrix_coordinate, ellspmv.c:808-888) and reports
// ~100 MB/s (README:131). This parser mmaps the file, splits the body at
// line boundaries across all host cores, and parses each chunk with
// std::from_chars — typically >1 GB/s.
//
// Returns 0-based indices, range-validated, with the same field semantics
// as the reference (integer parsed as double; pattern value 1.0,
// ellspmv.c:882). Gzip input is inflated in-memory via zlib, matching the
// reference's HAVE_LIBZ path (ellspmv.c:1285).

#include <cerrno>
#include <cctype>
#include <charconv>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>
#include <zlib.h>

namespace {

struct MtxResult {
  int64_t num_rows = 0;
  int64_t num_columns = 0;
  int64_t num_nonzeros = 0;
  int32_t field = 0;     // 0=real 1=integer 2=pattern
  int32_t symmetry = 0;  // 0=general 1=symmetric
  int64_t* rowidx = nullptr;
  int64_t* colidx = nullptr;
  double* values = nullptr;
  const char* error = nullptr;  // strdup'd; freed in mtxio_free
};

MtxResult* fail(MtxResult* r, const std::string& msg) {
  free((void*)r->error);
  r->error = strdup(msg.c_str());
  return r;
}

// Skip spaces/tabs (the reference accepts any isspace separators).
inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
  return p;
}

inline const char* parse_i64(const char* p, const char* end, int64_t* out,
                             bool* ok) {
  auto res = std::from_chars(p, end, *out);
  *ok = res.ec == std::errc();
  return res.ptr;
}

inline const char* parse_f64(const char* p, const char* end, double* out,
                             bool* ok) {
  auto res = std::from_chars(p, end, *out);
  *ok = res.ec == std::errc();
  return res.ptr;
}

// File contents, either mmap'd zero-copy (plain files) or inflated into
// an owned vector (gzip). The plain-file read() + page-fault copy of the
// old design cost ~4x the parse itself on big files.
struct FileBuf {
  const char* data = nullptr;
  size_t size = 0;
  void* map = nullptr;  // munmap target when mmap'd
  std::vector<char> owned;
  ~FileBuf() {
    if (map) munmap(map, size);
  }
};

bool read_file(const char* path, bool gzipped, FileBuf& buf,
               std::string& err) {
  if (!gzipped) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) {
      err = std::string(path) + ": " + strerror(errno);
      return false;
    }
    struct stat st;
    if (fstat(fd, &st) != 0) {
      err = strerror(errno);
      close(fd);
      return false;
    }
    if (st.st_size > 0) {
      void* m = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
      if (m != MAP_FAILED) {
        madvise(m, st.st_size, MADV_SEQUENTIAL);
        buf.map = m;
        buf.data = (const char*)m;
        buf.size = st.st_size;
        close(fd);
        return true;
      }
    }
    // empty file or mmap failure: fall back to read()
    buf.owned.resize(st.st_size);
    ssize_t off = 0;
    while (off < st.st_size) {
      ssize_t got = read(fd, buf.owned.data() + off, st.st_size - off);
      if (got <= 0) {
        err = "short read";
        close(fd);
        return false;
      }
      off += got;
    }
    close(fd);
    buf.data = buf.owned.data();
    buf.size = buf.owned.size();
    return true;
  }
  gzFile f = gzopen(path, "rb");  // transparently reads plain files too
  if (!f) {
    err = std::string(path) + ": cannot open";
    return false;
  }
  gzbuffer(f, 1 << 20);
  constexpr size_t CHUNK = 16 << 20;
  size_t off = 0;
  for (;;) {
    buf.owned.resize(off + CHUNK);
    int got = gzread(f, buf.owned.data() + off, CHUNK);
    if (got < 0) {
      err = "gzip read error";
      gzclose(f);
      return false;
    }
    off += got;
    if ((size_t)got < CHUNK) break;
  }
  buf.owned.resize(off);
  gzclose(f);
  buf.data = buf.owned.data();
  buf.size = buf.owned.size();
  return true;
}

}  // namespace

extern "C" {

MtxResult* mtxio_read_matrix(const char* path, int32_t gzipped) {
  auto* r = new MtxResult();
  FileBuf buf;
  std::string err;
  bool is_gz = gzipped != 0;
  if (!is_gz) {
    // sniff magic for transparency (zlib gzopen semantics)
    FILE* f = fopen(path, "rb");
    if (f) {
      unsigned char magic[2] = {0, 0};
      if (fread(magic, 1, 2, f) == 2 && magic[0] == 0x1f && magic[1] == 0x8b)
        is_gz = true;
      fclose(f);
    }
  }
  if (!read_file(path, is_gz, buf, err)) return fail(r, err);

  const char* p = buf.data;
  const char* end = p + buf.size;

  // --- banner ---
  const char* eol = (const char*)memchr(p, '\n', end - p);
  if (!eol) return fail(r, "missing banner line");
  std::string banner(p, eol - p);
  p = eol + 1;
  {
    char obj[64] = {0}, fmt[64] = {0}, fld[64] = {0}, sym[64] = {0};
    if (sscanf(banner.c_str(), "%%%%MatrixMarket %63s %63s %63s %63s", obj,
               fmt, fld, sym) != 4)
      return fail(r, "invalid Matrix Market banner: " + banner);
    for (char* s : {obj, fmt, fld, sym})
      for (char* c = s; *c; ++c) *c = tolower(*c);
    if (strcmp(obj, "matrix") != 0)
      return fail(r, "unsupported: object must be matrix");
    if (strcmp(fmt, "coordinate") != 0)
      return fail(r, "unsupported: format must be coordinate");
    if (!strcmp(fld, "real") || !strcmp(fld, "double"))
      r->field = 0;
    else if (!strcmp(fld, "integer"))
      r->field = 1;
    else if (!strcmp(fld, "pattern"))
      r->field = 2;
    else
      return fail(r, std::string("invalid field ") + fld);
    if (!strcmp(sym, "general"))
      r->symmetry = 0;
    else if (!strcmp(sym, "symmetric"))
      r->symmetry = 1;
    else
      return fail(r, std::string("unsupported symmetry ") + sym);
  }

  // --- comments + size line ---
  for (;;) {
    if (p >= end) return fail(r, "unexpected EOF before size line");
    if (*p == '%') {
      eol = (const char*)memchr(p, '\n', end - p);
      if (!eol) return fail(r, "unexpected EOF in comments");
      p = eol + 1;
      continue;
    }
    const char* q = skip_ws(p, end);
    if (q < end && *q == '\n') {
      p = q + 1;
      continue;
    }
    break;
  }
  bool ok1, ok2, ok3;
  p = skip_ws(p, end);
  p = parse_i64(p, end, &r->num_rows, &ok1);
  p = skip_ws(p, end);
  p = parse_i64(p, end, &r->num_columns, &ok2);
  p = skip_ws(p, end);
  p = parse_i64(p, end, &r->num_nonzeros, &ok3);
  if (!ok1 || !ok2 || !ok3 || r->num_rows < 0 || r->num_columns < 0 ||
      r->num_nonzeros < 0)
    return fail(r, "invalid size line (need 'rows cols nnz')");
  eol = (const char*)memchr(p, '\n', end - p);
  p = eol ? eol + 1 : end;

  const int64_t nnz = r->num_nonzeros;
  r->rowidx = (int64_t*)malloc(sizeof(int64_t) * (nnz ? nnz : 1));
  r->colidx = (int64_t*)malloc(sizeof(int64_t) * (nnz ? nnz : 1));
  const bool has_val = r->field != 2;
  r->values = (double*)malloc(sizeof(double) * (has_val && nnz ? nnz : 1));
  if (!r->rowidx || !r->colidx || !r->values)
    return fail(r, "out of memory");

  // --- body: split at line boundaries, parse chunks in parallel ---
  unsigned nthreads = std::thread::hardware_concurrency();
  if (nthreads == 0) nthreads = 1;
  if (nthreads > 32) nthreads = 32;
  if (nnz < 100000) nthreads = 1;

  std::vector<const char*> starts(nthreads + 1);
  starts[0] = p;
  starts[nthreads] = end;
  for (unsigned t = 1; t < nthreads; t++) {
    const char* cand = p + (size_t)(end - p) * t / nthreads;
    const char* nl = (const char*)memchr(cand, '\n', end - cand);
    starts[t] = nl ? nl + 1 : end;
  }

  const int32_t field = r->field;
  const int64_t nrows = r->num_rows, ncols = r->num_columns;

  // Single-core fast path: one pass, no counting phase.
  if (nthreads == 1) {
    int64_t i = 0;
    const char* q = p;
    while (q < end && i < nnz) {
      const char* s = skip_ws(q, end);
      if (s >= end) break;
      if (*s == '\n' || *s == '%') {
        const char* nl = (const char*)memchr(s, '\n', end - s);
        q = nl ? nl + 1 : end;
        continue;
      }
      bool ok;
      int64_t ri, ci;
      s = parse_i64(s, end, &ri, &ok);
      if (!ok) return fail(r, "invalid row index");
      s = skip_ws(s, end);
      s = parse_i64(s, end, &ci, &ok);
      if (!ok) return fail(r, "invalid column index");
      if (ri < 1 || ri > r->num_rows || ci < 1 || ci > r->num_columns)
        return fail(r, "row/column index out of range");
      if (r->field != 2) {
        s = skip_ws(s, end);
        double v;
        s = parse_f64(s, end, &v, &ok);
        if (!ok) return fail(r, "invalid value");
        r->values[i] = v;
      }
      r->rowidx[i] = ri - 1;
      r->colidx[i] = ci - 1;
      i++;
      const char* nl = (const char*)memchr(s, '\n', end - s);
      q = nl ? nl + 1 : end;
    }
    if (i < nnz)
      return fail(r, "expected " + std::to_string(nnz) +
                         " data lines, found " + std::to_string(i));
    return r;
  }

  // Count data lines per chunk, then prefix-sum into entry offsets.
  std::vector<int64_t> counts(nthreads, 0);
  std::vector<std::string> errors(nthreads);
  std::vector<std::thread> threads;
  for (unsigned t = 0; t < nthreads; t++) {
    threads.emplace_back([&, t] {
      int64_t c = 0;
      for (const char* q = starts[t]; q < starts[t + 1];) {
        const char* nl = (const char*)memchr(q, '\n', starts[t + 1] - q);
        const char* line_end = nl ? nl : starts[t + 1];
        const char* s = skip_ws(q, line_end);
        if (s < line_end && *s != '\n' && *s != '%') c++;
        q = nl ? nl + 1 : starts[t + 1];
      }
      counts[t] = c;
    });
  }
  for (auto& th : threads) th.join();
  threads.clear();

  std::vector<int64_t> offsets(nthreads + 1, 0);
  for (unsigned t = 0; t < nthreads; t++) offsets[t + 1] = offsets[t] + counts[t];
  if (offsets[nthreads] < nnz)
    return fail(r, "expected " + std::to_string(nnz) + " data lines, found " +
                       std::to_string(offsets[nthreads]));

  for (unsigned t = 0; t < nthreads; t++) {
    threads.emplace_back([&, t] {
      int64_t i = offsets[t];
      for (const char* q = starts[t]; q < starts[t + 1] && i < nnz;) {
        const char* nl = (const char*)memchr(q, '\n', starts[t + 1] - q);
        const char* line_end = nl ? nl : starts[t + 1];
        const char* s = skip_ws(q, line_end);
        q = nl ? nl + 1 : starts[t + 1];
        if (s >= line_end || *s == '\n' || *s == '%') continue;
        bool ok;
        int64_t ri, ci;
        s = parse_i64(s, line_end, &ri, &ok);
        if (!ok) { errors[t] = "invalid row index"; return; }
        s = skip_ws(s, line_end);
        s = parse_i64(s, line_end, &ci, &ok);
        if (!ok) { errors[t] = "invalid column index"; return; }
        if (ri < 1 || ri > nrows || ci < 1 || ci > ncols) {
          errors[t] = "row/column index out of range";
          return;
        }
        if (field != 2) {
          s = skip_ws(s, line_end);
          double v;
          s = parse_f64(s, line_end, &v, &ok);
          if (!ok) { errors[t] = "invalid value"; return; }
          r->values[i] = v;
        }
        r->rowidx[i] = ri - 1;
        r->colidx[i] = ci - 1;
        i++;
      }
    });
  }
  for (auto& th : threads) th.join();
  for (auto& e : errors)
    if (!e.empty()) return fail(r, e);
  return r;
}

void mtxio_free(MtxResult* r) {
  if (!r) return;
  free(r->rowidx);
  free(r->colidx);
  free(r->values);
  free((void*)r->error);
  delete r;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// COO -> ELLPACK packing (ell_from_coo's hot core, ellspmv.c:1081-1127,
// re-done as a counting-sort scatter + per-row insertion sort by column).
// The NumPy path (lexsort + fancy-index scatter) takes ~10 s for 32M
// entries; this single pass runs at memcpy-like speed. Inputs are the
// (already symmetric-expanded, diagonal-split) COO triplets with int32
// indices; outputs are the padded (n_pad x rowsize) ELL arrays.
// ---------------------------------------------------------------------------

extern "C" {

struct EllPackResult {
  int32_t* colidx = nullptr;   // (n_pad * rowsize)
  double* values = nullptr;    // (n_pad * rowsize)
  const char* error = nullptr;
};

EllPackResult* mtxio_ell_pack(int64_t num_rows, int64_t num_cols,
                              int64_t n_pad, int64_t rowsize, int64_t nnz,
                              const int32_t* rowidx, const int32_t* colidx,
                              const double* values, int32_t sort_rows) {
  auto* r = new EllPackResult();
  auto fail = [&](const char* msg) {
    free(r->colidx);
    free(r->values);
    r->colidx = nullptr;
    r->values = nullptr;
    r->error = strdup(msg);
    return r;
  };
  if (n_pad < num_rows || rowsize < 0) return fail("bad dimensions");
  size_t slots = (size_t)n_pad * (size_t)rowsize;
  r->colidx = (int32_t*)malloc(sizeof(int32_t) * (slots ? slots : 1));
  r->values = (double*)malloc(sizeof(double) * (slots ? slots : 1));
  if (!r->colidx || !r->values) return fail("out of memory");

  // padding: column min(i, num_cols-1), value 0 (ellspmv.c:1111-1117)
  const int32_t cmax = (int32_t)(num_cols > 0 ? num_cols - 1 : 0);
  for (int64_t i = 0; i < n_pad; i++) {
    int32_t pad = (int32_t)(i < cmax ? i : cmax);
    int32_t* crow = r->colidx + (size_t)i * rowsize;
    double* vrow = r->values + (size_t)i * rowsize;
    for (int64_t s = 0; s < rowsize; s++) {
      crow[s] = pad;
      vrow[s] = 0.0;
    }
  }

  // counting-sort scatter: entries keep file order within a row
  std::vector<int32_t> cursor((size_t)num_rows, 0);
  for (int64_t e = 0; e < nnz; e++) {
    int64_t row = rowidx[e];
    if (row < 0 || row >= num_rows) return fail("row index out of range");
    int32_t c = cursor[row]++;
    if (c >= rowsize) return fail("row overflows rowsize");
    r->colidx[(size_t)row * rowsize + c] = colidx[e];
    r->values[(size_t)row * rowsize + c] = values[e];
  }

  if (sort_rows) {
    // per-row insertion sort by column (rowsort, ellspmv.c:960-1079;
    // rows are short so insertion sort is the right tool here)
    for (int64_t i = 0; i < num_rows; i++) {
      int32_t cnt = cursor[i];
      int32_t* crow = r->colidx + (size_t)i * rowsize;
      double* vrow = r->values + (size_t)i * rowsize;
      for (int32_t j = 1; j < cnt; j++) {
        int32_t cj = crow[j];
        double vj = vrow[j];
        int32_t k = j - 1;
        while (k >= 0 && crow[k] > cj) {
          crow[k + 1] = crow[k];
          vrow[k + 1] = vrow[k];
          k--;
        }
        crow[k + 1] = cj;
        vrow[k + 1] = vj;
      }
    }
  }
  return r;
}

void mtxio_ell_pack_free(EllPackResult* r) {
  if (!r) return;
  free(r->colidx);
  free(r->values);
  free((void*)r->error);
  delete r;
}

}  // extern "C"
