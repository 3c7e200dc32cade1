"""Matrix Market I/O, with the strictness of the reference's parser
(mtxfile_fread_header ellspmv.c:707-806, mtxfile_fread_matrix_coordinate
ellspmv.c:808-888, mtxfile_fread_vector_array ellspmv.c:890-929):

- objects: ``matrix`` | ``vector``
- formats: ``coordinate`` (matrix) | ``array`` (vector)
- fields: ``real`` | ``integer`` (parsed as float64) | ``pattern`` (value 1.0,
  ellspmv.c:882)
- symmetries: ``general`` | ``symmetric``
- ``%`` comment lines are skipped between the header and the size line
- 1-based indices become 0-based at load
- gzip-compressed streams (the reference's ``-z`` path, ellspmv.c:1285),
  with plain files read through unchanged as zlib's gzopen does

The body is parsed in bulk with NumPy. This module is the counterpart of
``ellspmv_tpu.io.mtx`` without its native C++ parser.
"""

from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np

from ellspmv_tpu_torch.config import select_index_dtype
from ellspmv_tpu_torch.formats.coo import CooMatrix

__all__ = [
    "MtxHeader",
    "MtxFormatError",
    "read_header",
    "read_matrix",
    "read_vector",
    "write_vector",
    "write_matrix",
]


class MtxFormatError(ValueError):
    """Strict-parse failure, mirroring the reference's EINVAL paths
    (ellspmv.c:1309-1311)."""


VALID_OBJECTS = ("matrix", "vector")
VALID_FORMATS = ("coordinate", "array")
VALID_FIELDS = ("real", "integer", "pattern", "double")
VALID_SYMMETRIES = ("general", "symmetric")


@dataclasses.dataclass
class MtxHeader:
    object: str
    format: str
    field: str
    symmetry: str
    num_rows: int
    num_columns: int
    num_nonzeros: int   # stored entries in the file (not symmetric-expanded)
    comment_lines: int = 0


def _open_stream(path_or_file, gzipped: bool | None = None):
    """Open `path_or_file` as a binary stream, gunzipping when it is gzip.

    `gzipped=None` decides from the file name. An explicit request, like the
    reference's ``-z``, still sniffs the magic bytes, so a plain file reads
    through unchanged.
    """
    if hasattr(path_or_file, "read"):
        f = path_or_file
        close = False
    else:
        path = os.fspath(path_or_file)
        if gzipped is None:
            gzipped = path.endswith(".gz")
        f = open(path, "rb")
        close = True
    try:
        if gzipped is None or gzipped:
            magic = f.peek(2)[:2] if hasattr(f, "peek") else b""
            gzipped = magic == b"\x1f\x8b"
        if gzipped:
            f = gzip.GzipFile(fileobj=f)
    except Exception:
        if close:
            f.close()
        raise
    return f


def _decode(line) -> str:
    return line.decode("latin-1") if isinstance(line, bytes) else line


def read_header(f) -> MtxHeader:
    """Parse the banner, comments and size line from binary stream `f`.

    The banner is ``%%MatrixMarket object format field symmetry``; the size
    line is ``rows cols nnz`` for matrix-coordinate, ``rows cols`` for
    matrix-array and ``n`` for vector-array.
    """
    line = _decode(f.readline())
    parts = line.split()
    if len(parts) != 5 or parts[0] != "%%MatrixMarket":
        raise MtxFormatError(f"invalid Matrix Market banner: {line!r}")
    obj, fmt, field, symmetry = (p.lower() for p in parts[1:])
    if obj not in VALID_OBJECTS:
        raise MtxFormatError(f"invalid object {obj!r}")
    if fmt not in VALID_FORMATS:
        raise MtxFormatError(f"invalid format {fmt!r}")
    if field not in VALID_FIELDS:
        raise MtxFormatError(f"invalid field {field!r}")
    if field == "double":  # accepted by the reference's parser as real
        field = "real"
    if symmetry not in VALID_SYMMETRIES:
        raise MtxFormatError(
            f"unsupported symmetry {symmetry!r} (the reference supports "
            "general and symmetric, ellspmv.c:764-770)")

    comment_lines = 0
    while True:
        line = _decode(f.readline())
        if not line:
            raise MtxFormatError("unexpected EOF before size line")
        if line.startswith("%"):
            comment_lines += 1
            continue
        if line.strip() == "":
            continue
        break

    try:
        sizes = [int(s) for s in line.split()]
    except ValueError as e:
        raise MtxFormatError(f"invalid size line: {line!r}") from e

    if obj == "matrix" and fmt == "coordinate":
        if len(sizes) != 3:
            raise MtxFormatError(f"matrix coordinate size line needs "
                                 f"'rows cols nnz', got {line!r}")
        nr, nc, nnz = sizes
    elif obj == "matrix" and fmt == "array":
        if len(sizes) != 2:
            raise MtxFormatError(f"matrix array size line needs "
                                 f"'rows cols', got {line!r}")
        nr, nc = sizes
        nnz = nr * nc
    elif obj == "vector" and fmt == "array":
        if len(sizes) != 1:
            raise MtxFormatError(f"vector array size line needs 'n', "
                                 f"got {line!r}")
        nr, nc, nnz = sizes[0], 1, sizes[0]
    else:
        raise MtxFormatError(f"unsupported object/format: {obj}/{fmt}")
    if nr < 0 or nc < 0 or nnz < 0:
        raise MtxFormatError(f"negative sizes in size line: {line!r}")
    return MtxHeader(obj, fmt, field, symmetry, nr, nc, nnz, comment_lines)


def _read_body_numpy(f, num_fields: int, num_lines: int) -> np.ndarray:
    """Parse `num_lines` whitespace-separated numeric rows in one call.

    Garbage tokens and comment lines inside the body are errors (comments
    are legal only between banner and size line, ellspmv.c:744-758), and so
    are out-of-range values like ``1e999`` (ERANGE in parse_double,
    ellspmv.c:436-460) and literal ``inf``/``nan``.
    """
    try:
        data = np.loadtxt(f, dtype=np.float64, comments=None, ndmin=2,
                          max_rows=num_lines if num_lines > 0 else 1)
    except ValueError as e:
        raise MtxFormatError(f"invalid matrix data: {e}") from e
    if num_lines == 0:
        return np.empty((0, num_fields), dtype=np.float64)
    if data.shape[0] != num_lines:
        raise MtxFormatError(
            f"expected {num_lines} data lines, found {data.shape[0]}")
    if data.shape[1] != num_fields:
        raise MtxFormatError(
            f"expected {num_fields} fields per line, found {data.shape[1]}")
    if not np.isfinite(data).all():
        bad = np.argwhere(~np.isfinite(data))[0]
        raise MtxFormatError(
            f"value out of range at data line {bad[0] + 1}, "
            f"field {bad[1] + 1}")
    return data


def read_matrix(path_or_file, gzipped: bool | None = None,
                index_dtype=None, value_dtype=np.float64) -> CooMatrix:
    """Read a Matrix Market file into a `CooMatrix`.

    Returns the stored triplets; symmetric expansion happens at format
    conversion, as in the reference (csrspmv.c:1240-1248).
    """
    f = _open_stream(path_or_file, gzipped)
    try:
        hdr = read_header(f)
        if hdr.object != "matrix" or hdr.format != "coordinate":
            raise MtxFormatError(
                "expected a matrix in coordinate format "
                f"(got {hdr.object}/{hdr.format})")
        nfields = 2 if hdr.field == "pattern" else 3
        body = _read_body_numpy(f, nfields, hdr.num_nonzeros)
    finally:
        f.close()

    idx_dt = select_index_dtype(hdr.num_rows, hdr.num_columns,
                                hdr.num_nonzeros, index_dtype)
    rowidx = body[:, 0].astype(idx_dt)
    colidx = body[:, 1].astype(idx_dt)
    if hdr.num_nonzeros:
        if (body[:, 0] != np.floor(body[:, 0])).any() or \
           (body[:, 1] != np.floor(body[:, 1])).any():
            raise MtxFormatError("non-integer row/column index")
        if rowidx.min() < 1 or rowidx.max() > hdr.num_rows \
           or colidx.min() < 1 or colidx.max() > hdr.num_columns:
            raise MtxFormatError("row/column index out of range")
    rowidx -= 1
    colidx -= 1
    if hdr.field == "pattern":
        vals = np.ones(hdr.num_nonzeros, dtype=value_dtype)  # ellspmv.c:882
    else:
        vals = body[:, 2].astype(value_dtype)
    return CooMatrix(num_rows=hdr.num_rows, num_columns=hdr.num_columns,
                     rowidx=rowidx, colidx=colidx, values=vals,
                     symmetry=hdr.symmetry, field=hdr.field)


def read_vector(path_or_file, gzipped: bool | None = None,
                value_dtype=np.float64) -> np.ndarray:
    """Read a dense vector in array format (ellspmv.c:890-929), or an Nx1
    matrix in array format, which other writers often emit."""
    f = _open_stream(path_or_file, gzipped)
    try:
        hdr = read_header(f)
        if hdr.format != "array":
            raise MtxFormatError("expected a dense vector in array format")
        if hdr.field not in ("real", "integer"):
            raise MtxFormatError(f"unsupported vector field {hdr.field!r}")
        if hdr.object == "matrix" and hdr.num_columns != 1:
            raise MtxFormatError("expected a vector or single-column matrix")
        body = _read_body_numpy(f, 1, hdr.num_rows)
    finally:
        f.close()
    return body[:, 0].astype(value_dtype)


def write_vector(f_or_path, y: np.ndarray) -> None:
    """Write `y` as a vector in array format, printed with ``%.15g`` as the
    reference does (DBL_DIG, ellspmv.c:1907)."""
    own = not hasattr(f_or_path, "write")
    f = open(f_or_path, "w") if own else f_or_path
    try:
        f.write("%%MatrixMarket vector array real general\n")
        f.write(f"{len(y)}\n")
        f.write("".join("%.15g\n" % v
                        for v in np.asarray(y, dtype=np.float64)))
    finally:
        if own:
            f.close()


def write_matrix(f_or_path, coo: CooMatrix) -> None:
    """Write a CooMatrix in coordinate format (1-based), values with
    ``%.17g`` so that they read back exactly. The reference has no matrix
    writer; tests and the smoke run use this one to make files."""
    own = not hasattr(f_or_path, "write")
    f = open(f_or_path, "w") if own else f_or_path
    try:
        field = "pattern" if coo.field == "pattern" else "real"
        f.write(f"%%MatrixMarket matrix coordinate {field} {coo.symmetry}\n")
        f.write(f"{coo.num_rows} {coo.num_columns} {len(coo.rowidx)}\n")
        rows = np.asarray(coo.rowidx, np.int64) + 1
        cols = np.asarray(coo.colidx, np.int64) + 1
        chunk = 1 << 16
        for lo in range(0, len(rows), chunk):
            r, c = rows[lo:lo + chunk].tolist(), cols[lo:lo + chunk].tolist()
            if field == "pattern":
                f.write("".join(f"{i} {j}\n" for i, j in zip(r, c)))
            else:
                v = coo.values[lo:lo + chunk].tolist()
                f.write("".join("%d %d %.17g\n" % t for t in zip(r, c, v)))
    finally:
        if own:
            f.close()
