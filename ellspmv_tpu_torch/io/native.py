"""ctypes bindings to the port's host library (``csrc/host/*.cc``), the
counterpart of ``ellspmv_tpu.io.native``:

- ``mtxio.cc``: a Matrix Market parser that maps the file and tokenizes
  its body on all host cores (gzip through zlib), and the COO -> ELLPACK
  packer (a counting-sort scatter, then a per-row insertion sort);
- ``mtxwrite.cc``: a bulk coordinate writer (shortest round-trip values);
- ``sortperm.cc``: a stable LSD radix argsort of unsigned integer keys.

The sources are the port's own copies of the JAX package's ``native/``
(without ``color.cc``, which only the TPU router calls). They are compiled
with ``g++`` at first use into ``build/ellspmv_tpu_torch/`` beside the
package; the library's name carries a hash of the sources, the flags and
what ``-march=native`` means on this host, so an edited source or another
CPU builds anew. Importing this module builds nothing. Without ``g++``,
`available` is False and callers take their NumPy paths; a compile that
fails raises with the compiler's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import numpy as np

from ellspmv_tpu_torch.ops._build import BUILD_DIR

SRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc" / "host"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")
LIBS = ("-lz", "-pthread")

# Below this many keys NumPy's stable argsort is as quick as a call out.
ARGSORT_MIN_KEYS = 100_000

_lock = threading.Lock()
_state: dict = {}     # "lib": the loaded library, or None without g++


class NativeUnsupported(RuntimeError):
    """Input the native path does not take; callers fall back to NumPy."""


class _MtxResult(ctypes.Structure):
    _fields_ = [
        ("num_rows", ctypes.c_int64),
        ("num_columns", ctypes.c_int64),
        ("num_nonzeros", ctypes.c_int64),
        ("field", ctypes.c_int32),      # 0=real 1=integer 2=pattern
        ("symmetry", ctypes.c_int32),   # 0=general 1=symmetric
        ("rowidx", ctypes.POINTER(ctypes.c_int64)),
        ("colidx", ctypes.POINTER(ctypes.c_int64)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


class _EllPackResult(ctypes.Structure):
    _fields_ = [
        ("colidx", ctypes.POINTER(ctypes.c_int32)),
        ("values", ctypes.POINTER(ctypes.c_double)),
        ("error", ctypes.c_char_p),
    ]


def find_cxx() -> str | None:
    """The C++ compiler: ``g++`` on $PATH."""
    return shutil.which("g++")


def sources(src_dir: pathlib.Path | None = None) -> list[pathlib.Path]:
    return sorted((src_dir or SRC_DIR).glob("*.cc"))


def library_path(cxx: str, src_dir: pathlib.Path | None = None,
                 build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Where the library built by `cxx` from the sources in `src_dir`
    (default `SRC_DIR`) lives in `build_dir` (default `BUILD_DIR`): named by
    a hash of the sources, the flags and the target options that
    ``-march=native`` selects on this host."""
    target = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                            capture_output=True, text=True, timeout=60)
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(target.stdout.encode())
    for src in sources(src_dir):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    name = f"libellspmv_host_{h.hexdigest()[:16]}.so"
    return (build_dir or BUILD_DIR) / name


def build(cxx: str, src_dir: pathlib.Path | None = None,
          build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Compile the host sources with `cxx` unless their library exists;
    return its path. Raises RuntimeError, with the compiler's stderr, when
    the compile fails."""
    out = library_path(cxx, src_dir, build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp),
           *map(str, sources(src_dir)), *LIBS]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{cxx} failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent process sees all or nothing
    return out


def _bind(lib):
    P = ctypes.POINTER
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    signatures = {
        "mtxio_read_matrix": (P(_MtxResult), [ctypes.c_char_p, i32]),
        "mtxio_free": (None, [P(_MtxResult)]),
        "mtxio_write_coo": (i32, [ctypes.c_char_p, i64, i64, i64, P(i64),
                                  P(i64), P(ctypes.c_double), i32]),
        "mtxio_argsort_u32": (i32, [i64, P(ctypes.c_uint32), P(i32)]),
        "mtxio_argsort_u64": (i32, [i64, P(ctypes.c_uint64), P(i32)]),
        "mtxio_ell_pack": (P(_EllPackResult),
                           [i64, i64, i64, i64, i64, P(i32), P(i32),
                            P(ctypes.c_double), i32]),
        "mtxio_ell_pack_free": (None, [P(_EllPackResult)]),
    }
    for name, (restype, argtypes) in signatures.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _load():
    """The library, built and loaded once per process; None without a C++
    compiler."""
    with _lock:
        if "lib" not in _state:
            cxx = find_cxx()
            _state["lib"] = (None if cxx is None
                             else _bind(ctypes.CDLL(str(build(cxx)))))
        return _state["lib"]


def available() -> bool:
    """Whether the host library can be used: builds it at the first call.
    False without a C++ compiler; a failed compile raises."""
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def read_matrix(path: str, gzipped: bool | None = None,
                index_dtype=None, value_dtype=np.float64):
    """Parse the Matrix Market file at `path` with the native parser.
    Raises `NativeUnsupported` for what it does not take (the caller falls
    back to the NumPy parser) and ``io.mtx.MtxFormatError`` with the
    parser's text for a malformed file."""
    from ellspmv_tpu_torch.config import select_index_dtype
    from ellspmv_tpu_torch.formats.coo import CooMatrix

    lib = _load()
    if lib is None:
        raise NativeUnsupported("native parser not built")
    want_gzip = 1 if gzipped else (0 if gzipped is not None
                                   else (1 if path.endswith(".gz") else 0))
    res = lib.mtxio_read_matrix(path.encode(), want_gzip)
    if not res:
        raise NativeUnsupported("native parser returned null")
    try:
        r = res.contents
        if r.error:
            msg = r.error.decode()
            if msg.startswith("unsupported"):
                raise NativeUnsupported(msg)
            from ellspmv_tpu_torch.io.mtx import MtxFormatError
            raise MtxFormatError(msg)
        nnz = r.num_nonzeros
        idx_dt = select_index_dtype(r.num_rows, r.num_columns, nnz,
                                    index_dtype)
        # one copy each straight out of the library's buffers, which are
        # freed below
        rowidx = np.ctypeslib.as_array(r.rowidx, shape=(nnz,)).astype(
            idx_dt, copy=True)
        colidx = np.ctypeslib.as_array(r.colidx, shape=(nnz,)).astype(
            idx_dt, copy=True)
        if r.field == 2:  # pattern: value 1.0 (ellspmv.c:882)
            values = np.ones(nnz, dtype=value_dtype)
        else:
            values = np.ctypeslib.as_array(
                r.values, shape=(nnz,)).astype(value_dtype, copy=True)
        return CooMatrix(num_rows=int(r.num_rows),
                         num_columns=int(r.num_columns),
                         rowidx=rowidx, colidx=colidx, values=values,
                         symmetry=("general", "symmetric")[r.symmetry],
                         field=("real", "integer", "pattern")[r.field])
    finally:
        lib.mtxio_free(res)


def write_coo(path, num_rows: int, num_cols: int, rowidx, colidx,
              values=None, symmetric: bool = False) -> None:
    """Write a coordinate Matrix Market file with the native writer
    (values None: the pattern field). Raises `NativeUnsupported` without
    the library, OSError when the write fails."""
    lib = _load()
    if lib is None:
        raise NativeUnsupported("native library not built")
    rowidx = np.ascontiguousarray(rowidx, np.int64)
    colidx = np.ascontiguousarray(colidx, np.int64)
    if len(colidx) != len(rowidx) or (values is not None
                                      and len(values) != len(rowidx)):
        raise ValueError("rowidx, colidx and values differ in length")
    vptr = ctypes.POINTER(ctypes.c_double)()
    if values is not None:
        values = np.ascontiguousarray(values, np.float64)
        vptr = _ptr(values, ctypes.c_double)
    rc = lib.mtxio_write_coo(
        os.fspath(path).encode(), int(num_rows), int(num_cols), len(rowidx),
        _ptr(rowidx, ctypes.c_int64), _ptr(colidx, ctypes.c_int64), vptr,
        1 if symmetric else 0)
    if rc != 0:
        raise OSError(f"native matrix write failed ({rc}): {path}")


def argsort(keys) -> np.ndarray:
    """Stable argsort of an integer key array: the native LSD radix for at
    least `ARGSORT_MIN_KEYS` non-negative keys (int32 positions), else
    ``np.argsort(kind="stable")``, whose order it equals."""
    keys = np.asarray(keys)
    n = len(keys)
    if (n < ARGSORT_MIN_KEYS or keys.dtype.kind not in "iu"
            or (keys.dtype.kind == "i" and int(keys.min()) < 0)
            or not available()):
        return np.argsort(keys, kind="stable")
    lib = _load()
    out = np.empty(n, np.int32)
    if keys.dtype.itemsize <= 4:
        k = np.ascontiguousarray(keys, np.uint32)
        rc = lib.mtxio_argsort_u32(n, _ptr(k, ctypes.c_uint32),
                                   _ptr(out, ctypes.c_int32))
    else:
        k = np.ascontiguousarray(keys, np.uint64)
        rc = lib.mtxio_argsort_u64(n, _ptr(k, ctypes.c_uint64),
                                   _ptr(out, ctypes.c_int32))
    if rc != 0:   # more keys than int32 positions
        return np.argsort(keys, kind="stable")
    return out


def ell_pack(num_rows, num_cols, n_pad, rowsize, rowidx, colidx, values,
             sort_rows):
    """The native COO -> ELLPACK packer: (colidx int32, values float64),
    each row-major (n_pad, rowsize), padding slots at column
    ``min(i, num_cols - 1)`` and value 0, each row's entries in file order
    or, with `sort_rows`, stably by column. Raises `NativeUnsupported`
    without the library, ValueError on an entry it cannot place."""
    lib = _load()
    if lib is None:
        raise NativeUnsupported("native library not built")
    rowidx = np.ascontiguousarray(rowidx, np.int32)
    colidx = np.ascontiguousarray(colidx, np.int32)
    values = np.ascontiguousarray(values, np.float64)
    res = lib.mtxio_ell_pack(
        int(num_rows), int(num_cols), int(n_pad), int(rowsize), len(rowidx),
        _ptr(rowidx, ctypes.c_int32), _ptr(colidx, ctypes.c_int32),
        _ptr(values, ctypes.c_double), 1 if sort_rows else 0)
    if not res:
        raise NativeUnsupported("ell_pack returned null")
    try:
        r = res.contents
        if r.error:
            raise ValueError(r.error.decode())
        shape = (int(n_pad), int(rowsize))
        n_el = shape[0] * shape[1]
        out_c = np.ctypeslib.as_array(r.colidx, shape=(n_el,)).copy()
        out_v = np.ctypeslib.as_array(r.values, shape=(n_el,)).copy()
        return out_c.reshape(shape), out_v.reshape(shape)
    finally:
        lib.mtxio_ell_pack_free(res)
