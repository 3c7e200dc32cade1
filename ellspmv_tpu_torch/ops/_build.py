"""Build step for the port's CUDA kernels (the counterpart of the Pallas
compile step in the JAX package).

The sources under ``ellspmv_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a``, one ``nvcc`` process per source, all started together, and the
objects are linked into one shared library with a plain C interface, at
first use, into ``build/ellspmv_tpu_torch/`` beside the package. The
library's name carries a hash of the sources and flags, so an edited source
builds anew and an unchanged one is loaded from disk. The library is loaded
with ``ctypes``. Importing this module builds nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "ellspmv_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def find_nvcc() -> str | None:
    """nvcc under $CUDA_HOME, on $PATH, or in the toolkit's default install
    location, in that order."""
    home = os.environ.get("CUDA_HOME")
    if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    return default if os.access(default, os.X_OK) else None


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path() -> pathlib.Path:
    """Where the library for the current sources (and the headers they
    include) lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libellspmv_tpu_torch_{h.hexdigest()[:16]}.so"


def _fail(returncode: int, cmd: list[str], stderr: str,
          leftovers: list[pathlib.Path]):
    for path in leftovers:
        path.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed with exit code {returncode}: "
                       f"{' '.join(cmd)}\n{stderr}")


def build() -> pathlib.Path:
    """Compile the sources unless the library for them exists; return its
    path. The compiler's report (registers, spills) is kept beside it with
    the suffix ``.log``. Raises RuntimeError, with the compiler's stderr,
    when nvcc is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $PATH and the default "
            "toolkit location): the CUDA kernels of "
            "ellspmv_tpu_torch are built from source at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    jobs = []
    for src, obj in zip(sources(), objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.PIPE,
                                           text=True)))
    report, failed = [], None
    for cmd, proc in jobs:    # wait for every compile before reporting
        stdout, stderr = proc.communicate()
        report.append(stdout + stderr)
        if proc.returncode != 0 and failed is None:
            failed = (proc.returncode, cmd, stderr)
    if failed is not None:
        _fail(*failed, objs)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        _fail(proc.returncode, cmd, proc.stderr, [tmp, *objs])
    for obj in objs:
        obj.unlink()
    out.with_suffix(".log").write_text("".join(report))
    os.replace(tmp, out)   # atomic: a concurrent process sees all or nothing
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the kernels' library (once per process)."""
    return ctypes.CDLL(str(build()))


@functools.cache
def entry(symbol: str, argtypes: tuple):
    """The library's C entry point `symbol`, returning a CUDA error code,
    and the library's error-string function; builds and loads the library
    on first use."""
    lib = load()
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    lib.ell_spmv_error_string.argtypes = [ctypes.c_int]
    lib.ell_spmv_error_string.restype = ctypes.c_char_p
    return fn, lib.ell_spmv_error_string
