"""Build step for the port's CUDA kernels (the counterpart of the Pallas
compile step in the JAX package).

The sources under ``ellspmv_tpu_torch/csrc/`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first use,
into ``build/ellspmv_tpu_torch/`` beside the package. The library's name
carries a hash of the sources and flags, so an edited source builds anew and
an unchanged one is loaded from disk. The library is loaded with ``ctypes``.
Importing this module builds nothing.
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
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    """Where the library for the current sources lives once built."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libellspmv_tpu_torch_{h.hexdigest()[:16]}.so"


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
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed with exit code {proc.returncode}: "
                           f"{' '.join(cmd)}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)   # atomic: a concurrent process sees all or nothing
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed and load the kernels' library (once per process)."""
    return ctypes.CDLL(str(build()))
