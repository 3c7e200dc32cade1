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

from ellspmv_tpu_torch.utils.timing import span

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


def sources(csrc_dir: pathlib.Path | None = None) -> list[pathlib.Path]:
    return sorted((csrc_dir or CSRC_DIR).glob("*.cu"))


def library_path(csrc_dir: pathlib.Path | None = None,
                 build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Where the library for the sources in `csrc_dir` (default
    `CSRC_DIR`, and the headers they include) lives once built in
    `build_dir` (default `BUILD_DIR`)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted((csrc_dir or CSRC_DIR).glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return (build_dir or BUILD_DIR) / f"libellspmv_tpu_torch_{h.hexdigest()[:16]}.so"


def _fail(returncode: int, cmd: list[str], stderr: str,
          leftovers: list[pathlib.Path]):
    for path in leftovers:
        path.unlink(missing_ok=True)
    raise RuntimeError(f"nvcc failed with exit code {returncode}: "
                       f"{' '.join(cmd)}\n{stderr}")


def build(csrc_dir: pathlib.Path | None = None,
          build_dir: pathlib.Path | None = None) -> pathlib.Path:
    """Compile the sources in `csrc_dir` (default `CSRC_DIR`) into
    `build_dir` (default `BUILD_DIR`) unless the library for them exists;
    return its path. The compiler's report (registers, spills) is kept
    beside it with the suffix ``.log``. Raises RuntimeError, with the
    compiler's stderr, when nvcc is missing or fails."""
    out = library_path(csrc_dir, build_dir)
    build_dir = out.parent
    if out.exists():
        return out
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME, $PATH and the default "
            "toolkit location): the CUDA kernels of "
            "ellspmv_tpu_torch are built from source at first use")
    build_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    objs = [build_dir / f"{tag}.{src.stem}.o" for src in sources(csrc_dir)]
    jobs = []
    for src, obj in zip(sources(csrc_dir), objs):
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
    """Build if needed and load the kernels' library (once per process), in
    the span ``ops.library_load`` (`built`: whether nvcc ran)."""
    with span("ops.library_load") as s:
        path = library_path()
        built = not path.exists()
        s.set(built=built)
        return ctypes.CDLL(str(build() if built else path))


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


@functools.cache
def check_constants(*pairs: tuple[str, int]) -> None:
    """Raise unless each (getter, value) pair holds in the library: a
    constant that the host code and a kernel share, which the kernel's
    source reports through a C function of no arguments. Checked once per
    process."""
    lib = load()
    for symbol, want in pairs:
        fn = getattr(lib, symbol)
        fn.argtypes = []
        fn.restype = ctypes.c_int
        got = fn()
        if got != want:
            raise RuntimeError(f"the kernels' {symbol}() is {got}, the host "
                               f"code's {want}: sources out of step")
