"""ellspmv_tpu_torch: the PyTorch and CUDA port of ``ellspmv_tpu``.

The JAX package beside it is the reference. This package reads Matrix Market
files, converts them to ELLPACK, and computes ``y := A*x + y`` with a
hand-written CUDA kernel for Hopper (``csrc/ell_spmv.cu``), timed with the
reference's protocol and metrics. Module names mirror the JAX package's.

Importing the package builds nothing: the kernel is compiled with ``nvcc`` at
its first launch on a CUDA tensor (``ops/_build.py``).
"""

from ellspmv_tpu_torch.config import default_index_dtype, select_index_dtype
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix, ell_from_coo
from ellspmv_tpu_torch.io.mtx import read_matrix, read_vector, write_vector
from ellspmv_tpu_torch.ops.dispatch import spmv

__version__ = "0.1.0"

__all__ = [
    "CooMatrix",
    "EllMatrix",
    "default_index_dtype",
    "ell_from_coo",
    "read_matrix",
    "read_vector",
    "select_index_dtype",
    "spmv",
    "write_vector",
]
