"""ellspmv_tpu_torch: the PyTorch and CUDA port of ``ellspmv_tpu``.

The JAX package beside it is the reference. This package reads Matrix Market
files, converts them to ELLPACK, DIA or the stream format (or lets
``auto_from_coo`` choose), and computes ``y := A*x + y`` with hand-written
CUDA kernels for Hopper (``csrc/*.cu``), timed with the reference's
protocols and metrics, and solves with CG. Module names mirror the JAX
package's.

Importing the package builds nothing: the kernels are compiled with
``nvcc`` at the first launch on a CUDA tensor (``ops/_build.py``).
"""

from ellspmv_tpu_torch.config import default_index_dtype, select_index_dtype
from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.dia import DiaMatrix, dia_from_coo
from ellspmv_tpu_torch.formats.ell import EllMatrix, ell_from_coo
from ellspmv_tpu_torch.formats.stream import StreamMatrix, stream_from_coo
from ellspmv_tpu_torch.io.mtx import read_matrix, read_vector, write_vector
from ellspmv_tpu_torch.ops.dispatch import spmv

__version__ = "0.1.0"

__all__ = [
    "CooMatrix",
    "DiaMatrix",
    "EllMatrix",
    "StreamMatrix",
    "auto_from_coo",
    "default_index_dtype",
    "dia_from_coo",
    "ell_from_coo",
    "read_matrix",
    "read_vector",
    "select_index_dtype",
    "spmv",
    "stream_from_coo",
    "write_vector",
]
