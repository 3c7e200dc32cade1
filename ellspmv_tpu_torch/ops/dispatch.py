"""Kernel dispatch, the counterpart of ``ellspmv_tpu.ops.dispatch.spmv``
(and of the reference's flag dispatch in main, ellspmv.c:1834-1843), keyed
on the format and the backend.

``auto`` and ``pallas`` run the hand-written kernels. ``xla`` runs the plain
PyTorch versions, on the matrix's device, of exactly what the JAX
package's ``xla`` backend moves off its Pallas kernels: ELL through
``ell_cuda.ell_spmv_torch``, CSR through the segment sum
(``ops/csr.csr_spmv_segment``, the counterpart of ``csr_xla``), and the
buckets of SELL and of both hybrid parts through the ELL plain version. DIA
and the stream format keep their kernels, as the JAX package ignores the
backend for them; so does the hybrid's gather of x, which the JAX package
runs the same way under every backend. The backend is only ever what the
user asked for: nothing moves to a plain version because a kernel failed.
"""

from __future__ import annotations

from ellspmv_tpu_torch.formats.csr import CsrMatrix
from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix
from ellspmv_tpu_torch.formats.hybrid import HybridMatrix, hybrid_spmv
from ellspmv_tpu_torch.formats.sell import (SellMatrix, bucket_spmv,
                                            sell_spmv)
from ellspmv_tpu_torch.formats.stream import StreamMatrix, stream_spmv
from ellspmv_tpu_torch.ops import dia_cuda
from ellspmv_tpu_torch.ops.csr import csr_spmv, csr_spmv_segment

def spmv(matrix, x, y=None, backend: str = "auto"):
    """y := A*x + y on the device of `matrix` and `x`, through the
    hand-written kernels of the matrix's format (`backend` ``auto`` or
    ``pallas``) or the plain versions that ``xla`` names."""
    if isinstance(matrix, DiaMatrix):
        return dia_cuda.dia_spmv(matrix, x, y)
    if isinstance(matrix, EllMatrix):
        return bucket_spmv(backend)(matrix, x, y)
    if isinstance(matrix, StreamMatrix):
        return stream_spmv(matrix, x, y)
    if isinstance(matrix, SellMatrix):
        return sell_spmv(matrix, x, y, backend=backend)
    if isinstance(matrix, HybridMatrix):
        return hybrid_spmv(matrix, x, y, backend=backend)
    if isinstance(matrix, CsrMatrix):
        if backend == "xla":
            return csr_spmv_segment(matrix, x, y)
        # the sliced-ELL repack on K1, the JAX package's route on the TPU
        return csr_spmv(matrix, x, y)
    raise TypeError(f"unsupported matrix type {type(matrix)}")
