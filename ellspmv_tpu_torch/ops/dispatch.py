"""Kernel dispatch, the counterpart of ``ellspmv_tpu.ops.dispatch.spmv``
(and of the reference's flag dispatch in main, ellspmv.c:1834-1843)."""

from __future__ import annotations

from ellspmv_tpu_torch.formats.csr import CsrMatrix
from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix
from ellspmv_tpu_torch.formats.sell import SellMatrix, sell_spmv
from ellspmv_tpu_torch.formats.stream import StreamMatrix, stream_spmv
from ellspmv_tpu_torch.ops import dia_cuda, ell_cuda
from ellspmv_tpu_torch.ops.csr import csr_spmv


def spmv(matrix, x, y=None):
    """y := A*x + y on the device of `matrix` and `x`, through the
    hand-written kernels of the matrix's format."""
    if isinstance(matrix, DiaMatrix):
        return dia_cuda.dia_spmv(matrix, x, y)
    if isinstance(matrix, EllMatrix):
        return ell_cuda.ell_spmv(matrix, x, y)
    if isinstance(matrix, StreamMatrix):
        return stream_spmv(matrix, x, y)
    if isinstance(matrix, SellMatrix):
        return sell_spmv(matrix, x, y)
    if isinstance(matrix, CsrMatrix):
        # the sliced-ELL repack on K1, the JAX package's route on the TPU
        return csr_spmv(matrix, x, y)
    raise NotImplementedError(
        f"spmv: {type(matrix).__name__} is not yet ported; only EllMatrix, "
        "DiaMatrix, StreamMatrix, SellMatrix and CsrMatrix are (see "
        "ROADMAP.md, Queue 1: the hybrid format)")
