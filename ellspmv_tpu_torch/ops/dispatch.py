"""Kernel dispatch, the counterpart of ``ellspmv_tpu.ops.dispatch.spmv``
(and of the reference's flag dispatch in main, ellspmv.c:1834-1843)."""

from __future__ import annotations

from ellspmv_tpu_torch.formats.ell import EllMatrix
from ellspmv_tpu_torch.ops import ell_cuda


def spmv(matrix, x, y=None):
    """y := A*x + y on the device of `matrix` and `x`, through the
    hand-written kernel."""
    if not isinstance(matrix, EllMatrix):
        raise NotImplementedError(
            f"spmv: {type(matrix).__name__} is not yet ported; only "
            "EllMatrix is (see ROADMAP.md, Queue 1 items 4-8: DIA, CSR, "
            "SELL and hybrid, stream)")
    return ell_cuda.ell_spmv(matrix, x, y)
