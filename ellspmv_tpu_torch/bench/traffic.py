"""Physical device-memory bytes per SpMV of the port's kernels, the
counterpart of ``ellspmv_tpu.bench.traffic``.

The reference's byte accounting (min_bytes/max_bytes, ellspmv.c:1858-1862)
is a format-independent model over the padded ELLPACK arrays, so a format
that stores less than ELLPACK (DIA stores no column indices) reports an
*effective* bandwidth above the card's peak. That number is the parity
metric against the reference; this module gives the bytes the kernel itself
must move, so that every report can also carry the physical share (at most
100% of the card's peak when the count is right):

- K1 (``csrc/ell_spmv.cu``): the slot-major values and column indices
  (``rowsize * padded_rows`` each), x once, the split diagonal when there
  is one, y when given, and the output;
- K2 (``csrc/dia_spmv.cu``): the diagonals' values (``num_diags *
  num_rows``), x once, y when given, and the output.

x is counted once: the kernels rely on L1/L2 for its re-reads.
"""

from __future__ import annotations

from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix


def estimate_actual_bytes(matrix, with_y: bool = True) -> int:
    """Bytes one kernel call on `matrix` reads and writes, with y read when
    `with_y` (as in every accumulating call of the benchmark)."""
    if isinstance(matrix, EllMatrix):
        sv = matrix.values.element_size()
        si = matrix.colidx.element_size()
        total = matrix.rowsize * matrix.padded_rows * (sv + si)
        if matrix.diag is not None:
            total += matrix.num_rows * sv
    elif isinstance(matrix, DiaMatrix):
        sv = matrix.data.element_size()
        total = matrix.diasize * sv
    else:
        raise NotImplementedError(
            f"traffic of {type(matrix).__name__} is not yet ported "
            "(see ROADMAP.md)")
    n, m = matrix.num_rows, matrix.num_columns
    return total + m * sv + (2 if with_y else 1) * n * sv
