"""COO triplet container, the load-time format.

A host-side dataclass of NumPy arrays (0-based indices), as in
``ellspmv_tpu.formats.coo``, with the two preprocessing steps every format
conversion shares: symmetric expansion and diagonal extraction.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class CooMatrix:
    num_rows: int
    num_columns: int
    rowidx: np.ndarray   # (nnz,) int32/int64, 0-based
    colidx: np.ndarray   # (nnz,) int32/int64, 0-based
    values: np.ndarray   # (nnz,) float
    symmetry: str = "general"   # 'general' | 'symmetric'
    field: str = "real"

    @property
    def num_nonzeros(self) -> int:
        """Stored entries (file entries; symmetric off-diagonals count once)."""
        return int(self.rowidx.shape[0])

    def expand_symmetry(self) -> "CooMatrix":
        """Materialise the transposed images of off-diagonal entries.

        Each off-diagonal (i, j, v) of a symmetric file contributes (i, j, v)
        and (j, i, v); diagonal entries contribute once (csr_from_coo,
        csrspmv.c:1409-1427).
        """
        if self.symmetry != "symmetric":
            return self
        off = self.rowidx != self.colidx
        rowidx = np.concatenate([self.rowidx, self.colidx[off]])
        colidx = np.concatenate([self.colidx, self.rowidx[off]])
        values = np.concatenate([self.values, self.values[off]])
        return CooMatrix(self.num_rows, self.num_columns,
                         rowidx, colidx, values, "general", self.field)

    def split_diagonal(self):
        """Split entries into (off-diagonal COO, dense diagonal vector).

        Duplicate diagonal entries accumulate (ellspmv.c:1100). The diagonal
        has length min(rows, cols) (ellspmv.c:956).
        """
        diag_len = min(self.num_rows, self.num_columns)
        on_diag = self.rowidx == self.colidx
        diag = np.zeros(diag_len, dtype=self.values.dtype)
        np.add.at(diag, self.rowidx[on_diag], self.values[on_diag])
        rest = CooMatrix(self.num_rows, self.num_columns,
                         self.rowidx[~on_diag], self.colidx[~on_diag],
                         self.values[~on_diag], self.symmetry, self.field)
        return rest, diag
