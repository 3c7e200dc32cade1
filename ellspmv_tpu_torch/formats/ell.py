"""ELLPACK format: (max-nnz-per-row × rows) column-index/value arrays.

Host packing has the semantics of ``ellspmv_tpu.formats.ell.ell_from_coo``
(and of the reference's ell_from_coo, ellspmv.c:931-958, 1081-1127, without
its swapped-argument call-site bug, SURVEY §2.1 E12):

- ``rowsize`` = max nonzeros per row (excluding the diagonal when split);
- padding slots get column ``min(i, num_columns-1)`` and value 0
  (ellspmv.c:1111-1117), so padded gathers stay in bounds;
- duplicate (row, col) entries occupy their own slots;
- the split diagonal accumulates duplicates (ellspmv.c:1100);
- ``sort_rows`` orders each row's entries by column;
- symmetric files are expanded;
- rows are padded to a multiple of 8.

The arrays are stored slot-major, ``(rowsize, padded_rows)``: slot ``s`` of
consecutive rows is contiguous, so a warp that handles 32 consecutive rows
reads each slot with one coalesced load. The host packs row-major, as the JAX
package does, and the transpose runs on the target device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch import config


# Rows are padded to a multiple of this (as in the JAX package).
ROW_TILE = 8


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class EllMatrix:
    """ELLPACK matrix. `colidx`/`values` are (rowsize, padded_rows); `diag`
    is (padded_rows,) when the diagonal is split, else None."""

    colidx: torch.Tensor
    values: torch.Tensor
    diag: torch.Tensor | None
    num_rows: int
    num_columns: int
    num_nonzeros: int

    @property
    def rowsize(self) -> int:
        return int(self.values.shape[0])

    @property
    def padded_rows(self) -> int:
        return int(self.values.shape[1])

    @property
    def ellsize(self) -> int:
        """num_rows*rowsize, the reference's flop/byte accounting unit
        (ellspmv.c:955, 1857)."""
        return self.num_rows * self.rowsize

    @property
    def diagsize(self) -> int:
        """min(rows, cols), counted unconditionally in the reference's flops
        formula (ellspmv.c:956, 1857)."""
        return min(self.num_rows, self.num_columns)

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "EllMatrix":
        return EllMatrix(self.colidx.to(device), self.values.to(device),
                         None if self.diag is None else self.diag.to(device),
                         self.num_rows, self.num_columns, self.num_nonzeros)


def _from_row_major(colidx: np.ndarray, values: np.ndarray,
                    diag: np.ndarray | None, num_rows: int, num_columns: int,
                    num_nonzeros: int, dtype: torch.dtype,
                    device) -> EllMatrix:
    """Move row-major host arrays to `device`, transpose them to slot-major
    there and cast the values to `dtype`."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return EllMatrix(put(colidx).t().contiguous(),
                     put(values).t().contiguous().to(dtype),
                     None if diag is None else put(diag).to(dtype),
                     num_rows, num_columns, num_nonzeros)


def ell_from_coo(coo, separate_diagonal: bool = False,
                 sort_rows: bool = False, value_dtype=None,
                 index_dtype=None,
                 device="cpu") -> EllMatrix:
    """Convert a CooMatrix to ELLPACK on `device`.

    `value_dtype` is a ``--precision`` name or a torch type (default: the
    COO's values' type); `index_dtype` is int32, int64 or None for auto.
    """
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    nnz_total = coo.num_nonzeros

    diag = None
    if separate_diagonal:
        coo, diag = coo.split_diagonal()

    counts = np.bincount(coo.rowidx, minlength=n) if n else np.zeros(0, int)
    rowsize = int(counts.max()) if n and counts.size else 0

    idx_dt = config.select_index_dtype(n, m, max(nnz_total, 1), index_dtype)
    dtype = config.value_dtype(coo.values.dtype if value_dtype is None
                               else value_dtype)
    # bf16 has no numpy type: pack in float64, round on the device
    host_dt = (np.dtype(np.float64) if dtype == torch.bfloat16
               else torch.empty(0, dtype=dtype).numpy().dtype)

    n_pad = max(_round_up(n, ROW_TILE), ROW_TILE)
    pad_col = np.minimum(np.arange(n_pad, dtype=idx_dt),
                         max(m - 1, 0)).astype(idx_dt)
    colidx = np.broadcast_to(pad_col[:, None], (n_pad, rowsize)).copy()
    values = np.zeros((n_pad, rowsize), host_dt)
    if coo.num_nonzeros and rowsize:
        # One sort by (row [, col]) gives each entry its slot: the
        # reference's per-row fill cursor (ellspmv.c:1097-1107) and rowsort.
        if sort_rows:
            order = np.lexsort((coo.colidx, coo.rowidx))
        else:
            order = np.argsort(coo.rowidx, kind="stable")
        r = coo.rowidx[order]
        rowptr = np.zeros(n + 1, dtype=np.int64)
        rowptr[1:] = np.cumsum(counts)
        slot = np.arange(len(r), dtype=np.int64) - rowptr[r]
        colidx[r, slot] = coo.colidx[order].astype(idx_dt)
        values[r, slot] = coo.values[order].astype(host_dt)

    if diag is not None:
        d = np.zeros(n_pad, host_dt)
        d[:len(diag)] = diag.astype(host_dt)
        diag = d

    return _from_row_major(colidx, values, diag, n, m, nnz_total, dtype,
                           device)


def ell_from_jax_arrays(colidx, values, diag, num_rows: int,
                        num_columns: int, num_nonzeros: int,
                        device="cpu") -> EllMatrix:
    """Build the port's EllMatrix from the host arrays of an
    ``ellspmv_tpu.formats.ell.EllMatrix`` (row-major ``(padded_rows,
    rowsize)`` colidx/values and the padded diagonal), so that both packages
    compute on identical data. bfloat16 values (an ``ml_dtypes`` array) are
    widened to float32 on the host, which is exact, and narrowed back on the
    device."""
    values = np.asarray(values)
    if values.dtype.name == "bfloat16":
        dtype = torch.bfloat16
        values = values.astype(np.float32)
        diag = None if diag is None else np.asarray(diag).astype(np.float32)
    else:
        dtype = config.value_dtype(values.dtype)
    return _from_row_major(np.asarray(colidx), values,
                           None if diag is None else np.asarray(diag),
                           int(num_rows), int(num_columns),
                           int(num_nonzeros), dtype, device)
