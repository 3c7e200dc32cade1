"""CSR format: rowptr / colidx / values, with the row id of every entry and
an optional split diagonal.

Host packing has the semantics of ``ellspmv_tpu.formats.csr.csr_from_coo``
(the reference's csr_from_coo_size and csr_from_coo, csrspmv.c:1219-1267,
1390-1475), step for step:

- symmetric matrices are expanded: every off-diagonal stored entry counts
  twice, as (i,j) and (j,i) (csrspmv.c:1240-1248);
- ``separate_diagonal`` extracts a dense diagonal of length num_rows, only
  for square matrices (csrspmv.c:1265), accumulating duplicates;
- ``sort_rows`` orders each row's entries by column.

``rowids`` (the row of every stored entry) is kept beside ``rowptr``: the
segment-sum form of the SpMV (``ops/csr.csr_spmv_segment``) reads it, as the
JAX package's does. The arrays are built on the host with NumPy and held as
torch tensors; ``to(device)`` moves them. The card runs a CSR through its
sliced-ELL repack on K1 (``ops/csr.csr_spmv``), cached on the matrix.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch import config


@dataclasses.dataclass
class CsrMatrix:
    rowptr: torch.Tensor          # (num_rows+1,)
    colidx: torch.Tensor          # (csrsize,)
    values: torch.Tensor          # (csrsize,)
    rowids: torch.Tensor          # (csrsize,) row index per entry
    diag: torch.Tensor | None     # (num_rows,) or None
    num_rows: int
    num_columns: int
    num_nonzeros: int

    @property
    def csrsize(self) -> int:
        """Stored entries after symmetric expansion and the diagonal split,
        the reference's flop unit (csrspmv.c:1264, 2882)."""
        return int(self.values.shape[0])

    @property
    def diagsize(self) -> int:
        """num_rows when the diagonal is split on a square matrix, else 0
        (csrspmv.c:1265)."""
        return 0 if self.diag is None else int(self.diag.shape[0])

    @property
    def rowsize_min(self) -> int:
        c = torch.diff(self.rowptr)
        return int(c.min()) if c.numel() else 0

    @property
    def rowsize_max(self) -> int:
        c = torch.diff(self.rowptr)
        return int(c.max()) if c.numel() else 0

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "CsrMatrix":
        """The matrix on `device`, with its cached sliced-ELL repack, if it
        has one, moved too."""
        def move(t):
            return None if t is None else t.to(device)
        moved = CsrMatrix(move(self.rowptr), move(self.colidx),
                          move(self.values), move(self.rowids),
                          move(self.diag), self.num_rows, self.num_columns,
                          self.num_nonzeros)
        cached = getattr(self, "_sell_cache", None)
        if cached is not None:
            moved._sell_cache = cached.to(device)
        return moved


def _tensors(rowptr, colidx, values, rowids, diag, dtype, device):
    """Host arrays as tensors on `device`, the values (and diagonal) in
    `dtype`. bf16 has no NumPy type: its values come as float64 and are
    rounded on the device."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return (put(rowptr), put(colidx), put(values).to(dtype), put(rowids),
            None if diag is None else put(diag).to(dtype))


def csr_from_coo(coo, separate_diagonal: bool = False,
                 sort_rows: bool = False, value_dtype=None,
                 index_dtype=None, device="cpu") -> CsrMatrix:
    """Convert a CooMatrix to CSR on `device` (symmetric expansion
    included). `value_dtype` is a ``--precision`` name or a torch type
    (default: the COO's values' type); `index_dtype` is int32, int64 or
    None for auto."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    nnz_total = coo.num_nonzeros

    diag = None
    if separate_diagonal and n == m:
        coo, diag = coo.split_diagonal()

    idx_dt = config.select_index_dtype(n, m, max(nnz_total, 1), index_dtype)
    dtype = config.value_dtype(coo.values.dtype if value_dtype is None
                               else value_dtype)
    host_dt = (np.dtype(np.float64) if dtype == torch.bfloat16
               else torch.empty(0, dtype=dtype).numpy().dtype)

    if sort_rows:
        order = np.lexsort((coo.colidx, coo.rowidx))
    else:
        order = np.argsort(coo.rowidx, kind="stable")
    rowids = coo.rowidx[order].astype(idx_dt)
    colidx = coo.colidx[order].astype(idx_dt)
    values = coo.values[order].astype(host_dt)

    rowptr = np.zeros(n + 1, dtype=idx_dt)
    rowptr[1:] = np.cumsum(np.bincount(rowids, minlength=n))

    if diag is not None:
        diag = diag.astype(host_dt)
    return CsrMatrix(*_tensors(rowptr, colidx, values, rowids, diag, dtype,
                               device),
                     num_rows=n, num_columns=m, num_nonzeros=nnz_total)


def csr_from_jax_arrays(rowptr, colidx, values, rowids, diag, num_rows: int,
                        num_columns: int, num_nonzeros: int,
                        device="cpu") -> CsrMatrix:
    """Build the port's CsrMatrix from the host arrays of an
    ``ellspmv_tpu.formats.csr.CsrMatrix``, so that both packages compute on
    identical data. bfloat16 values (an ``ml_dtypes`` array) are widened to
    float64 on the host, which is exact, and narrowed back on the
    device."""
    values = np.asarray(values)
    if values.dtype.name == "bfloat16":
        dtype = torch.bfloat16
        values = values.astype(np.float64)
        diag = None if diag is None else np.asarray(diag).astype(np.float64)
    else:
        dtype = config.value_dtype(values.dtype)
    return CsrMatrix(*_tensors(np.asarray(rowptr), np.asarray(colidx), values,
                               np.asarray(rowids),
                               None if diag is None else np.asarray(diag),
                               dtype, device),
                     num_rows=int(num_rows), num_columns=int(num_columns),
                     num_nonzeros=int(num_nonzeros))
