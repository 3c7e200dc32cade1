"""Matrix generators, one module per class, each with
``generate(params, seed, device) -> Matrix``: the COO made on `device`
from a ``torch.Generator`` seeded with `seed`."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class Matrix:
    """A square COO matrix on the device, row-major sorted, no duplicate
    entries. `distinct_values` counts the independent values drawn (a
    symmetric matrix's pair (i, j), (j, i) once); `referenced_columns` the
    columns that hold an entry. Both feed the least bytes
    (``least_bytes.py``)."""
    num_rows: int
    rows: torch.Tensor      # int64
    cols: torch.Tensor      # int64
    values: torch.Tensor    # float64
    distinct_values: int
    referenced_columns: int

    @property
    def num_nonzeros(self) -> int:
        return int(self.rows.numel())


def referenced_columns(cols: torch.Tensor, n: int) -> int:
    return int((torch.bincount(cols, minlength=n) > 0).sum())
