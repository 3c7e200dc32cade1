"""DIA (diagonal) format: ``data[k, i]`` multiplies ``x[i + offsets[k]]``
into ``y[i]``.

Host packing has the semantics of ``ellspmv_tpu.formats.dia.dia_from_coo``,
step for step: symmetric files are expanded, the distinct offsets
``col - row`` are found with ``np.unique``, and entries are accumulated into
their diagonal with ``np.add.at`` in the values' type, so duplicates sum in
the same order and the data is equal to the JAX package's bit for bit. A
matrix with more than `max_diags` distinct diagonals is not diagonal-sparse
and gives None; callers then use ELL.

``data`` is ``(num_diags, num_rows)`` on an explicit device; positions whose
column ``i + offsets[k]`` falls outside ``[0, num_columns)`` hold 0. The
offsets stay on the host as a tuple: the kernel takes them by value.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch import config


@dataclasses.dataclass
class DiaMatrix:
    """Diagonal storage: ``data`` is (num_diags, num_rows)."""

    data: torch.Tensor
    offsets: tuple
    num_rows: int
    num_columns: int
    num_nonzeros: int

    @property
    def num_diags(self) -> int:
        return len(self.offsets)

    @property
    def diasize(self) -> int:
        """Stored values (the flop/byte unit for DIA)."""
        return self.num_diags * self.num_rows

    @property
    def device(self) -> torch.device:
        return self.data.device

    def to(self, device) -> "DiaMatrix":
        return DiaMatrix(self.data.to(device), self.offsets, self.num_rows,
                         self.num_columns, self.num_nonzeros)


def _put(data: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Move host data to `device` and cast it there (bf16 rounds on the
    device, as in ``ell_from_coo``)."""
    return torch.from_numpy(np.ascontiguousarray(data)).to(device).to(dtype)


def dia_from_coo(coo, max_diags: int = 32, value_dtype=None,
                 device="cpu") -> DiaMatrix | None:
    """Convert a CooMatrix to DIA on `device` if it has at most `max_diags`
    distinct diagonals; duplicates accumulate. Returns None otherwise.

    `value_dtype` is a ``--precision`` name or a torch type (default: the
    COO's values' type)."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    off = coo.colidx.astype(np.int64) - coo.rowidx.astype(np.int64)
    offsets = np.unique(off)
    if len(offsets) > max_diags:
        return None
    dtype = config.value_dtype(coo.values.dtype if value_dtype is None
                               else value_dtype)
    # bf16 has no numpy type: accumulate in float64, round on the device
    host_dt = (np.dtype(np.float64) if dtype == torch.bfloat16
               else torch.empty(0, dtype=dtype).numpy().dtype)
    data = np.zeros((len(offsets), n), host_dt)
    k = np.searchsorted(offsets, off)
    np.add.at(data, (k, coo.rowidx.astype(np.int64)), coo.values)
    return DiaMatrix(_put(data, dtype, device),
                     tuple(int(o) for o in offsets), n, m, coo.num_nonzeros)


def dia_from_jax_arrays(data, offsets, num_rows: int, num_columns: int,
                        num_nonzeros: int, device="cpu") -> DiaMatrix:
    """Build the port's DiaMatrix from the host data of an
    ``ellspmv_tpu.formats.dia.DiaMatrix``, so that both packages compute on
    identical data. bfloat16 data (an ``ml_dtypes`` array) is widened to
    float32 on the host, which is exact, and narrowed back on the device."""
    data = np.asarray(data)
    if data.dtype.name == "bfloat16":
        dtype, data = torch.bfloat16, data.astype(np.float32)
    else:
        dtype = config.value_dtype(data.dtype)
    return DiaMatrix(_put(data, dtype, device),
                     tuple(int(o) for o in offsets), int(num_rows),
                     int(num_columns), int(num_nonzeros))
