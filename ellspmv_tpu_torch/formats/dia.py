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

`dia_from_coo` and `dia_from_jax_arrays` mark a matrix `symmetric` when
its built data shows it (`mirrored`): K2 (``ops/dia_cuda``) then reads
only the diagonals with offset >= 0. Every diagonal stays stored: the
plain versions and K8's colour-major copy read the lower ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.formats import upload
from ellspmv_tpu_torch.utils.timing import span


@dataclasses.dataclass
class DiaMatrix:
    """Diagonal storage: ``data`` is (num_diags, num_rows)."""

    data: torch.Tensor
    offsets: tuple
    num_rows: int
    num_columns: int
    num_nonzeros: int
    #: every diagonal -d holds diagonal +d's values bit for bit
    #: (`mirrored`); False unless the conversion found it so
    symmetric: bool = False

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
        with upload(device, "dia", self):
            return dataclasses.replace(self, data=self.data.to(device))


def _put(data: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """Move host data to `device` and cast it there (bf16 rounds on the
    device, as in ``ell_from_coo``)."""
    data = np.ascontiguousarray(data)
    with upload(device, "dia", data):
        return torch.from_numpy(data).to(device).to(dtype)


def mirrored(data: np.ndarray, offsets, num_rows: int,
             num_columns: int) -> bool:
    """True when the host `data` of a DIA is its own transpose bit for bit:
    the matrix is square, each offset -d has its +d, and for every d > 0
    ``data[k(-d), d:]`` equals ``data[k(+d), :n-d]`` as bits and as values.
    So a NaN, or a +0.0 against a -0.0, gives False."""
    if num_rows != num_columns or sorted(-o for o in offsets) != sorted(
            offsets):
        return False
    n, at = num_rows, {o: k for k, o in enumerate(offsets)}
    bits = np.dtype(f"u{data.dtype.itemsize}")
    for d in offsets:
        if d > 0:
            lower, upper = data[at[-d], d:], data[at[d], :n - d]
            if not (np.array_equal(lower.view(bits), upper.view(bits))
                    and np.array_equal(lower, upper)):
                return False
    return True


def dia_from_coo(coo, max_diags: int = 32, value_dtype=None,
                 device="cpu") -> DiaMatrix | None:
    """Convert a CooMatrix to DIA on `device` if it has at most `max_diags`
    distinct diagonals; duplicates accumulate. Returns None otherwise.

    `value_dtype` is a ``--precision`` name or a torch type (default: the
    COO's values' type). The span ``formats.build.dia`` (`symmetric`)
    holds ``dia.offsets`` (the distinct offsets), ``dia.scatter`` (the
    entries added into their diagonals) and ``dia.mirrored``; the copy to
    `device` follows it."""
    with span("formats.build.dia") as build:
        with span("dia.offsets"):
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
        with span("dia.scatter"):
            data = np.zeros((len(offsets), n), host_dt)
            k = np.searchsorted(offsets, off)
            np.add.at(data, (k, coo.rowidx.astype(np.int64)), coo.values)
        offsets = tuple(int(o) for o in offsets)
        # on the host values: bf16 rounds equal values to equal values
        with span("dia.mirrored"):
            symmetric = mirrored(data, offsets, n, m)
        build.set(symmetric=symmetric)
    return DiaMatrix(_put(data, dtype, device), offsets, n, m,
                     coo.num_nonzeros, symmetric)


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
    offsets = tuple(int(o) for o in offsets)
    return DiaMatrix(_put(data, dtype, device), offsets, int(num_rows),
                     int(num_columns), int(num_nonzeros),
                     mirrored(data, offsets, int(num_rows), int(num_columns)))
