"""Automatic format selection between DIA and ELL, the counterpart of the
DIA/ELL branch of ``ellspmv_tpu.formats.auto.auto_from_coo``.

The gates are the JAX chooser's: DIA is a candidate when the matrix has at
least 3 nonzeros per row, the diagonal is not split, DIA is allowed, the
matrix has at most 32 distinct diagonals (``dia_from_coo``'s limit, within
the kernel's 64) and the diagonals are at least half full. The prices are
this card's: both kernels are bound by device-memory bytes, so each
candidate is priced by the bytes its kernel moves, at the card's data-sheet
peak (``config.hbm_peak_bytes_per_s``):

- DIA: ``(diasize + 2*rows) * value bytes``, as the JAX chooser prices it;
- ELL: ``ellsize * (value + index bytes) + 2*rows * value bytes``, from the
  row counts alone (no ELL matrix is built to be priced).

The rate cancels in the comparison; it only turns bytes into the estimated
milliseconds shown in ``_auto_reason``. No TPU constant of the JAX chooser
or its calibration is used.

Not yet ported: where JAX would price the SELL split and the stream format
against each other (ELLPACK padding more than 4x the nonzeros), this
chooser raises NotImplementedError; where ELL wins, the stream candidate is
not priced (ROADMAP.md, Queue 1 items 6 and 8).
"""

from __future__ import annotations

import numpy as np
import torch

from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.formats.coo import CooMatrix

# ELL padding acceptance (``ellspmv_tpu.formats.auto._MAX_PAD_RATIO``):
# beyond this the JAX chooser leaves ELL for SELL or the stream format.
MAX_PAD_RATIO = 4.0


def _cost(nbytes: int, rate: float | None) -> str:
    if rate is None:
        return f"{nbytes:,} bytes"
    return f"est {nbytes / rate * 1e3:.3f} ms"


def auto_from_coo(coo: CooMatrix, separate_diagonal: bool = False,
                  sort_rows: bool = True, value_dtype=None,
                  index_dtype=None, allow_dia: bool = True, device="cpu"):
    """Return DIA or ELL on `device`, whichever moves fewer bytes per SpMV.

    The decision is recorded on the returned matrix as `_auto_choice`
    ('dia' or 'ell') with `_auto_reason` for verbose reporting. Only the
    chosen matrix is built on `device`."""
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.ops.dia_cuda import MAX_DIAGS

    expanded = coo.expand_symmetry()
    n, m = expanded.num_rows, expanded.num_columns
    nnz = max(expanded.num_nonzeros, 1)
    counts = (np.bincount(expanded.rowidx, minlength=n)
              if n else np.zeros(0, int))
    rowsize = int(counts.max()) if counts.size else 0
    ellsize = n * rowsize

    if ellsize > MAX_PAD_RATIO * nnz and ellsize > 1 << 20:
        raise NotImplementedError(
            f"auto_from_coo: ELL padding blowup ({ellsize:,} slots for "
            f"{nnz:,} nonzeros): the SELL/stream branch that the JAX "
            "chooser takes here is not yet ported (see ROADMAP.md)")

    dtype = config.value_dtype(expanded.values.dtype if value_dtype is None
                               else value_dtype)
    vb = torch.empty(0, dtype=dtype).element_size()
    ib = np.dtype(config.select_index_dtype(n, m, nnz, index_dtype)).itemsize
    rate = config.hbm_peak_bytes_per_s(device)
    ell_bytes = ellsize * (vb + ib) + 2 * n * vb
    why_ell = None
    if allow_dia and separate_diagonal is False and nnz >= 3 * n:
        dia = dia_from_coo(coo, value_dtype=dtype)    # on the host
        if (dia is not None and dia.diasize <= 2 * nnz
                and dia.num_diags <= MAX_DIAGS):
            dia_bytes = (dia.diasize + 2 * n) * vb
            if dia_bytes < ell_bytes:
                dia = dia.to(device)
                dia._auto_choice = "dia"
                dia._auto_reason = (
                    f"{dia.num_diags} dense diagonals "
                    f"({_cost(dia_bytes, rate)} <= ELL "
                    f"{_cost(ell_bytes, rate)})")
                return dia
            why_ell = (f"ELL ({_cost(ell_bytes, rate)}) beats "
                       f"{dia.num_diags} diagonals "
                       f"({_cost(dia_bytes, rate)})")
    ell = ell_from_coo(coo, separate_diagonal=separate_diagonal,
                       sort_rows=sort_rows, value_dtype=dtype,
                       index_dtype=index_dtype, device=device)
    ell._auto_choice = "ell"
    ell._auto_reason = ((why_ell or f"ELL ({_cost(ell_bytes, rate)})")
                        + "; the stream format is not yet priced (not yet "
                        "ported)")
    return ell
