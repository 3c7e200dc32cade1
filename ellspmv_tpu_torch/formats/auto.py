"""Automatic format selection between DIA, ELL and the stream format, the
counterpart of ``ellspmv_tpu.formats.auto.auto_from_coo``.

The gates are the JAX chooser's:

- where ELLPACK padding blows up (more than 4x the nonzeros and over 1M
  slots), the stream format;
- else DIA when the matrix has at least 3 nonzeros per row, the diagonal is
  not split, DIA is allowed, the matrix has at most 32 distinct diagonals
  (``dia_from_coo``'s limit, within the kernel's 64) and the diagonals are
  at least half full, and DIA moves fewer bytes than ELL;
- else ELL or the stream format, whichever moves fewer bytes.

The prices are this card's: all the kernels are bound by device-memory
bytes, so each candidate is priced by the bytes its kernels move, at the
card's data-sheet peak (``config.hbm_peak_bytes_per_s``); only the chosen
matrix is built on `device`:

- DIA: ``(diasize + 2*rows) * value bytes``, as the JAX chooser prices it;
- ELL: ``ellsize * value bytes + 2*rows * value bytes`` plus the column
  indices at the width K1 will read them
  (``formats/ell.index_bytes_estimate``: 2 bytes a slot where the narrow
  layout holds, else the index type's);
- stream: ``bench/traffic.stream_bytes_estimate``, its products' indices
  by the same rule. The products lie in the sum plan's position order, so
  their layout is known only once the plan is built: where the stream
  format must be priced (where the padding blows up, or where it could
  beat ELL even with 2-byte columns), its plan and products are laid out
  on the host (``formats/stream.stream_layout``) and priced by the column
  layout the products take; the format is finished on `device` from that
  layout only when chosen.

The rate cancels in the comparisons; it only turns bytes into the estimated
milliseconds shown in ``_auto_reason``. No TPU constant of the JAX chooser
or its calibration is used.

Not yet ported: where the padding blows up, the JAX chooser also prices the
SELL split against the stream format; the port takes the stream format
there (ROADMAP.md, Queue 1 item 6).
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
    """Return DIA, ELL or the stream format on `device`, whichever moves the
    fewest bytes per SpMV within the JAX chooser's gates.

    The decision is recorded on the returned matrix as `_auto_choice`
    ('dia', 'ell' or 'stream') with `_auto_reason` for verbose reporting.
    Only the chosen matrix is built on `device`."""
    from ellspmv_tpu_torch.bench.traffic import stream_bytes_estimate
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.formats.ell import (ell_from_coo,
                                               index_bytes_estimate)
    from ellspmv_tpu_torch.formats.stream import (compute_dtype,
                                                  stream_from_layout,
                                                  stream_layout)
    from ellspmv_tpu_torch.ops.dia_cuda import MAX_DIAGS

    expanded = coo.expand_symmetry()
    n, m = expanded.num_rows, expanded.num_columns
    nnz = max(expanded.num_nonzeros, 1)
    counts = (np.bincount(expanded.rowidx, minlength=n)
              if n else np.zeros(0, int))
    rowsize = int(counts.max()) if counts.size else 0
    ellsize = n * rowsize

    dtype = config.value_dtype(expanded.values.dtype if value_dtype is None
                               else value_dtype)
    rate = config.hbm_peak_bytes_per_s(device)

    def stream_bytes(narrow: bool) -> int:
        return stream_bytes_estimate(
            nnz, n, m,
            torch.empty(0, dtype=compute_dtype(dtype)).element_size(),
            narrow)

    def stream_on_host():
        """The stream format's plan and position-order products on the
        host, and its price by the column layout the products take."""
        layout = stream_layout(coo, separate_diagonal=separate_diagonal)
        return layout, stream_bytes(layout.products_narrow())

    def pick_stream(layout, reason):
        sm = stream_from_layout(layout, value_dtype=dtype, device=device)
        sm._auto_choice = "stream"
        sm._auto_reason = reason
        return sm

    if ellsize > MAX_PAD_RATIO * nnz and ellsize > 1 << 20:
        layout, price = stream_on_host()
        return pick_stream(
            layout, f"ELL padding blowup ({ellsize:,} slots for {nnz:,} "
            f"nonzeros); stream ({_cost(price, rate)}); the SELL split, "
            "which the JAX chooser prices against it here, is not yet "
            "ported")

    vb = torch.empty(0, dtype=dtype).element_size()
    ib = np.dtype(config.select_index_dtype(n, m, nnz, index_dtype)).itemsize
    ell_bytes = (ellsize * vb + 2 * n * vb + index_bytes_estimate(
        expanded.rowidx, expanded.colidx, n, m, rowsize, ib))
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
    # 2-byte product columns are the stream format's least price
    least = stream_bytes(True)
    stream_price = f"at least {_cost(least, rate)}"
    if least < ell_bytes:
        layout, price = stream_on_host()
        if price < ell_bytes:
            return pick_stream(layout, f"stream ({_cost(price, rate)}) "
                                       f"beats ELL ({_cost(ell_bytes, rate)})")
        stream_price = _cost(price, rate)
    ell = ell_from_coo(coo, separate_diagonal=separate_diagonal,
                       sort_rows=sort_rows, value_dtype=dtype,
                       index_dtype=index_dtype, device=device)
    ell._auto_choice = "ell"
    ell._auto_reason = ((why_ell or f"ELL ({_cost(ell_bytes, rate)})")
                        + f"; ELL beats the stream format ({stream_price})")
    return ell
