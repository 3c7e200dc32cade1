"""Automatic format selection between DIA, ELL, the SELL split and the
stream format, the counterpart of ``ellspmv_tpu.formats.auto.auto_from_coo``.

The gates are the JAX chooser's:

- where ELLPACK padding blows up (more than 4x the nonzeros and over 1M
  slots), the SELL split (``sell_from_coo`` with sorted rows and the
  length sort) or the stream format, whichever moves fewer bytes (SELL
  where they tie);
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
- SELL: ``bench/traffic.sell_bytes`` of the SELL split's shape (its
  buckets' slots and columns at the width K1 reads them, and the
  reassembly passes), worked out from the rows' counts and column extremes
  (``formats/sell.sell_shape``, exactly the shape ``sell_from_coo``
  builds); the split is built on the host, and moved to `device`, only
  where it is chosen;
- stream: ``bench/traffic.stream_bytes_estimate``, its products' indices
  by the same rule. The products lie in the sum plan's position order, so
  their layout is known only once the plan is built: where the stream
  format must be priced (where the padding blows up, or where it could
  beat ELL even with 2-byte columns), its plan and products are laid out
  on the host (``formats/stream.stream_layout``) and priced by the column
  layout the products take; the format is finished on `device` from that
  layout only when chosen.

At the blowup gate each K1 launch is priced by its geometry as well
(``bench/traffic.k1_launch_seconds``): a launch whose blocks do not fill
the card's SMs takes at least its rounds of dependent loads at the card's
measured round latency (``config.k1_geometry``), whatever its bytes. That
prices every SELL bucket and the stream's K1 over its products alike; the
SELL split's short wide buckets are what it catches. Elsewhere the rate
cancels in the comparisons; it only turns bytes into the estimated
milliseconds shown in ``_auto_reason``. Without a card the prices are
those of ``config.HOST_PRICED_CARD``. No TPU constant of the JAX chooser or
its calibration is used, so the two may choose differently near a line
(ROADMAP.md, F8).
"""

from __future__ import annotations

import numpy as np
import torch

from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.utils.timing import span

# ELL padding acceptance (``ellspmv_tpu.formats.auto._MAX_PAD_RATIO``):
# beyond this the JAX chooser leaves ELL for SELL or the stream format.
MAX_PAD_RATIO = 4.0


def _cost(nbytes: int, rate: float) -> str:
    return _ms(nbytes / rate)


def _ms(seconds: float) -> str:
    return f"est {seconds * 1e3:.3f} ms"


def auto_from_coo(coo: CooMatrix, separate_diagonal: bool = False,
                  sort_rows: bool = True, value_dtype=None,
                  index_dtype=None, allow_dia: bool = True, device="cpu"):
    """Return DIA, ELL, the SELL split or the stream format on `device`,
    whichever moves the fewest bytes per SpMV within the JAX chooser's
    gates.

    The decision is recorded on the returned matrix as `_auto_choice`
    ('dia', 'ell', 'sell' or 'stream') with `_auto_reason` for verbose
    reporting. Only the chosen matrix is built on `device`.

    The work is recorded in spans (``utils/timing.py``): the root
    ``formats.auto_from_coo`` (attributes `rows`, `nonzeros`, `choice`),
    ``formats.counts`` (what every candidate shares),
    ``formats.price.<fmt>`` and ``formats.build.<fmt>`` for each candidate
    priced or built on the host (``formats.price.sell`` with the SELL
    split's `buckets` and `slots`, and `built` False: it is priced from
    its shape and built only where chosen), and ``formats.upload`` for the
    copy of the chosen one to a card."""
    with span("formats.auto_from_coo", rows=coo.num_rows,
              nonzeros=coo.num_nonzeros) as root:
        matrix = _choose(coo, separate_diagonal, sort_rows, value_dtype,
                         index_dtype, allow_dia, device)
        root.set(choice=matrix._auto_choice)
        return matrix


def _choose(coo, separate_diagonal, sort_rows, value_dtype, index_dtype,
            allow_dia, device):
    from ellspmv_tpu_torch.bench.traffic import (sell_seconds,
                                                 stream_bytes_estimate,
                                                 stream_seconds_estimate)
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.formats.ell import (ell_from_coo,
                                               index_bytes_estimate)
    from ellspmv_tpu_torch.formats.sell import sell_from_coo, sell_shape
    from ellspmv_tpu_torch.formats.stream import (compute_dtype,
                                                  stream_from_layout,
                                                  stream_layout)
    from ellspmv_tpu_torch.ops.dia_cuda import MAX_DIAGS

    with span("formats.counts"):
        expanded = coo.expand_symmetry()
        n, m = expanded.num_rows, expanded.num_columns
        nnz = max(expanded.num_nonzeros, 1)
        counts = (np.bincount(expanded.rowidx, minlength=n)
                  if n else np.zeros(0, int))
        rowsize = int(counts.max()) if counts.size else 0
        ellsize = n * rowsize

        dtype = config.value_dtype(expanded.values.dtype
                                   if value_dtype is None else value_dtype)
        rate = config.pricing_rate(device)
        stream_vb = torch.empty(0, dtype=compute_dtype(dtype)).element_size()

    def stream_bytes(narrow: bool) -> int:
        return stream_bytes_estimate(nnz, n, m, stream_vb, narrow)

    def stream_on_host():
        """The stream format's plan and position-order products on the
        host, and its price by the column layout the products take."""
        layout = stream_layout(coo, separate_diagonal=separate_diagonal)
        with span("formats.price.stream"):
            return layout, stream_bytes(layout.products_narrow())

    def pick_stream(layout, reason):
        sm = stream_from_layout(layout, value_dtype=dtype, device=device)
        sm._auto_choice = "stream"
        sm._auto_reason = reason
        return sm

    if ellsize > MAX_PAD_RATIO * nnz and ellsize > 1 << 20:
        # ELLPACK is out (rows x longest row, ellspmv.c:955). The SELL
        # split (a few long rows over a local bulk), priced by its shape,
        # against the stream format (no column locality), laid out on the
        # host and priced by its bytes
        blow = f"ELL padding blowup ({ellsize:,} slots for {nnz:,} nonzeros)"
        layout = stream_layout(coo, separate_diagonal=separate_diagonal)
        with span("formats.price.stream"):
            geometry = (rate, *config.k1_geometry(device, dtype))
            price = stream_seconds_estimate(nnz, n, m, stream_vb,
                                            layout.products_narrow(),
                                            *geometry)
        sell_kw = dict(sort_rows=True, length_sort=True, value_dtype=dtype,
                       index_dtype=index_dtype)
        with span("formats.price.sell", built=False) as s:
            shape = sell_shape(coo, **sell_kw)
            sell_price = sell_seconds(shape, *geometry)
            s.set(buckets=len(shape.buckets), slots=shape.slots)
        if sell_price <= price:
            sell = sell_from_coo(coo, **sell_kw).to(device)
            sell._auto_choice = "sell"
            sell._auto_reason = (f"{blow}; SELL split ({_ms(sell_price)}) "
                                 f"<= stream ({_ms(price)})")
            return sell
        return pick_stream(layout, f"{blow}; stream ({_ms(price)}) < SELL "
                                   f"split ({_ms(sell_price)})")

    vb = torch.empty(0, dtype=dtype).element_size()
    with span("formats.price.ell"):
        ib = np.dtype(config.select_index_dtype(n, m, nnz,
                                                index_dtype)).itemsize
        ell_bytes = (ellsize * vb + 2 * n * vb + index_bytes_estimate(
            expanded.rowidx, expanded.colidx, n, m, rowsize, ib))
    why_ell = None
    if allow_dia and separate_diagonal is False and nnz >= 3 * n:
        dia = dia_from_coo(coo, value_dtype=dtype)    # on the host
        if (dia is not None and dia.diasize <= 2 * nnz
                and dia.num_diags <= MAX_DIAGS):
            with span("formats.price.dia"):
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
    with span("formats.price.stream"):
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
