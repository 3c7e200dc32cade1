"""Hub-column hybrid, for power-law matrices: the counterpart of
``ellspmv_tpu.formats.hybrid``.

A power-law matrix's column degrees are power-law too: a few thousand hub
columns carry most of the nonzeros. The split:

- the top-H columns by degree become a compact id space [0, H), in
  descending degree; their entries form a SELL matrix (``formats/sell.py``)
  over ``x_hub = x[hub_cols]``, one gather per SpMV;
- the remaining entries form a second SELL matrix over all of x.

The hub is left out where it would carry under `min_hub_fraction` of the
nonzeros, where it would hold every column, and on an empty matrix. The
host packing is the JAX package's step for step, so every field equals its
counterpart on the same COO. `hybrid_spmv` runs the JAX order: the gather
of x into the hub's id space (``ops/permute.apply_permute``, the port's
gather kernel, with `hub_cols` as its map), SELL on the hub, then SELL on
the rest with the hub's result as its y, then y. Both SELL parts run K1
per bucket on a card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.sell import SellMatrix
from ellspmv_tpu_torch.formats.sell import kernel_launches as sell_launches
from ellspmv_tpu_torch.formats.sell import sell_from_coo, sell_spmv
from ellspmv_tpu_torch.ops import permute


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class HybridMatrix:
    """`hub` is over the compact hub id space and `hub_cols` (int32, on the
    matrix's device) gives each hub id's original column, by descending
    degree; both are None where the hub was left out."""

    hub: SellMatrix | None
    hub_cols: torch.Tensor | None
    rest: SellMatrix
    num_rows: int
    num_columns: int
    num_nonzeros: int

    @property
    def hub_nnz_fraction(self) -> float:
        """The hub's share of the stored slots (padding included)."""
        if self.hub is None:
            return 0.0
        hub_work = self.hub.sellsize + self.hub.tailsize
        rest_work = self.rest.sellsize + self.rest.tailsize
        return hub_work / max(hub_work + rest_work, 1)

    @property
    def values(self) -> torch.Tensor:
        return self.rest.values

    @property
    def device(self) -> torch.device:
        return self.rest.device

    def to(self, device) -> "HybridMatrix":
        return dataclasses.replace(
            self, hub=None if self.hub is None else self.hub.to(device),
            hub_cols=(None if self.hub_cols is None
                      else self.hub_cols.to(device)),
            rest=self.rest.to(device))


def hybrid_from_coo(coo: CooMatrix, hub_width: int | None = None,
                    min_hub_fraction: float = 0.15,
                    slice_rows: int = 1024, tail_cap: int = 2048,
                    length_sort: bool = True, sort_rows: bool = True,
                    value_dtype=None, index_dtype=None,
                    device="cpu") -> HybridMatrix:
    """Split off the top-`hub_width` columns by degree (by default
    ``min(65536, round_up(max(m // 16, 128), 128))``) into their own SELL
    matrix, on `device` (``ellspmv_tpu.formats.hybrid.hybrid_from_coo``,
    its arguments and defaults)."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    nnz = coo.num_nonzeros
    sell_kw = dict(slice_rows=slice_rows, tail_cap=tail_cap,
                   length_sort=length_sort, sort_rows=sort_rows,
                   value_dtype=value_dtype, index_dtype=index_dtype,
                   device=device)

    deg = np.bincount(coo.colidx, minlength=m)
    if hub_width is None:
        hub_width = int(min(65536, _round_up(max(m // 16, 128), 128)))
    H = min(hub_width, _round_up(m, 128))
    order = np.argsort(deg)[::-1][:H]
    hub_mass = int(deg[order].sum())
    if nnz == 0 or hub_mass < min_hub_fraction * nnz or H >= m:
        return HybridMatrix(None, None, sell_from_coo(coo, **sell_kw), n, m,
                            nnz)

    local = np.full(m, -1, np.int64)
    local[order] = np.arange(H)
    loc = local[coo.colidx]
    in_hub = loc >= 0
    hub_coo = CooMatrix(n, H, coo.rowidx[in_hub],
                        loc[in_hub].astype(coo.colidx.dtype),
                        coo.values[in_hub])
    rest_coo = CooMatrix(n, m, coo.rowidx[~in_hub], coo.colidx[~in_hub],
                         coo.values[~in_hub])
    return HybridMatrix(
        hub=sell_from_coo(hub_coo, **sell_kw),
        hub_cols=torch.from_numpy(order.astype(np.int32)).to(device),
        rest=sell_from_coo(rest_coo, **sell_kw),
        num_rows=n, num_columns=m, num_nonzeros=nnz)


def kernel_launches(hm: HybridMatrix) -> dict:
    """The launches of one `hybrid_spmv` on `hm`: K1 once per bucket of
    both parts (``ell_spmv``), and the hub's gather (``permute``)."""
    hub = 0 if hm.hub is None else sell_launches(hm.hub)
    return {"ell_spmv": hub + sell_launches(hm.rest),
            "permute": int(hm.hub is not None)}


def hybrid_spmv(hm: HybridMatrix, x: torch.Tensor,
                y: torch.Tensor | None = None,
                backend: str = "auto") -> torch.Tensor:
    """y := A*x + y in the values' type: x gathered into the hub's id space
    (in x's own type, before the SELL parts cast it), SELL on the hub, SELL
    on the rest with the hub's result as y, then y. `backend` reaches the
    SELL parts' buckets (``sell_spmv``)."""
    out = None
    if hm.hub is not None:
        x_hub = permute.apply_permute(hm.hub_cols, x)
        out = sell_spmv(hm.hub, x_hub, None, backend=backend)
    out = sell_spmv(hm.rest, x, out, backend=backend)
    return out if y is None else out + y.to(out.dtype)
