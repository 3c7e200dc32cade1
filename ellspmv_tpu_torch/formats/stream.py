"""Stream format: SpMV for matrices with no column locality, as products,
then segmented sums.

Counterpart of ``ellspmv_tpu.formats.stream``, with its semantics
(``y := A*x + y``, optional split diagonal, symmetric files expanded) and
its plans:

1. entries are sorted by column, which sets the sum plan's entry order
   (and its column chunks); the products ``a_k * x[col_k]`` are those of
   a rowsize-1 ELLPACK matrix (in the JAX package, one K1 SpMV over it);
2. the sum plan (``ops/stream_sum.py``) sums the products in row-tiled runs
   level by level, then gathers the row sums into row order.

The JAX package delivers the products to the plan's positions on every
call, through a TPU router (K4, K5) fed by a reorder of the products that
fits its budget. Here the products' values and columns are static, and so
is the plan, so the delivery is done once, on the host: the product ELL is
laid out in level 1's position order (``stream_sum.position_map``), and
level 1's K3 forms each product where it adds it (``stream_sum.Products``):
no product is stored. Alignment-gap slots hold the value 0 and the column
of the slot before them; K3 never reads them. Within each column chunk
K3's reads of x then scatter over the chunk's columns. The JAX
knobs that shape the sum plan are keyword arguments here, with the JAX
defaults: `cap`
(``ELLSPMV_TPU_SUM_CAP``), `span_max` (``ELLSPMV_TPU_STREAM_SPAN``) and
`n_chunks` (``ELLSPMV_TPU_STREAM_CHUNKS``, None for the JAX rule). Its
TPU-only knobs (router, cells, staging, product tiling) have no
counterpart.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.formats import upload
from ellspmv_tpu_torch.formats.ell import (LBLOCK, EllMatrix,
                                          ell_from_row_major, narrow_bases)
from ellspmv_tpu_torch.io import native
from ellspmv_tpu_torch.ops.permute import BLOCK
from ellspmv_tpu_torch.ops.stream_sum import (Products, StreamSumPlan,
                                              apply_stream_sum,
                                              build_stream_sum, position_map)
from ellspmv_tpu_torch.utils.timing import span


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class StreamMatrix:
    """The products (a rowsize-1 ELL over the ``ddsum.in_positions`` slots
    of level 1, in its position order) and the sum plan. `prod_len` is the
    JAX package's count of padded products, the column-sorted entries
    padded to a multiple of BLOCK, over which the plan is built. Values are
    stored and computed in float64 or float32; bfloat16 values are rounded
    to bfloat16 and computed in float32, as in the JAX package."""

    prod: EllMatrix
    ddsum: StreamSumPlan
    diag: torch.Tensor | None      # (num_rows,) in the compute type
    num_rows: int
    num_columns: int
    num_nonzeros: int
    prod_len: int

    @property
    def values(self) -> torch.Tensor:
        """The stored product values, (1, ddsum.in_positions), in the
        compute type."""
        return self.prod.values

    @property
    def worksize(self) -> int:
        """Stored slots (= nnz: the format is padding-free)."""
        return self.num_nonzeros

    @property
    def device(self) -> torch.device:
        return self.prod.device

    def to(self, device) -> "StreamMatrix":
        with upload(device, "stream", self):
            return dataclasses.replace(
                self, prod=self.prod.to(device), ddsum=self.ddsum.to(device),
                diag=None if self.diag is None else self.diag.to(device))


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """The type the stream format stores and computes `dtype` values in:
    float32 for bfloat16 (whose values it rounds to bfloat16 first)."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def num_chunks(num_columns: int, nnz: int, span_max: int = 196608,
               n_chunks: int | None = None) -> int:
    """Column chunks of level 1 (``formats/stream.py:153-161`` of the JAX
    package): one per `span_max` columns, at most one per 32 BLOCKs of
    entries; a given `n_chunks` is taken, within [1, num_columns]."""
    if n_chunks is not None:
        return max(1, min(int(n_chunks), max(num_columns, 1)))
    chunks = max(1, -(-num_columns // span_max))
    return min(chunks, max(1, -(-nnz // (32 * BLOCK))))


def products_len(nnz: int) -> int:
    """The JAX package's count of padded products (its `prod_len`): `nnz`
    rounded up to a multiple of BLOCK, at least one BLOCK."""
    return max(_round_up(nnz, BLOCK), BLOCK)


def _entries(coo, separate_diagonal: bool):
    """The matrix's entries as the products take them: symmetry expanded,
    the diagonal split off when asked (`diag`, else None), and their
    column order (a stable argsort of the columns, native where the host
    library is available)."""
    coo = coo.expand_symmetry()
    diag = None
    if separate_diagonal:
        coo, diag = coo.split_diagonal()
    return coo, diag, native.argsort(coo.colidx)


def column_order_products(coo, separate_diagonal: bool = False,
                          value_dtype=None, device="cpu") -> EllMatrix:
    """The products in the JAX package's layout, the entries sorted by
    column over `products_len` slots (pad slots: the value 0 and the last
    column), as a rowsize-1 ELL on `device` in the compute type. The
    shipped format lays them out in position order instead; this one is the
    yardstick that the tests and ``scripts/kernel_variants.py`` gather into
    position order."""
    coo, _, order = _entries(coo, separate_diagonal)
    nnz = coo.num_nonzeros
    pcol = np.full(products_len(nnz), coo.colidx[order][-1] if nnz else 0,
                   np.int32)
    pcol[:nnz] = coo.colidx[order]
    pval = np.zeros(len(pcol))
    pval[:nnz] = coo.values[order]
    dtype = config.value_dtype(coo.values.dtype if value_dtype is None
                               else value_dtype)
    ell = ell_from_row_major(pcol[:, None], pval[:, None], None, len(pcol),
                             coo.num_columns, nnz, dtype, device)
    ell.values = ell.values.to(compute_dtype(dtype))
    return ell


def position_order(src: np.ndarray, cols: np.ndarray,
                   vals: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The products' columns (int32) and values laid out by `src`, level 1's
    `position_map` over the entries `cols` and `vals`: slot p holds entry
    ``src[p]``; a slot with no entry (-1) holds the value 0 and the column
    of the nearest slot before it that has one (of the first such slot
    where none comes before; column 0 where there is none), so that it
    widens no block's column span."""
    real = src >= 0
    if not real.any():
        return np.zeros(len(src), np.int32), np.zeros(len(src), vals.dtype)
    slot = np.maximum.accumulate(np.where(real, np.arange(len(src)), -1))
    slot = np.where(slot >= 0, slot, np.argmax(real))
    pcol = cols[src[slot]].astype(np.int32)
    pval = np.where(real, vals[np.maximum(src, 0)], 0).astype(vals.dtype)
    return pcol, pval


@dataclasses.dataclass
class StreamLayout:
    """The stream format on the host before its values are typed: the sum
    plan over the column-sorted entries, and the products' columns and
    values (float64) in level 1's position order. `diag` is the split
    diagonal (None unless split), `source_dtype` the COO values' type."""

    plan: StreamSumPlan
    pcol: np.ndarray
    pval: np.ndarray
    diag: np.ndarray | None
    num_rows: int
    num_columns: int
    num_nonzeros: int        # with the split diagonal
    num_products: int        # without it
    prod_len: int
    source_dtype: np.dtype

    def products_narrow(self) -> bool:
        """Whether the products' ELL takes the narrow column layout:
        `narrow_bases` over each block of LBLOCK slots' least and greatest
        column, as ``formats/ell.narrow_columns`` applies it to a built
        ELL."""
        blocks = -(-len(self.pcol) // LBLOCK)
        cols = np.pad(self.pcol, (0, blocks * LBLOCK - len(self.pcol)),
                      mode="edge").reshape(blocks, LBLOCK)
        index = np.arange(blocks)
        return narrow_bases(np.concatenate([index, index]),
                            np.concatenate([cols.min(axis=1),
                                            cols.max(axis=1)]
                                           ).astype(np.int64),
                            blocks) is not None


def stream_layout(coo, separate_diagonal: bool = False, cap: int = 128,
                  span_max: int = 196608,
                  n_chunks: int | None = None) -> StreamLayout:
    """Sort the entries by column, pad them to `products_len`, build the
    sum plan over them (column chunks by `num_chunks`), and lay the
    products out in level 1's position order, on the host."""
    with span("formats.build.stream"):
        coo = coo.expand_symmetry()
        nnz_total = coo.num_nonzeros
        with span("stream.argsort"):
            coo, diag, order = _entries(coo, separate_diagonal)
        n, m = coo.num_rows, coo.num_columns
        nnz = coo.num_nonzeros
        if m > np.iinfo(np.int32).max:
            raise ValueError("stream format: column count exceeds int32")

        cols = coo.colidx[order].astype(np.int32, copy=False)
        prod_len = products_len(nnz)
        dest = np.full(prod_len, -1, np.int64)
        dest[:nnz] = coo.rowidx[order]

        with span("stream.sum_plan"):
            chunks = num_chunks(m, nnz, span_max, n_chunks)
            chunk_starts = None
            if chunks > 1:
                width = -(-m // chunks)
                edges = np.arange(1, chunks, dtype=np.int64) * width
                cs = np.searchsorted(cols, edges).astype(np.int64)
                chunk_starts = np.concatenate([[0], cs, [prod_len]])
            plan = build_stream_sum(dest, n_rows=n, cap=cap,
                                    chunk_starts=chunk_starts)
        with span("stream.position_order"):
            pcol, pval = position_order(position_map(plan.levels[0]), cols,
                                        coo.values[order].astype(np.float64))
    return StreamLayout(plan=plan, pcol=pcol, pval=pval, diag=diag,
                        num_rows=n, num_columns=m, num_nonzeros=nnz_total,
                        num_products=nnz, prod_len=prod_len,
                        source_dtype=coo.values.dtype)


def stream_from_layout(layout: StreamLayout, value_dtype=None,
                       device="cpu") -> StreamMatrix:
    """The stream format of `layout` on `device`: the products' rowsize-1
    ELL (narrow columns where they fit), values rounded to the stored type
    and held in the compute type. `value_dtype` is a ``--precision`` name
    or a torch type (default: the COO's values' type)."""
    dtype = config.value_dtype(layout.source_dtype if value_dtype is None
                               else value_dtype)
    compute = compute_dtype(dtype)
    n, plan = layout.num_rows, layout.plan
    prod = ell_from_row_major(layout.pcol[:, None], layout.pval[:, None],
                              None, plan.in_positions, layout.num_columns,
                              layout.num_products, dtype, device, "stream")
    d = None
    if layout.diag is not None:
        with span("formats.build.stream"):
            d = np.zeros(n, np.float64)
            d[:len(layout.diag)] = layout.diag
    with upload(device, "stream", plan, d):
        prod.values = prod.values.to(compute)
        diag = (None if d is None
                else torch.from_numpy(d).to(device).to(dtype).to(compute))
        return StreamMatrix(prod=prod, ddsum=plan.to(device), diag=diag,
                            num_rows=n, num_columns=layout.num_columns,
                            num_nonzeros=layout.num_nonzeros,
                            prod_len=layout.prod_len)


def stream_from_coo(coo, separate_diagonal: bool = False, value_dtype=None,
                    cap: int = 128, span_max: int = 196608,
                    n_chunks: int | None = None,
                    device="cpu") -> StreamMatrix:
    """Build the stream format on `device`: `stream_layout`, then
    `stream_from_layout`."""
    return stream_from_layout(
        stream_layout(coo, separate_diagonal, cap, span_max, n_chunks),
        value_dtype, device)


def stream_spmv(sm: StreamMatrix, x: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
    """y := A*x + y: the sum plan over the products (K3 per level, level 1
    forming each product from its value and gathered x, then one gather),
    the split diagonal and y, in the compute type (float32 for
    bfloat16)."""
    dtype = sm.values.dtype
    x = x.to(dtype)
    out = apply_stream_sum(sm.ddsum, Products(sm.prod, x))
    if sm.diag is not None and sm.num_columns > 0:
        xi = torch.arange(sm.num_rows, device=x.device).clamp_(
            max=sm.num_columns - 1)
        out = torch.addcmul(out, sm.diag, x[xi])
    if y is not None:
        out = out + y.to(dtype)
    return out
