"""Stream format: SpMV for matrices with no column locality, as products,
then segmented sums.

Counterpart of ``ellspmv_tpu.formats.stream``, with its semantics
(``y := A*x + y``, optional split diagonal, symmetric files expanded) and
its plans:

1. entries are stored sorted by column, and the products ``a_k * x[col_k]``
   are one rowsize-1 ELLPACK SpMV over them (K1, ``ops/ell_cuda.py``);
2. the sum plan (``ops/stream_sum.py``) gathers the products into row-tiled
   runs and sums them level by level, then gathers the row sums into row
   order.

The JAX package reorders the products by destination megablock (or deals
them into uniform cells) so that its TPU router fits its budget; the port's
gather has no budget, so the products stay in column order, which is also
the order that reads x best. The JAX knobs that shape the sum plan are
keyword arguments here, with the JAX defaults: `cap`
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
from ellspmv_tpu_torch.formats.ell import (LBLOCK, EllMatrix,
                                          ell_from_row_major, narrow_bases)
from ellspmv_tpu_torch.ops import ell_cuda
from ellspmv_tpu_torch.ops.permute import BLOCK
from ellspmv_tpu_torch.ops.stream_sum import (StreamSumPlan,
                                              apply_stream_sum,
                                              build_stream_sum)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class StreamMatrix:
    """Column-sorted products (a rowsize-1 ELL over `prod_len` slots) and the
    sum plan. Values are stored and computed in float64 or float32; bfloat16
    values are rounded to bfloat16 and computed in float32, as in the JAX
    package."""

    prod: EllMatrix
    ddsum: StreamSumPlan
    diag: torch.Tensor | None      # (num_rows,) in the compute type
    num_rows: int
    num_columns: int
    num_nonzeros: int
    prod_len: int

    @property
    def values(self) -> torch.Tensor:
        """The stored product values, (1, prod_len), in the compute type."""
        return self.prod.values

    @property
    def worksize(self) -> int:
        """Stored slots (= nnz: the format is padding-free)."""
        return self.num_nonzeros

    @property
    def device(self) -> torch.device:
        return self.prod.device

    def to(self, device) -> "StreamMatrix":
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


def product_columns(sorted_cols: np.ndarray) -> np.ndarray:
    """The products' columns: the entries' columns in sorted order, padded
    to a multiple of BLOCK (at least one BLOCK) with the last column, or 0
    where there is none."""
    nnz = len(sorted_cols)
    pcol = np.full(max(_round_up(nnz, BLOCK), BLOCK),
                   sorted_cols[-1] if nnz else 0, np.int32)
    pcol[:nnz] = sorted_cols
    return pcol


def products_narrow(colidx: np.ndarray, num_columns: int) -> bool:
    """Whether the products' ELL will take the narrow column layout: the
    rule of ``formats/ell.narrow_bases`` over `product_columns`, in blocks
    of `LBLOCK` products, sorted from the column counts alone in
    O(nnz + columns), for the chooser's price."""
    pcol = product_columns(np.repeat(
        np.arange(num_columns, dtype=np.int64),
        np.bincount(colidx, minlength=num_columns)))
    block = np.arange(len(pcol)) // LBLOCK
    return narrow_bases(block, pcol, int(block[-1]) + 1) is not None


def stream_from_coo(coo, separate_diagonal: bool = False, value_dtype=None,
                    cap: int = 128, span_max: int = 196608,
                    n_chunks: int | None = None,
                    device="cpu") -> StreamMatrix:
    """Build the stream format on `device`: sort the entries by column, pad
    the products to a multiple of BLOCK, and build the sum plan (column
    chunks by `num_chunks`). `value_dtype` is a ``--precision`` name or a
    torch type (default: the COO's values' type)."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    nnz_total = coo.num_nonzeros

    diag = None
    if separate_diagonal:
        coo, diag = coo.split_diagonal()
    nnz = coo.num_nonzeros

    dtype = config.value_dtype(coo.values.dtype if value_dtype is None
                               else value_dtype)
    compute = compute_dtype(dtype)
    if m > np.iinfo(np.int32).max:
        raise ValueError("stream format: column count exceeds int32")

    order = np.argsort(coo.colidx, kind="stable")
    cols = coo.colidx[order].astype(np.int32, copy=False)
    prod_len = max(_round_up(nnz, BLOCK), BLOCK)
    dest = np.full(prod_len, -1, np.int64)
    dest[:nnz] = coo.rowidx[order]

    chunks = num_chunks(m, nnz, span_max, n_chunks)
    chunk_starts = None
    if chunks > 1:
        width = -(-m // chunks)
        edges = np.arange(1, chunks, dtype=np.int64) * width
        cs = np.searchsorted(cols, edges).astype(np.int64)
        chunk_starts = np.concatenate([[0], cs, [prod_len]])
    plan = build_stream_sum(dest, n_rows=n, cap=cap,
                            chunk_starts=chunk_starts)

    # the rowsize-1 ELL of the products (narrow columns where they fit);
    # pad slots repeat the last column with value 0; values rounded to the
    # stored type, then held in the compute type
    pcol = product_columns(cols)
    pval = np.zeros(prod_len, np.float64)
    pval[:nnz] = coo.values[order]
    prod = ell_from_row_major(pcol[:, None], pval[:, None], None, prod_len,
                              m, nnz, dtype, device)
    prod.values = prod.values.to(compute)
    if diag is not None:
        d = np.zeros(n, np.float64)
        d[:len(diag)] = diag
        diag = torch.from_numpy(d).to(device).to(dtype).to(compute)
    return StreamMatrix(prod=prod, ddsum=plan.to(device), diag=diag,
                        num_rows=n, num_columns=m, num_nonzeros=nnz_total,
                        prod_len=prod_len)


def stream_spmv(sm: StreamMatrix, x: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
    """y := A*x + y: the products (K1), the sum plan (gathers and K3), the
    split diagonal and y, in the compute type (float32 for bfloat16)."""
    dtype = sm.values.dtype
    x = x.to(dtype)
    out = apply_stream_sum(sm.ddsum, ell_cuda.ell_spmv(sm.prod, x))
    if sm.diag is not None and sm.num_columns > 0:
        xi = torch.arange(sm.num_rows, device=x.device).clamp_(
            max=sm.num_columns - 1)
        out = torch.addcmul(out, sm.diag, x[xi])
    if y is not None:
        out = out + y.to(dtype)
    return out
