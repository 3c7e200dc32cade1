"""ELLPACK format: (max-nnz-per-row × rows) column-index/value arrays.

Host packing has the semantics of ``ellspmv_tpu.formats.ell.ell_from_coo``
(and of the reference's ell_from_coo, ellspmv.c:931-958, 1081-1127, without
its swapped-argument call-site bug, SURVEY §2.1 E12):

- ``rowsize`` = max nonzeros per row (excluding the diagonal when split);
- padding slots get column ``min(i, num_columns-1)`` and value 0
  (ellspmv.c:1111-1117), so padded gathers stay in bounds;
- duplicate (row, col) entries occupy their own slots;
- the split diagonal accumulates duplicates (ellspmv.c:1100);
- ``sort_rows`` orders each row's entries by column;
- symmetric files are expanded;
- rows are padded to a multiple of `row_tile` (8 by default; a SELL
  bucket's slice of 1024), and ``rowsize`` may be forced wider than the
  longest row (a SELL bucket's power-of-two width).

The arrays are stored slot-major, ``(rowsize, padded_rows)``: slot ``s`` of
consecutive rows is contiguous, so a warp that handles 32 consecutive rows
reads each slot with one coalesced load. The host packs row-major, as the JAX
package does, and the transpose runs on the target device.

The narrow column layout (`narrow_columns`), the counterpart of the JAX
plan's per-tile window base and int16 local columns
(``ellspmv_tpu/ops/plan.py:393-414``): where every block of `LBLOCK` rows
spans fewer than `NARROW_SPAN` columns, padding slots included, the matrix
also carries each block's least column (`lbase`, in the index type) and
each slot's column as a 16-bit offset from it (`lcol`, slot-major like
`colidx`), and the kernel reads those: 2 bytes a slot instead of 4 or 8.
Every constructor builds it with `narrow_columns` (`ell_from_coo` in its
own build span, `ell_from_row_major` for `ell_from_jax_arrays` and the
stream format's products). The rule is
written once, in `narrow_bases`: `narrow_columns` applies it to the built
rows, `narrow_columns_fit` to COO triplets (for the chooser's ELL price),
`narrow_rows_fit` to rows' counts and extremes (for the SELL price) and
``formats/stream.StreamLayout.products_narrow`` to the stream format's
products laid out on the host (for its price). The kernel's library
reports its own `LBLOCK` and `NARROW_SPAN`, and the wrapper checks them
against these.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.formats import upload
from ellspmv_tpu_torch.io import native
from ellspmv_tpu_torch.utils.timing import span


# Rows are padded to a multiple of this (as in the JAX package).
ROW_TILE = 8
#: Rows per block of the narrow column layout (one `lbase` entry each).
LBLOCK = 256
#: The narrow layout holds where every block's column span is below this.
NARROW_SPAN = 1 << 16


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class EllMatrix:
    """ELLPACK matrix. `colidx`/`values` are (rowsize, padded_rows); `diag`
    is (padded_rows,) when the diagonal is split, else None. In the narrow
    layout `lbase` is (ceil(padded_rows / LBLOCK),) in colidx's type and
    `lcol` (rowsize, padded_rows) int16 holding the uint16 offsets
    ``colidx - lbase[row // LBLOCK]``; both None otherwise."""

    colidx: torch.Tensor
    values: torch.Tensor
    diag: torch.Tensor | None
    num_rows: int
    num_columns: int
    num_nonzeros: int
    lbase: torch.Tensor | None = None
    lcol: torch.Tensor | None = None

    @property
    def rowsize(self) -> int:
        return int(self.values.shape[0])

    @property
    def padded_rows(self) -> int:
        return int(self.values.shape[1])

    @property
    def ellsize(self) -> int:
        """num_rows*rowsize, the reference's flop/byte accounting unit
        (ellspmv.c:955, 1857)."""
        return self.num_rows * self.rowsize

    @property
    def diagsize(self) -> int:
        """min(rows, cols), counted unconditionally in the reference's flops
        formula (ellspmv.c:956, 1857)."""
        return min(self.num_rows, self.num_columns)

    @property
    def device(self) -> torch.device:
        return self.values.device

    @property
    def index_bytes(self) -> int:
        """Bytes of column indices the kernel reads per SpMV: `lcol` and
        `lbase` in the narrow layout, else `colidx`."""
        if self.lcol is None:
            return self.colidx.numel() * self.colidx.element_size()
        return 2 * self.lcol.numel() \
            + self.lbase.numel() * self.lbase.element_size()

    def columns(self) -> torch.Tensor:
        """The (rowsize, padded_rows) columns the kernel reads: decoded from
        the narrow layout (``lbase[row // LBLOCK] + lcol``) where the matrix
        has it, else `colidx`."""
        if self.lcol is None:
            return self.colidx
        base = self.lbase.repeat_interleave(LBLOCK)[:self.padded_rows]
        return base[None, :] + (self.lcol.to(base.dtype) & 0xFFFF)

    def to(self, device) -> "EllMatrix":
        def move(t):
            return None if t is None else t.to(device)
        with upload(device, "ell", self):
            return EllMatrix(move(self.colidx), move(self.values),
                             move(self.diag), self.num_rows,
                             self.num_columns, self.num_nonzeros,
                             move(self.lbase), move(self.lcol))


def narrow_bases(block: np.ndarray, cols: np.ndarray,
                 num_blocks: int) -> np.ndarray | None:
    """The narrow layout's rule, the one place it is written. Given slots
    by their block (row // `LBLOCK`) and column, every one of the
    `num_blocks` blocks holding at least one: each block's least column
    (int64) where every block spans fewer than `NARROW_SPAN` columns, else
    None; None too where there are no slots."""
    if len(cols) == 0:
        return None
    lo = np.full(num_blocks, np.iinfo(np.int64).max, np.int64)
    hi = np.full(num_blocks, -1, np.int64)
    np.minimum.at(lo, block, cols)
    np.maximum.at(hi, block, cols)
    return lo if int((hi - lo).max()) < NARROW_SPAN else None


def narrow_columns(colidx: np.ndarray):
    """The narrow layout of row-major host columns ``(padded_rows,
    rowsize)``: ``(lbase, lcol)``, each block's least column (in colidx's
    type) and the row-major offsets from it as uint16 bits in an int16
    array; None where `narrow_bases` says no. Each row's least and
    greatest column stand for its slots."""
    p, s = colidx.shape
    if p == 0 or s == 0:
        return None
    block = np.arange(p) // LBLOCK
    lo = narrow_bases(np.concatenate([block, block]),
                      np.concatenate([colidx.min(axis=1), colidx.max(axis=1)]
                                     ).astype(np.int64), -(-p // LBLOCK))
    if lo is None:
        return None
    lbase = lo.astype(colidx.dtype)
    lcol = colidx - lbase[block][:, None]
    return lbase, lcol.astype(np.uint16).view(np.int16)


def narrow_columns_fit(rowidx: np.ndarray, colidx: np.ndarray,
                       num_rows: int, num_columns: int,
                       rowsize: int) -> bool:
    """`narrow_columns`'s answer from COO triplets alone, in O(nnz + rows):
    `narrow_bases` over the entries of their ELLPACK and, in every row with
    fewer than `rowsize` entries (the padding rows included), its padding
    column ``min(i, num_columns - 1)``."""
    if rowsize == 0:
        return False
    n_pad = max(_round_up(num_rows, ROW_TILE), ROW_TILE)
    padded = np.flatnonzero(np.bincount(rowidx, minlength=n_pad) < rowsize)
    rows = np.concatenate([np.asarray(rowidx, np.int64), padded])
    cols = np.concatenate([np.asarray(colidx, np.int64),
                           np.minimum(padded, max(num_columns - 1, 0))])
    return narrow_bases(rows // LBLOCK, cols,
                        -(-n_pad // LBLOCK)) is not None


def narrow_rows_fit(counts: np.ndarray, lo: np.ndarray, hi: np.ndarray,
                    rowsize: int, num_columns: int) -> bool:
    """`narrow_columns`'s answer for rows ``0..len(counts)`` of `rowsize`
    slots from each row's entry count and least and greatest column (`lo`,
    `hi`, read where the count is not 0): `narrow_bases` over those and,
    in every row with fewer than `rowsize` entries, its padding column
    ``min(i, num_columns - 1)``."""
    p = len(counts)
    if p == 0 or rowsize == 0:
        return False
    i = np.arange(p)
    full, padded = counts > 0, counts < rowsize
    block = i // LBLOCK
    return narrow_bases(
        np.concatenate([block[full], block[full], block[padded]]),
        np.concatenate([lo[full], hi[full],
                        np.minimum(i[padded], max(num_columns - 1, 0))]),
        -(-p // LBLOCK)) is not None


def index_bytes_estimate(num_rows: int, rowsize: int, index_size: int,
                         narrow: bool) -> int:
    """Bytes of column indices K1 will read on an ELLPACK of `num_rows`
    rows (not padded) and `rowsize` slots: 2 per slot and one
    `index_size` base per block where it is `narrow` (as
    `narrow_columns_fit` answers), else `index_size` per slot."""
    slots = num_rows * rowsize
    if narrow:
        return 2 * slots + -(-num_rows // LBLOCK) * index_size
    return index_size * slots


def ell_from_row_major(colidx: np.ndarray, values: np.ndarray,
                       diag: np.ndarray | None, num_rows: int,
                       num_columns: int, num_nonzeros: int,
                       dtype: torch.dtype, device,
                       fmt: str = "ell") -> EllMatrix:
    """Move row-major host arrays to `device`, transpose them to slot-major
    there, cast the values to `dtype`, and add the narrow column layout
    where it holds. The layout is found on the host in the span of the
    build of format `fmt`, which the arrays are part of."""
    with span(f"formats.build.{fmt}"):
        narrow = narrow_columns(colidx)
    return _on_device(colidx, values, diag, num_rows, num_columns,
                      num_nonzeros, dtype, device, fmt, narrow)


def _on_device(colidx, values, diag, num_rows, num_columns, num_nonzeros,
               dtype, device, fmt, narrow) -> EllMatrix:
    """`ell_from_row_major`'s copy to `device`, with the narrow layout
    `narrow_columns` found (or None)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with upload(device, fmt, colidx, values, diag, narrow):
        lbase = lcol = None
        if narrow is not None:
            lbase, lcol = put(narrow[0]), put(narrow[1]).t().contiguous()
        return EllMatrix(put(colidx).t().contiguous(),
                         put(values).t().contiguous().to(dtype),
                         None if diag is None else put(diag).to(dtype),
                         num_rows, num_columns, num_nonzeros, lbase, lcol)


def ell_from_coo(coo, separate_diagonal: bool = False,
                 sort_rows: bool = False, value_dtype=None,
                 index_dtype=None, device="cpu", row_tile: int = ROW_TILE,
                 rowsize: int | None = None) -> EllMatrix:
    """Convert a CooMatrix to ELLPACK on `device`.

    `value_dtype` is a ``--precision`` name or a torch type (default: the
    COO's values' type); `index_dtype` is int32, int64 or None for auto.
    Rows are padded to a multiple of `row_tile`, which must be a multiple
    of `ROW_TILE` (K1 reads rows in pairs, with 16-byte loads). `rowsize`
    may be forced larger than the longest row (the SELL buckets' widths);
    a smaller one raises ValueError.
    """
    if row_tile <= 0 or row_tile % ROW_TILE:
        raise ValueError(f"row_tile {row_tile} is not a positive multiple "
                         f"of {ROW_TILE}")
    with span("formats.build.ell") as build:
        coo = coo.expand_symmetry()
        n, m = coo.num_rows, coo.num_columns
        nnz_total = coo.num_nonzeros

        diag = None
        if separate_diagonal:
            coo, diag = coo.split_diagonal()

        counts = (np.bincount(coo.rowidx, minlength=n) if n
                  else np.zeros(0, int))
        natural_rowsize = int(counts.max()) if n and counts.size else 0
        if rowsize is None:
            rowsize = natural_rowsize
        elif rowsize < natural_rowsize:
            raise ValueError(f"requested rowsize {rowsize} < max row "
                             f"occupancy {natural_rowsize}")

        idx_dt = config.select_index_dtype(n, m, max(nnz_total, 1),
                                           index_dtype)
        dtype = config.value_dtype(coo.values.dtype if value_dtype is None
                                   else value_dtype)
        # bf16 has no numpy type: pack in float64, round on the device
        host_dt = (np.dtype(np.float64) if dtype == torch.bfloat16
                   else torch.empty(0, dtype=dtype).numpy().dtype)

        n_pad = max(_round_up(n, row_tile), row_tile)
        colidx = values = None
        if coo.num_nonzeros and rowsize and idx_dt == np.dtype(np.int32):
            # the native counting-sort packer, where the host library is
            # available (the reference packs in parallel C,
            # ellspmv.c:1081-1127)
            if native.available():
                colidx, values = native.ell_pack(n, m, n_pad, rowsize,
                                                 coo.rowidx, coo.colidx,
                                                 coo.values, sort_rows)
                values = values.astype(host_dt, copy=False)
        if colidx is None:
            # allocated only here: the native packer returns its own arrays
            pad_col = np.minimum(np.arange(n_pad, dtype=idx_dt),
                                 max(m - 1, 0)).astype(idx_dt)
            colidx = np.broadcast_to(pad_col[:, None], (n_pad, rowsize)).copy()
            values = np.zeros((n_pad, rowsize), host_dt)
            if coo.num_nonzeros and rowsize:
                # One sort by (row [, col]) gives each entry its slot: the
                # reference's per-row fill cursor (ellspmv.c:1097-1107) and
                # rowsort.
                if sort_rows:
                    order = np.lexsort((coo.colidx, coo.rowidx))
                else:
                    order = np.argsort(coo.rowidx, kind="stable")
                r = coo.rowidx[order]
                rowptr = np.zeros(n + 1, dtype=np.int64)
                rowptr[1:] = np.cumsum(counts)
                slot = np.arange(len(r), dtype=np.int64) - rowptr[r]
                colidx[r, slot] = coo.colidx[order].astype(idx_dt)
                values[r, slot] = coo.values[order].astype(host_dt)

        if diag is not None:
            d = np.zeros(n_pad, host_dt)
            d[:len(diag)] = diag.astype(host_dt)
            diag = d
        narrow = narrow_columns(colidx)
        build.set(rowsize=rowsize, slots=n * rowsize, nonzeros=nnz_total,
                  narrow=narrow is not None)

    return _on_device(colidx, values, diag, n, m, nnz_total, dtype, device,
                      "ell", narrow)


def ell_from_jax_arrays(colidx, values, diag, num_rows: int,
                        num_columns: int, num_nonzeros: int,
                        device="cpu") -> EllMatrix:
    """Build the port's EllMatrix from the host arrays of an
    ``ellspmv_tpu.formats.ell.EllMatrix`` (row-major ``(padded_rows,
    rowsize)`` colidx/values and the padded diagonal), so that both packages
    compute on identical data. bfloat16 values (an ``ml_dtypes`` array) are
    widened to float32 on the host, which is exact, and narrowed back on the
    device."""
    values = np.asarray(values)
    if values.dtype.name == "bfloat16":
        dtype = torch.bfloat16
        values = values.astype(np.float32)
        diag = None if diag is None else np.asarray(diag).astype(np.float32)
    else:
        dtype = config.value_dtype(values.dtype)
    return ell_from_row_major(np.asarray(colidx), values,
                              None if diag is None else np.asarray(diag),
                              int(num_rows), int(num_columns),
                              int(num_nonzeros), dtype, device)
