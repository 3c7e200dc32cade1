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

The sliced layout (`EllSlices`), which K1 reads on a card: padding every
row to the longest row of the whole matrix stores 2-3x the nonzeros where
rows differ in length. `ell_from_coo` keeps packing on the host as above;
where the whole matrix (rows padded to `ROW_TILE`, as wide as its longest
row) goes to a card and `slice_plan` stores fewer slots, the padded arrays
are laid out again there: within each window of `SLICE_WINDOW` rows the
rows are put in a stable order by entry count, longest first, and each
slice of `SLICE_ROWS` consecutive rows in that order stores only as many
slots as its own longest row, slot-major, at its own offset in one flat
array of values and one of columns. A row keeps its entries at the same
slot numbers in the same order; only trailing padding slots go. The narrow
layout is found again on the slices as they lie (`lbase` per `LBLOCK`
positions), and the padded arrays are not kept on the card. A SELL bucket, which forces
its rows' tile and width, the stream format's products and the shards
(`ell_from_row_major`) keep the padded layout.
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
#: Rows per slice of the sliced layout.
SLICE_ROWS = 32
#: Rows per window of the sliced layout, within which rows are reordered.
SLICE_WINDOW = 512


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class EllSlices:
    """The slice table of an ELLPACK in the sliced layout. Position ``i``
    (``i < padded_rows``) lies in slice ``i // SLICE_ROWS`` and holds row
    ``i // SLICE_WINDOW * SLICE_WINDOW + rows[i]``; slot ``s`` of it lies
    at ``start[slice] + s * SLICE_ROWS + i % SLICE_ROWS`` of the matrix's
    flat arrays, for ``s < width[slice]``. `width` is int32 and `start`
    int64, one each a slice; `rows` int16, one a position. `stored` is the
    flat arrays' length, and `rowsize` the padded layout's width."""

    width: torch.Tensor
    start: torch.Tensor
    rows: torch.Tensor
    rowsize: int
    padded_rows: int
    stored: int

    def to(self, device) -> "EllSlices":
        return dataclasses.replace(self, width=self.width.to(device),
                                   start=self.start.to(device),
                                   rows=self.rows.to(device))

    def row_of_position(self) -> torch.Tensor:
        """Each position's row (int64)."""
        i = torch.arange(self.padded_rows, device=self.rows.device)
        return i // SLICE_WINDOW * SLICE_WINDOW + self.rows.long()

    def at_slot(self, s: int):
        """``(dest, live)`` for slot `s` of every position: the element of
        the flat arrays that holds it (clamped into them) and whether the
        position's slice is at least ``s + 1`` wide. It reads nothing back
        to the host, so a CUDA graph can capture it."""
        pos = torch.arange(self.padded_rows, device=self.width.device)
        j = pos // SLICE_ROWS
        dest = self.start[j] + s * SLICE_ROWS + pos % SLICE_ROWS
        return dest.clamp_(max=max(self.stored - 1, 0)), self.width[j] > s

    def slots(self):
        """For each slot number ``s``: ``(s, dest, pos)``, the elements of
        the flat arrays that hold slot ``s`` of every slice at least
        ``s + 1`` wide, and their positions (int64, on the table's
        device)."""
        for s in range(int(self.width.max()) if len(self.width) else 0):
            dest, live = self.at_slot(s)
            pos = torch.nonzero(live).squeeze(1)
            yield s, dest[pos], pos


@dataclasses.dataclass
class EllMatrix:
    """ELLPACK matrix. `colidx`/`values` are (rowsize, padded_rows); `diag`
    is (padded_rows,) when the diagonal is split, else None. In the narrow
    layout `lbase` is (ceil(padded_rows / LBLOCK),) in colidx's type and
    `lcol` (rowsize, padded_rows) int16 holding the uint16 offsets
    ``colidx - lbase[row // LBLOCK]``; both None otherwise.

    In the sliced layout (`slices` not None) `colidx`, `values` and `lcol`
    are flat, ``(slices.stored,)``, each slot where `slices` puts it, and
    `lbase` is per `LBLOCK` positions; `diag` stays by row."""

    colidx: torch.Tensor
    values: torch.Tensor
    diag: torch.Tensor | None
    num_rows: int
    num_columns: int
    num_nonzeros: int
    lbase: torch.Tensor | None = None
    lcol: torch.Tensor | None = None
    slices: EllSlices | None = None

    @property
    def rowsize(self) -> int:
        if self.slices is not None:
            return self.slices.rowsize
        return int(self.values.shape[0])

    @property
    def padded_rows(self) -> int:
        if self.slices is not None:
            return self.slices.padded_rows
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
        has it, else `colidx`; the padded layout's where the matrix is
        sliced."""
        if self.slices is not None:
            return self.padded().colidx
        if self.lcol is None:
            return self.colidx
        base = self.lbase.repeat_interleave(LBLOCK)[:self.padded_rows]
        return base[None, :] + (self.lcol.to(base.dtype) & 0xFFFF)

    def padded(self) -> "EllMatrix":
        """The matrix in the padded layout: itself, or its slices laid back
        into (rowsize, padded_rows) arrays of the columns the kernel reads,
        each slot past its slice's width the padding (column ``min(i,
        num_columns - 1)``, value 0). No narrow layout. It reads nothing
        back to the host, so a CUDA graph can capture it (the plain
        version's CG)."""
        sl = self.slices
        if sl is None:
            return self
        shape, device = (sl.rowsize, sl.padded_rows), self.device
        pos = torch.arange(sl.padded_rows, device=device)
        row = sl.row_of_position()
        pad = row.clamp(max=max(self.num_columns - 1, 0))
        colidx = torch.empty(shape, dtype=self.colidx.dtype, device=device)
        values = torch.empty(shape, dtype=self.values.dtype, device=device)
        for s in range(sl.rowsize):
            dest, live = sl.at_slot(s)
            if self.lcol is None:
                cols = self.colidx[dest]
            else:
                cols = self.lbase[pos // LBLOCK] \
                    + (self.lcol[dest].to(self.lbase.dtype) & 0xFFFF)
            colidx[s, row] = torch.where(live, cols, pad).to(colidx.dtype)
            values[s, row] = torch.where(live, self.values[dest],
                                         self.values.new_zeros(()))
        return EllMatrix(colidx, values, self.diag, self.num_rows,
                         self.num_columns, self.num_nonzeros)

    def to(self, device) -> "EllMatrix":
        def move(t):
            return None if t is None else t.to(device)
        with upload(device, "ell", self):
            return EllMatrix(move(self.colidx), move(self.values),
                             move(self.diag), self.num_rows,
                             self.num_columns, self.num_nonzeros,
                             move(self.lbase), move(self.lcol),
                             move(self.slices))


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


def slice_plan(counts: np.ndarray, padded_rows: int):
    """The sliced layout of `padded_rows` rows whose first ``len(counts)``
    hold these entry counts and the rest none: within each window of
    `SLICE_WINDOW` rows, the rows in a stable order by count, longest first;
    each slice of `SLICE_ROWS` consecutive positions of that order as wide
    as its first row. ``(rows, width, start)``: each position's row within
    its window (int16), each slice's width (int32) and its first element in
    the flat arrays (int64), where a slice stores width × `SLICE_ROWS`
    slots."""
    w = SLICE_WINDOW
    windows = -(-padded_rows // w)
    c = np.zeros(windows * w, np.int64)
    c[:len(counts)] = counts
    longest = int(c.max()) if len(c) else 0
    # a stable sort of the count's complement; its narrowest type sorts
    # by radix
    key = (longest - c).astype(np.min_scalar_type(longest))
    order = np.argsort(key.reshape(windows, w), axis=1, kind="stable")
    first = (np.arange(windows)[:, None] * w + order).ravel()
    width = c[first[:padded_rows:SLICE_ROWS]].astype(np.int32)
    size = width.astype(np.int64) * SLICE_ROWS
    return (order.ravel()[:padded_rows].astype(np.int16), width,
            np.cumsum(size) - size)


def sliced_slots(plan) -> int:
    """The slots a `slice_plan` stores."""
    return int(plan[1].astype(np.int64).sum()) * SLICE_ROWS


def whole_matrix_plan(counts: np.ndarray, padded_rows: int, rowsize: int):
    """The whole matrix's `slice_plan` where it stores fewer slots than the
    padded layout's ``padded_rows * rowsize``, else None."""
    plan = slice_plan(counts, padded_rows)
    return plan if sliced_slots(plan) < padded_rows * rowsize else None


def _slices_on(device) -> bool:
    """Whether a whole-matrix ELLPACK on `device` takes the sliced layout:
    on a card, where K1 reads it."""
    return torch.device(device).type == "cuda"


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
               dtype, device, fmt, narrow, plan=None) -> EllMatrix:
    """`ell_from_row_major`'s copy to `device`, with the narrow layout
    `narrow_columns` found (or None); laid out in slices where a
    `slice_plan` is given. Spans ``ell.copy`` (the copies, and the padded
    layout's transposes) and ``ell.slices`` (`_sliced`)."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    with upload(device, fmt, colidx, values, diag, narrow):
        with span("ell.copy"):
            d = None if diag is None else put(diag).to(dtype)
            if plan is None:
                lbase = lcol = None
                if narrow is not None:
                    lbase = put(narrow[0])
                    lcol = put(narrow[1]).t().contiguous()
                return EllMatrix(put(colidx).t().contiguous(),
                                 put(values).t().contiguous().to(dtype), d,
                                 num_rows, num_columns, num_nonzeros, lbase,
                                 lcol)
            padded = [put(colidx), put(values)]
            plan = tuple(map(put, plan))
        with span("ell.slices"):
            # taken out of `padded`, so that `_sliced` holds the only
            # references and frees the padded arrays once it has read them
            return _sliced(padded.pop(0), padded.pop(0), d, num_rows,
                           num_columns, num_nonzeros, dtype, plan)


def _sliced(colidx, values, diag, num_rows, num_columns, num_nonzeros,
            dtype, plan) -> EllMatrix:
    """The sliced layout of the row-major padded arrays `colidx` and
    `values`, on their device, by `plan` (`slice_plan`'s arrays there),
    and its narrow layout where `narrow_bases` finds one on the slices'
    columns: each position's least and greatest column among its stored
    slots stand for them."""
    rows, width, start = plan
    padded_rows, rowsize = colidx.shape
    stored = int(width.sum(dtype=torch.int64)) * SLICE_ROWS
    sl = EllSlices(width, start, rows, rowsize, padded_rows, stored)
    cols = colidx.new_zeros(stored)
    vals = values.new_zeros(stored)
    blocks = -(-padded_rows // LBLOCK)
    lo = torch.full((blocks * LBLOCK,), np.iinfo(np.int64).max,
                    dtype=torch.int64, device=colidx.device)
    hi = torch.full_like(lo, -1)
    row = sl.row_of_position()
    for s, dest, pos in sl.slots():
        c = colidx[row[pos], s]
        cols[dest] = c
        vals[dest] = values[row[pos], s]
        lo[pos] = torch.minimum(lo[pos], c)
        hi[pos] = torch.maximum(hi[pos], c)
    del colidx, values
    lo = lo.view(blocks, LBLOCK).amin(1).cpu().numpy()
    hi = hi.view(blocks, LBLOCK).amax(1).cpu().numpy()
    empty = hi < 0          # a block with no slots takes any base
    lo[empty] = hi[empty] = 0
    b = np.arange(blocks)
    base = narrow_bases(np.concatenate([b, b]), np.concatenate([lo, hi]),
                        blocks)
    lbase = lcol = None
    if base is not None:
        lbase = torch.from_numpy(base).to(cols.device, cols.dtype)
        lcol = torch.zeros(stored, dtype=torch.int16, device=cols.device)
        for _, dest, pos in sl.slots():
            off = cols[dest] - lbase[pos // LBLOCK]     # below NARROW_SPAN
            lcol[dest] = torch.where(off >= NARROW_SPAN // 2,
                                     off - NARROW_SPAN, off).to(torch.int16)
    return EllMatrix(cols, vals.to(dtype), diag, num_rows, num_columns,
                     num_nonzeros, lbase, lcol, sl)


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

    The whole matrix (`row_tile` and `rowsize` left as they are) takes the
    sliced layout on a card where `whole_matrix_plan` stores fewer slots.
    The span ``formats.build.ell`` records `sliced`, the `slots` K1 reads
    (rows × rowsize padded, the slices' slots sliced), the padded layout's
    `padded_slots` and whether the columns built are `narrow`. Its
    children: ``ell.expand_symmetry``, ``ell.counts`` (the diagonal split
    and the rows' counts), ``ell.fill`` (the sort and the padded arrays),
    ``ell.slice_plan`` (`whole_matrix_plan`, on a card) and
    ``ell.narrow_columns`` (where the matrix is not sliced). The copy to
    `device` follows the build (`_on_device`).
    """
    if row_tile <= 0 or row_tile % ROW_TILE:
        raise ValueError(f"row_tile {row_tile} is not a positive multiple "
                         f"of {ROW_TILE}")
    whole = row_tile == ROW_TILE and rowsize is None
    with span("formats.build.ell") as build:
        with span("ell.expand_symmetry"):
            coo = coo.expand_symmetry()
        n, m = coo.num_rows, coo.num_columns
        nnz_total = coo.num_nonzeros

        with span("ell.counts"):
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
        with span("ell.fill"):
            colidx = values = None
            if coo.num_nonzeros and rowsize and idx_dt == np.dtype(np.int32):
                # the native counting-sort packer, where the host library
                # is available (the reference packs in parallel C,
                # ellspmv.c:1081-1127)
                if native.available():
                    colidx, values = native.ell_pack(n, m, n_pad, rowsize,
                                                     coo.rowidx, coo.colidx,
                                                     coo.values, sort_rows)
                    values = values.astype(host_dt, copy=False)
            if colidx is None:
                # allocated only here: the native packer returns its own
                # arrays
                pad_col = np.minimum(np.arange(n_pad, dtype=idx_dt),
                                     max(m - 1, 0)).astype(idx_dt)
                colidx = np.broadcast_to(pad_col[:, None],
                                         (n_pad, rowsize)).copy()
                values = np.zeros((n_pad, rowsize), host_dt)
                if coo.num_nonzeros and rowsize:
                    # One sort by (row [, col]) gives each entry its slot:
                    # the reference's per-row fill cursor
                    # (ellspmv.c:1097-1107) and rowsort.
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
        plan = narrow = None
        if whole and _slices_on(device):
            with span("ell.slice_plan"):
                plan = whole_matrix_plan(counts, n_pad, rowsize)
        if plan is None:
            with span("ell.narrow_columns"):
                narrow = narrow_columns(colidx)
        build.set(rowsize=rowsize, nonzeros=nnz_total, sliced=plan is not None,
                  slots=n * rowsize if plan is None else sliced_slots(plan),
                  padded_slots=n * rowsize, narrow=narrow is not None)

    ell = _on_device(colidx, values, diag, n, m, nnz_total, dtype, device,
                     "ell", narrow, plan)
    if plan is not None:
        build.set(narrow=ell.lcol is not None)
    return ell


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
