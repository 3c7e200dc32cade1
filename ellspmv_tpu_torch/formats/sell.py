"""Sliced ELL with a CSR tail, for skewed matrices: the counterpart of
``ellspmv_tpu.formats.sell``.

Plain ELLPACK pads every row to the longest (ellsize = num_rows * max row
nnz, ellspmv.c:955), which blows up where a few rows are long. This format
keeps ELL's kernel (K1) and bounds the padding:

- rows go in slices of ``slice_rows`` (1024); each slice stores only its
  own longest row, rounded up to a power of two of at least 4, and slices
  of one width form a bucket, one ELLPACK matrix and one K1 launch;
- entries beyond ``tail_cap`` in a row go to a CSR tail, summed by the
  segment-sum form of ``ops/csr.py``;
- ``length_sort`` (SELL-sigma) orders rows by their power-of-two length
  group, then by column band and first column, and pads each length group
  to a slice and each band within it to 128 rows, so slices are uniform;
- ``split_rows`` cuts rows longer than ``split_len`` (128) into sub-rows,
  first by column band (``split_cols``, 8192), then by rank, so no bucket
  is wider than 128 and nothing needs the tail; the sub-rows beyond each
  row's first are rows ``n..`` (``extra_rows`` names their row).

The host packing is the JAX package's step for step, so every field equals
its counterpart on the same COO (the buckets' arrays slot-major, as the
port's ELL stores them). `sell_spmv` reassembles y as the JAX package
does: the bucket outputs concatenated, the tiles put back in ``order``,
the tail added, ``row_unperm`` applied, the extra sub-rows summed into
their rows, then y. Those passes are plain PyTorch on any device: in the
JAX package they are XLA ops, not Pallas kernels.

The split's geometry (`SellShape`: the buckets' widths, rows and column
index bytes, the tiles, the tail, the rows reassembled) is all its price
reads (``bench/traffic.sell_bytes``). `SellMatrix.shape` reads it off a
built matrix; `sell_shape` works out the same shape from the COO without
packing anything, so the chooser prices the split without building it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.formats import upload
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.csr import CsrMatrix, csr_from_coo
from ellspmv_tpu_torch.formats.ell import LBLOCK, ell_from_coo, narrow_rows_fit
from ellspmv_tpu_torch.io import native
from ellspmv_tpu_torch.ops import ell_cuda
from ellspmv_tpu_torch.ops.csr import csr_spmv_segment
from ellspmv_tpu_torch.utils.timing import span


#: The column band of the split and of the length sort. The split's
#: recursion leaves it at this default, as the JAX package's does.
SPLIT_COLS = 8192


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class BucketShape:
    """What K1 reads of one bucket: its width, its rows (padded), the
    bytes of its column indices at the width K1 reads them
    (``EllMatrix.index_bytes``) and the bytes of one value."""

    rowsize: int
    num_rows: int
    padded_rows: int
    index_bytes: int
    value_bytes: int


@dataclasses.dataclass(frozen=True)
class TailShape:
    """The CSR tail's rows, entries, and the bytes of the arrays its pass
    reads (row ids, columns and values)."""

    num_rows: int
    csrsize: int
    array_bytes: int


@dataclasses.dataclass(frozen=True)
class SellShape:
    """The geometry of a SELL split, all that ``bench/traffic.sell_bytes``
    and `sell_seconds` read: the buckets; the tiles (`order`'s length);
    the rows, columns and `trivial_reassembly`; the tail; the rows that
    `row_unperm` gathers from (None without the length sort) and the
    extra sub-rows (None where nothing was split). `SellMatrix.shape`
    reads it off a built matrix, `sell_shape` works it out from a COO."""

    buckets: tuple
    num_tiles: int
    num_rows: int
    num_columns: int
    trivial_reassembly: bool
    tail: TailShape | None = None
    unperm_rows: int | None = None
    extra_rows: int | None = None

    @property
    def value_bytes(self) -> int:
        return self.buckets[0].value_bytes

    @property
    def slots(self) -> int:
        """Stored slots across buckets (`SellMatrix.sellsize`)."""
        return sum(b.num_rows * b.rowsize for b in self.buckets)


@dataclasses.dataclass
class SellMatrix:
    """`order[t]` is the place of original tile t among the buckets'
    concatenated tiles; `row_unperm` maps the length-sorted rows back to
    natural order (None without `length_sort`); `extra_rows` is the
    original row of each extra sub-row (None where nothing was split),
    `extra_owners` the rows that have any, ascending, and `extra_counts`
    how many each has; `num_sub_rows` is the row count with them. The
    index arrays are int64 tensors on the matrix's device."""

    buckets: list                 # list[EllMatrix], one per width
    order: torch.Tensor           # (T,)
    slice_rows: int
    tail: CsrMatrix | None
    num_rows: int
    num_columns: int
    num_nonzeros: int
    row_unperm: torch.Tensor | None = None
    extra_rows: torch.Tensor | None = None
    num_sub_rows: int | None = None
    extra_owners: torch.Tensor | None = None
    extra_counts: torch.Tensor | None = None
    #: One bucket in natural tile order and nothing else to reassemble:
    #: `sell_spmv` is then one K1 launch. Worked out from the fields when
    #: not given (None); `to` carries it, so that no call reads `order`
    #: back from the device.
    trivial_reassembly: bool | None = None

    def __post_init__(self):
        if self.trivial_reassembly is None:
            order = self.order.cpu()
            self.trivial_reassembly = (
                len(self.buckets) == 1 and self.tail is None
                and self.row_unperm is None and self.extra_rows is None
                and bool(torch.equal(order, torch.arange(len(order)))))

    @property
    def sellsize(self) -> int:
        """Stored slots across buckets (the padding-bounded work size)."""
        return sum(b.ellsize for b in self.buckets)

    @property
    def tailsize(self) -> int:
        return 0 if self.tail is None else self.tail.csrsize

    @property
    def shape(self) -> SellShape:
        """The matrix's geometry, read off its fields."""
        def rows(t):
            return None if t is None else int(t.shape[0])
        tail = None
        if self.tail is not None:
            t = self.tail
            tail = TailShape(t.num_rows, t.csrsize, sum(
                a.numel() * a.element_size()
                for a in (t.rowids, t.colidx, t.values)))
        return SellShape(
            buckets=tuple(BucketShape(b.rowsize, b.num_rows, b.padded_rows,
                                      b.index_bytes, b.values.element_size())
                          for b in self.buckets),
            num_tiles=int(self.order.shape[0]), num_rows=self.num_rows,
            num_columns=self.num_columns,
            trivial_reassembly=self.trivial_reassembly, tail=tail,
            unperm_rows=rows(self.row_unperm),
            extra_rows=rows(self.extra_rows))

    @property
    def values(self) -> torch.Tensor:
        """The first bucket's values (there is always one): their type is
        the matrix's."""
        return self.buckets[0].values

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "SellMatrix":
        def move(t):
            return None if t is None else t.to(device)
        with upload(device, "sell", self):
            return dataclasses.replace(
                self, buckets=[b.to(device) for b in self.buckets],
                order=self.order.to(device), tail=move(self.tail),
                row_unperm=move(self.row_unperm),
                extra_rows=move(self.extra_rows),
                extra_owners=move(self.extra_owners),
                extra_counts=move(self.extra_counts))


def _length_sort_places(counts, first, split_cols: int, R: int, m: int):
    """The length sort's place for each row, and the rows it spans with its
    gaps, a multiple of `R`. Rows go by their power-of-two length group
    (slices are bucketed by powers of two), longest first; then by column
    band and least column `first` (`m` where a row is empty), so that rows
    with nearby columns share a slice; stably. Each length group is padded
    to a slice, and each band group within it to 128 rows, so that no
    slice or 128-row tile straddles two. The band is a function of the
    least column, so one stable sort by (group, least column) gives the
    order of all three keys."""
    n = len(counts)
    lb = np.ceil(np.log2(np.maximum(counts, 1))).astype(np.int64)
    band = first // max(split_cols, 1)
    key = ((lb.max() - lb).astype(np.uint64) * np.uint64(m + 1)
           + first.astype(np.uint64))
    perm = native.argsort(key)                      # old row at k
    lb_sorted = lb[perm]
    band_sorted = band[perm]
    new_lb = np.concatenate([[True], lb_sorted[1:] != lb_sorted[:-1]])
    new_grp = new_lb | np.concatenate(
        [[True], band_sorted[1:] != band_sorted[:-1]])
    starts = np.flatnonzero(new_grp)
    sizes = np.diff(np.concatenate([starts, [n]]))
    pos_sorted = np.empty(n, np.int64)
    cum = 0
    for g in range(len(starts)):
        gran = R if new_lb[starts[g]] else 128
        cum = -(-cum // gran) * gran
        s0, sz = starts[g], sizes[g]
        pos_sorted[s0:s0 + sz] = cum + np.arange(sz)
        cum += sz
    inv = np.empty(n, np.int64)
    inv[perm] = pos_sorted
    return inv, _round_up(cum, R)


def _slice_widths(counts, tail_cap: int, R: int):
    """Each slice's width: the longest of its `R` rows, capped at
    `tail_cap`, in power-of-two buckets of at least 4."""
    slice_s = np.minimum(counts, tail_cap).reshape(-1, R).max(axis=1)
    return np.maximum(4, 2 ** np.ceil(
        np.log2(np.maximum(slice_s, 1))).astype(np.int64))


def sell_from_coo(coo: CooMatrix, slice_rows: int = 1024,
                  tail_cap: int = 64, sort_rows: bool = True,
                  length_sort: bool = False, split_rows: bool = True,
                  split_len: int = 128, split_cols: int = SPLIT_COLS,
                  value_dtype=None, index_dtype=None,
                  device="cpu") -> SellMatrix:
    """Convert COO to the bucketed sliced ELL with a CSR tail, on `device`
    (``ellspmv_tpu.formats.sell.sell_from_coo``, its arguments and
    defaults). `value_dtype` is a ``--precision`` name or a torch type;
    `slice_rows` must be a multiple of 8 (``formats/ell.ROW_TILE``)."""
    with span("formats.build.sell"):
        coo = coo.expand_symmetry()
        n, m = coo.num_rows, coo.num_columns
        n_out = n      # the caller-visible row count (before group padding)
        nnz_total = coo.num_nonzeros
        R = slice_rows

        def index(a):
            return torch.from_numpy(np.asarray(a, np.int64)).to(device)

        if split_rows and n:
            counts0 = np.bincount(coo.rowidx, minlength=n)
            long_row = counts0 > split_len
            if long_row.any():
                with span("sell.split"):
                    # Split long rows by column band first (a bounded
                    # column span per sub-row), then by rank within a band
                    # (a bounded count).
                    order0 = np.lexsort((coo.colidx, coo.rowidx))
                    rows0 = coo.rowidx[order0].astype(np.int64)
                    cols0 = coo.colidx[order0].astype(np.int64)
                    band = np.where(long_row[rows0], cols0 // split_cols,
                                    0)
                    grp_change = np.empty(len(rows0), bool)
                    grp_change[0] = True
                    grp_change[1:] = ((rows0[1:] != rows0[:-1])
                                      | (band[1:] != band[:-1]))
                    grp_id = np.cumsum(grp_change) - 1
                    starts = np.flatnonzero(grp_change)
                    rank_in_grp = np.arange(len(rows0)) - starts[grp_id]
                    sub_change = grp_change | (
                        (rank_in_grp > 0) & (rank_in_grp % split_len == 0))
                    sub_seq = np.cumsum(sub_change) - 1   # row-major ids
                    sub_first = np.flatnonzero(sub_change)
                    sub_row = rows0[sub_first]     # original row per sub
                    nsub = np.bincount(sub_row, minlength=n)  # 0: empty rows
                    sub_off = np.concatenate([[0], np.cumsum(nsub)])
                    ordinal = np.arange(len(sub_row)) - sub_off[sub_row]
                    nextra = np.maximum(nsub - 1, 0)
                    extra_off = np.concatenate([[0], np.cumsum(nextra)])
                    final = np.where(ordinal == 0, sub_row,
                                     n + extra_off[sub_row] + ordinal - 1)
                    num_sub = int(n + extra_off[-1])
                sm = sell_from_coo(
                    CooMatrix(num_sub, m, final[sub_seq],
                              coo.colidx[order0], coo.values[order0]),
                    slice_rows=slice_rows, tail_cap=max(tail_cap, split_len),
                    sort_rows=sort_rows, length_sort=length_sort,
                    split_rows=False, value_dtype=value_dtype,
                    index_dtype=index_dtype, device=device)
                return dataclasses.replace(
                    sm, num_rows=n, num_nonzeros=nnz_total,
                    extra_rows=index(np.repeat(np.arange(n), nextra)),
                    num_sub_rows=num_sub, trivial_reassembly=False,
                    extra_owners=index(np.flatnonzero(nextra)),
                    extra_counts=index(nextra[nextra > 0]))

        row_unperm = None
        if length_sort and n:
            with span("sell.length_sort"):
                cnt0 = np.bincount(coo.rowidx, minlength=n)
                first = np.full(n, m, np.int64)
                np.minimum.at(first, coo.rowidx,
                              coo.colidx.astype(np.int64))
                inv, n_eff = _length_sort_places(cnt0, first, split_cols,
                                                 R, m)
                coo = CooMatrix(n_eff, m, inv[coo.rowidx], coo.colidx,
                                coo.values)
                n = n_eff
                row_unperm = inv                    # y_nat = y_sorted[inv]

        if split_rows:
            # rows are at most split_len long (naturally or after the split
            # above), so nothing needs the tail
            tail_cap = max(tail_cap, split_len)

        n_pad = max(_round_up(n, R), R)
        T = n_pad // R

        with span("sell.row_sort"):
            # each entry's rank in its row (by file order, or by column when
            # sorting, as rowsort orders them, ellspmv.c:960-1079)
            if sort_rows:
                order = np.lexsort((coo.colidx, coo.rowidx))
            else:
                order = np.argsort(coo.rowidx, kind="stable")
            rows = coo.rowidx[order]
            cols = coo.colidx[order]
            vals = coo.values[order]
            counts = np.bincount(rows, minlength=n_pad)
            rowptr = np.concatenate([[0], np.cumsum(counts)])
            rank = np.arange(len(rows)) - rowptr[rows]

        with span("sell.pack"):
            in_tail = rank >= tail_cap
            tail = None
            if in_tail.any():
                tail = csr_from_coo(CooMatrix(n, m, rows[in_tail],
                                              cols[in_tail], vals[in_tail]),
                                    value_dtype=value_dtype,
                                    index_dtype=index_dtype, device=device)
            keep = ~in_tail
            rows, cols, vals = rows[keep], cols[keep], vals[keep]

            bucket_s = _slice_widths(counts, tail_cap, R)
            bucket_sizes = sorted(set(int(b) for b in bucket_s))

            buckets = []
            concat_pos = np.zeros(T, np.int64)
            pos = 0
            tile_of_row = rows // R
            for S in bucket_sizes:
                tiles = np.nonzero(bucket_s == S)[0]
                concat_pos[tiles] = pos + np.arange(len(tiles))
                pos += len(tiles)
                # the entries of these tiles, their rows renumbered
                # contiguously
                tile_rank = np.full(T, -1, np.int64)
                tile_rank[tiles] = np.arange(len(tiles))
                sel = tile_rank[tile_of_row] >= 0
                sub_rows = tile_rank[tile_of_row[sel]] * R + rows[sel] % R
                sub = CooMatrix(len(tiles) * R, m, sub_rows, cols[sel],
                                vals[sel])
                buckets.append(ell_from_coo(sub, sort_rows=sort_rows,
                                            value_dtype=value_dtype,
                                            index_dtype=index_dtype,
                                            device=device, row_tile=R,
                                            rowsize=S))
            return SellMatrix(buckets=buckets, order=index(concat_pos),
                              slice_rows=R, tail=tail, num_rows=n_out,
                              num_columns=m, num_nonzeros=nnz_total,
                              row_unperm=(None if row_unperm is None
                                          else index(row_unperm)))


def sell_shape(coo: CooMatrix, slice_rows: int = 1024, tail_cap: int = 64,
               sort_rows: bool = True, length_sort: bool = False,
               split_rows: bool = True, split_len: int = 128,
               split_cols: int = SPLIT_COLS, value_dtype=None,
               index_dtype=None) -> SellShape:
    """The shape ``sell_from_coo(coo, ...)`` builds with the same
    arguments, field for field, worked out without packing anything:
    from each row's (or sub-row's) entry count and least and greatest
    column.

    Every slice holds rows of one length group, so a slice's width does
    not depend on the order of the rows inside it, and the narrow column
    layout needs only each row's extremes (``formats/ell.narrow_rows_fit``).
    The split's sub-rows take the long rows' entries in (row, column)
    order: as they are where one pass shows the COO is in that order, else
    sorted alone (``io/native.argsort``). The length sort sorts the rows,
    not the entries."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    dtype = config.value_dtype(coo.values.dtype if value_dtype is None
                               else value_dtype)
    value_bytes = torch.empty(0, dtype=dtype).element_size()
    rows, cols = coo.rowidx, coo.colidx
    counts = (np.bincount(rows, minlength=n) if n
              else np.zeros(0, np.int64))
    ordered = _in_row_order(rows, cols)
    lo, hi = _row_extremes(rows, cols, counts, m, ordered)
    common = dict(m=m, R=slice_rows, value_bytes=value_bytes,
                  index_dtype=index_dtype)
    if split_rows and n and (counts > split_len).any():
        sub, lo, hi = _split(rows, cols, counts, lo, hi, split_len,
                             split_cols, m, ordered)
        # the split's recursion: no tail, and the length sort's band at
        # its default
        built = _shape_of_rows(sub, lo, lo, hi, tail_cap=max(tail_cap,
                                                             split_len),
                               length_sort=length_sort,
                               split_cols=SPLIT_COLS, **common)
        return dataclasses.replace(built, num_rows=n, extra_rows=len(sub) - n,
                                   trivial_reassembly=False)
    if split_rows:
        tail_cap = max(tail_cap, split_len)
    kept_lo, kept_hi = lo, hi
    over = counts > tail_cap
    if tail_cap and over.any():
        # such a row keeps its first `tail_cap` entries, by column when
        # sorting, else in file order; the rest go to the tail
        c = _columns_of(rows, cols, over, sort_rows, m, ordered)
        lens = counts[over]
        kept = c[((np.cumsum(lens) - lens)[:, None]
                  + np.arange(tail_cap)).ravel()].reshape(-1, tail_cap)
        kept_lo, kept_hi = lo.copy(), hi.copy()
        kept_lo[over], kept_hi[over] = kept.min(axis=1), kept.max(axis=1)
    return _shape_of_rows(counts, lo, kept_lo, kept_hi, tail_cap=tail_cap,
                          length_sort=length_sort, split_cols=split_cols,
                          **common)


def _in_row_order(rows, cols) -> bool:
    """Whether the entries are in (row, column) order, by one pass."""
    if len(rows) < 2:
        return True
    step = np.diff(rows)
    if step.min() < 0:
        return False
    return bool((np.diff(cols)[step == 0] >= 0).all())


def _row_extremes(rows, cols, counts, m: int, ordered: bool):
    """Each row's least and greatest column (`m` and -1 where it is
    empty): read at the rows' ends where the entries are `ordered`, else
    from one reduction."""
    lo = np.full(len(counts), m, np.int64)
    hi = np.full(len(counts), -1, np.int64)
    if ordered:
        full = np.flatnonzero(counts)
        end = np.cumsum(counts)[full]
        lo[full] = cols[end - counts[full]]
        hi[full] = cols[end - 1]
    else:
        c = cols.astype(np.int64)
        np.minimum.at(lo, rows, c)
        np.maximum.at(hi, rows, c)
    return lo, hi


def _columns_of(rows, cols, selected, by_column: bool, m: int,
                ordered: bool):
    """The columns of the `selected` rows' entries, row after row, each
    row's by column (`by_column`) or in file order, stably: only these
    entries are sorted, and none where the COO is `ordered`."""
    keep = selected[rows]
    c = cols[keep]
    if not ordered:
        key = (np.cumsum(selected) - 1)[rows[keep]].astype(np.uint64)
        if by_column:
            key = key * np.uint64(m) + c.astype(np.uint64)
        c = c[native.argsort(key)]
    return c


def _split(rows, cols, counts, lo, hi, split_len: int, split_cols: int,
           m: int, ordered: bool):
    """The rows `sell_from_coo`'s split makes, in their final order: the
    rows, then each row's extra sub-rows. Each one's count and least and
    greatest column (0, `m` and -1 where empty)."""
    n = len(counts)
    long_row = counts > split_len
    long_rows = np.flatnonzero(long_row)
    c = _columns_of(rows, cols, long_row, True, m, ordered)
    lens = counts[long_rows]
    row_start = np.cumsum(lens) - lens
    # a long row's column bands, each cut into sub-rows of split_len
    band = c // split_cols
    new = np.empty(len(c), bool)
    new[0] = True
    np.not_equal(band[1:], band[:-1], out=new[1:])
    new[row_start] = True
    g_start = np.flatnonzero(new)
    g_end = np.append(g_start[1:], len(c))
    chunks = -(-(g_end - g_start) // split_len)
    grp = np.repeat(np.arange(len(g_start)), chunks)
    start = (g_start[grp]
             + (np.arange(len(grp)) - (np.cumsum(chunks) - chunks)[grp])
             * split_len)
    end = np.minimum(start + split_len, g_end[grp])
    # the sub-row's long row, by rank, and its place among the row's
    rank = np.searchsorted(row_start, start, side="right") - 1
    per_row = np.bincount(rank, minlength=len(long_rows))
    ordinal = np.arange(len(start)) - (np.cumsum(per_row) - per_row)[rank]
    nextra = np.zeros(n, np.int64)
    nextra[long_rows] = per_row - 1
    owner = long_rows[rank]
    final = np.where(ordinal == 0, owner,
                     n + (np.cumsum(nextra) - nextra)[owner] + ordinal - 1)
    num_sub = n + int(nextra.sum())
    sub = np.zeros(num_sub, np.int64)
    sub[:n] = np.where(long_row, 0, counts)
    sub_lo = np.full(num_sub, m, np.int64)
    sub_hi = np.full(num_sub, -1, np.int64)
    sub_lo[:n], sub_hi[:n] = lo, hi
    sub[final] = end - start
    sub_lo[final], sub_hi[final] = c[start], c[end - 1]
    return sub, sub_lo, sub_hi


def _shape_of_rows(counts, first, lo, hi, m: int, R: int, tail_cap: int,
                   length_sort: bool, split_cols: int, value_bytes: int,
                   index_dtype) -> SellShape:
    """`sell_from_coo`'s shape over rows that are not split further: each
    row's entry count, least column over all its entries (`first`, for
    the length sort) and least and greatest column of those it keeps out
    of the tail (`lo`, `hi`)."""
    n = num_rows = len(counts)
    unperm = None
    place = np.arange(n)
    if length_sort and n:
        place, n = _length_sort_places(counts, first, split_cols, R, m)
        unperm = num_rows
    n_pad = max(_round_up(n, R), R)

    def placed(a):
        out = np.zeros(n_pad, np.int64)
        out[place] = a
        return out
    cnt, lo, hi = placed(counts), placed(lo), placed(hi)
    capped = np.minimum(cnt, tail_cap)
    widths = _slice_widths(cnt, tail_cap, R)
    buckets = []
    for S in sorted(set(widths.tolist())):
        tiles = np.flatnonzero(widths == S)
        rows = (tiles[:, None] * R + np.arange(R)).ravel()
        c, p = capped[rows], len(rows)
        isz = config.select_index_dtype(p, m, max(int(c.sum()), 1),
                                        index_dtype).itemsize
        if narrow_rows_fit(c, lo[rows], hi[rows], S, m):
            index_bytes = 2 * S * p + -(-p // LBLOCK) * isz
        else:
            index_bytes = isz * S * p
        buckets.append(BucketShape(S, p, p, index_bytes, value_bytes))
    tail = None
    in_tail = int((cnt - capped).sum())
    if in_tail:
        isz = config.select_index_dtype(n, m, in_tail, index_dtype).itemsize
        tail = TailShape(n, in_tail, in_tail * (2 * isz + value_bytes))
    return SellShape(tuple(buckets), n_pad // R, num_rows, m,
                     len(buckets) == 1 and tail is None and unperm is None,
                     tail, unperm)


def kernel_launches(sm: SellMatrix) -> int:
    """K1 launches of one `sell_spmv` on `sm`: one per bucket."""
    return len(sm.buckets)


def bucket_spmv(backend: str):
    """The ELL SpMV that runs each bucket under `backend`: K1's wrapper for
    ``auto`` and ``pallas``, its plain PyTorch version for ``xla`` (the JAX
    package's XLA route, asked for by the user)."""
    if backend in ("auto", "pallas"):
        return ell_cuda.ell_spmv
    if backend == "xla":
        return ell_cuda.ell_spmv_torch
    raise ValueError(f"unknown backend {backend!r}")


def sell_spmv(sm: SellMatrix, x: torch.Tensor,
              y: torch.Tensor | None = None,
              backend: str = "auto") -> torch.Tensor:
    """y := A*x + y: K1 per bucket (`bucket_spmv` of `backend`), then the
    JAX package's reassembly (the tiles in `order`, the tail, `row_unperm`,
    the extra sub-rows summed in order and added to their rows, y), in the
    values' type. Every sum is deterministic: each row's extra sub-rows go
    through one segmented sum (``torch.segment_reduce``, one sequential sum
    a row on the CPU as the JAX package's ``segment_sum`` there), where
    ``index_add_``'s atomics on a card would add them in a varying order."""
    dtype = sm.values.dtype
    x = x.to(dtype)
    n = sm.num_rows
    ell_spmv = bucket_spmv(backend)
    if sm.trivial_reassembly:
        out = ell_spmv(sm.buckets[0], x)[:n]
        return out if y is None else out + y.to(dtype)
    parts = [ell_spmv(b, x) for b in sm.buckets]
    flat = parts[0] if len(parts) == 1 else torch.cat(parts)
    out = flat.view(-1, sm.slice_rows)[sm.order].reshape(-1)
    if sm.tail is not None:                  # the tail's rows are padded
        out = csr_spmv_segment(sm.tail, x, out[:sm.tail.num_rows])
    if sm.row_unperm is not None:
        # the padded sorted vector: group padding leaves gap rows that the
        # unpermutation skips
        out = out[sm.row_unperm]
    else:
        out = out[:sm.num_sub_rows if sm.num_sub_rows is not None else n]
    if sm.extra_rows is not None:
        # each row's extra sub-rows (contiguous, in order) summed, then
        # added to it, as the JAX package's segment_sum and add; one add
        # to each owner, so the atomics of `index_add` cannot reorder it
        sums = torch.segment_reduce(out[n:], "sum", lengths=sm.extra_counts,
                                    unsafe=True)
        out = out[:n].index_add(0, sm.extra_owners, sums)
    return out if y is None else out + y.to(dtype)

