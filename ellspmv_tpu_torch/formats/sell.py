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
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.csr import CsrMatrix, csr_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.ops import ell_cuda
from ellspmv_tpu_torch.ops.csr import csr_spmv_segment


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass
class SellMatrix:
    """`order[t]` is the place of original tile t among the buckets'
    concatenated tiles; `row_unperm` maps the length-sorted rows back to
    natural order (None without `length_sort`); `extra_rows` is the
    original row of each extra sub-row (None where nothing was split) and
    `num_sub_rows` the row count with them. The index arrays are int64
    tensors on the matrix's device."""

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
        return dataclasses.replace(
            self, buckets=[b.to(device) for b in self.buckets],
            order=self.order.to(device), tail=move(self.tail),
            row_unperm=move(self.row_unperm),
            extra_rows=move(self.extra_rows))


def sell_from_coo(coo: CooMatrix, slice_rows: int = 1024,
                  tail_cap: int = 64, sort_rows: bool = True,
                  length_sort: bool = False, split_rows: bool = True,
                  split_len: int = 128, split_cols: int = 8192,
                  value_dtype=None, index_dtype=None,
                  device="cpu") -> SellMatrix:
    """Convert COO to the bucketed sliced ELL with a CSR tail, on `device`
    (``ellspmv_tpu.formats.sell.sell_from_coo``, its arguments and
    defaults). `value_dtype` is a ``--precision`` name or a torch type;
    `slice_rows` must be a multiple of 8 (``formats/ell.ROW_TILE``)."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    n_out = n          # the caller-visible row count (before group padding)
    nnz_total = coo.num_nonzeros
    R = slice_rows

    def index(a):
        return torch.from_numpy(np.asarray(a, np.int64)).to(device)

    if split_rows and n:
        counts0 = np.bincount(coo.rowidx, minlength=n)
        long_row = counts0 > split_len
        if long_row.any():
            # Split long rows by column band first (a bounded column span
            # per sub-row), then by rank within a band (a bounded count).
            order0 = np.lexsort((coo.colidx, coo.rowidx))
            rows0 = coo.rowidx[order0].astype(np.int64)
            cols0 = coo.colidx[order0].astype(np.int64)
            band = np.where(long_row[rows0], cols0 // split_cols, 0)
            grp_change = np.empty(len(rows0), bool)
            grp_change[0] = True
            grp_change[1:] = (rows0[1:] != rows0[:-1]) | (band[1:]
                                                          != band[:-1])
            grp_id = np.cumsum(grp_change) - 1
            starts = np.flatnonzero(grp_change)
            rank_in_grp = np.arange(len(rows0)) - starts[grp_id]
            sub_change = grp_change | ((rank_in_grp > 0)
                                       & (rank_in_grp % split_len == 0))
            sub_seq = np.cumsum(sub_change) - 1       # row-major sub ids
            sub_first = np.flatnonzero(sub_change)
            sub_row = rows0[sub_first]                # original row per sub
            nsub = np.bincount(sub_row, minlength=n)  # 0 for empty rows
            sub_off = np.concatenate([[0], np.cumsum(nsub)])
            ordinal = np.arange(len(sub_row)) - sub_off[sub_row]
            nextra = np.maximum(nsub - 1, 0)
            extra_off = np.concatenate([[0], np.cumsum(nextra)])
            final = np.where(ordinal == 0, sub_row,
                             n + extra_off[sub_row] + ordinal - 1)
            num_sub = int(n + extra_off[-1])
            sm = sell_from_coo(
                CooMatrix(num_sub, m, final[sub_seq], coo.colidx[order0],
                          coo.values[order0]),
                slice_rows=slice_rows, tail_cap=max(tail_cap, split_len),
                sort_rows=sort_rows, length_sort=length_sort,
                split_rows=False, value_dtype=value_dtype,
                index_dtype=index_dtype, device=device)
            return dataclasses.replace(
                sm, num_rows=n, num_nonzeros=nnz_total,
                extra_rows=index(np.repeat(np.arange(n), nextra)),
                num_sub_rows=num_sub, trivial_reassembly=False)

    row_unperm = None
    if length_sort and n:
        cnt0 = np.bincount(coo.rowidx, minlength=n)
        # primary key: the power-of-two length group (slices are bucketed
        # by powers of two); then the column band and each row's least
        # column, so that rows with nearby columns share a slice
        first = np.full(n, m, np.int64)
        np.minimum.at(first, coo.rowidx, coo.colidx.astype(np.int64))
        lb = np.ceil(np.log2(np.maximum(cnt0, 1))).astype(np.int64)
        band = first // max(split_cols, 1)
        perm = np.lexsort((first, band, -lb))        # old row at position k
        # pad each length group to a slice, and each band group within it
        # to 128 rows, so that no slice or 128-row tile straddles two
        lb_sorted = lb[perm]
        band_sorted = band[perm]
        new_lb = np.concatenate([[True],
                                 lb_sorted[1:] != lb_sorted[:-1]])
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
        n_eff = _round_up(cum, R)                    # includes gap rows
        coo = CooMatrix(n_eff, m, inv[coo.rowidx], coo.colidx, coo.values)
        n = n_eff
        row_unperm = inv                              # y_nat = y_sorted[inv]

    if split_rows:
        # rows are at most split_len long (naturally or after the split
        # above), so nothing needs the tail
        tail_cap = max(tail_cap, split_len)

    n_pad = max(_round_up(n, R), R)
    T = n_pad // R

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

    in_tail = rank >= tail_cap
    tail = None
    if in_tail.any():
        tail = csr_from_coo(CooMatrix(n, m, rows[in_tail], cols[in_tail],
                                      vals[in_tail]),
                            value_dtype=value_dtype, index_dtype=index_dtype,
                            device=device)
    keep = ~in_tail
    rows, cols, vals = rows[keep], cols[keep], vals[keep]

    # each slice's width (capped), in power-of-two buckets of at least 4
    capped = np.minimum(counts[:n_pad], tail_cap)
    slice_s = capped.reshape(T, R).max(axis=1)
    bucket_s = np.maximum(4, 2 ** np.ceil(
        np.log2(np.maximum(slice_s, 1))).astype(np.int64))
    bucket_sizes = sorted(set(int(b) for b in bucket_s))

    buckets = []
    concat_pos = np.zeros(T, np.int64)
    pos = 0
    tile_of_row = rows // R
    for S in bucket_sizes:
        tiles = np.nonzero(bucket_s == S)[0]
        concat_pos[tiles] = pos + np.arange(len(tiles))
        pos += len(tiles)
        # the entries of these tiles, their rows renumbered contiguously
        tile_rank = np.full(T, -1, np.int64)
        tile_rank[tiles] = np.arange(len(tiles))
        sel = tile_rank[tile_of_row] >= 0
        sub_rows = tile_rank[tile_of_row[sel]] * R + rows[sel] % R
        sub = CooMatrix(len(tiles) * R, m, sub_rows, cols[sel], vals[sel])
        buckets.append(ell_from_coo(sub, sort_rows=sort_rows,
                                    value_dtype=value_dtype,
                                    index_dtype=index_dtype, device=device,
                                    row_tile=R, rowsize=S))
    return SellMatrix(buckets=buckets, order=index(concat_pos), slice_rows=R,
                      tail=tail, num_rows=n_out, num_columns=m,
                      num_nonzeros=nnz_total,
                      row_unperm=(None if row_unperm is None
                                  else index(row_unperm)))


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
    the extra sub-rows summed with ``index_add_`` and added to their rows,
    y), in the values' type."""
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
        # each row's extra sub-rows summed in order, then added to it, as
        # the JAX package's segment_sum and add
        extras = out.new_zeros(n).index_add_(0, sm.extra_rows, out[n:])
        out = out[:n] + extras
    return out if y is None else out + y.to(dtype)

