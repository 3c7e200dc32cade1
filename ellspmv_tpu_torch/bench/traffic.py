"""Physical device-memory bytes per SpMV of the port's kernels, the
counterpart of ``ellspmv_tpu.bench.traffic``.

The reference's byte accounting (min_bytes/max_bytes, ellspmv.c:1858-1862)
is a format-independent model over the padded ELLPACK arrays, so a format
that stores less than ELLPACK (DIA stores no column indices) reports an
*effective* bandwidth above the card's peak. That number is the parity
metric against the reference; this module gives the bytes the kernel itself
must move, so that every report can also carry the physical share (at most
100% of the card's peak when the count is right):

- K1 (``csrc/ell_spmv.cu``): the slot-major values (``rowsize *
  padded_rows``, or the slices' stored slots in the sliced layout) and the
  column indices at the width the kernel reads them
  (``EllMatrix.index_bytes``: 2 bytes a slot and one base per block of 256
  rows in the narrow layout, else 4 or 8), in the sliced layout each
  slice's width and offset and each position's 2-byte row id, x once, the
  split diagonal when there is one, y when given, and the output;
- K2 (``csrc/dia_spmv.cu``): the diagonals' values (``num_diags *
  num_rows``; of a `symmetric` DIA the offsets >= 0 alone, whose shifted
  re-reads hit in L2), x once, y when given, and the output;
- K6 (``csrc/dot.cu``): both vectors once (the 8-byte result is left out);
- one CG iteration (``models/solvers.cg``): K1 without y, two K6 dots and
  three vector updates, each reading two vectors and writing one;
- the stream format (``formats/stream.py``), from its plan: K1 over the
  products, one slot per position of level 1 (values, column indices at
  the width K1 reads them, x once, the products written); per level K3
  (`sum_bytes`: the live elements read, and on the deeper levels their map
  entries, the outputs written, the table); the final gather
  (`gather_bytes`: its map, the live elements read, every row written);
  the diagonal and y, read once each;
- the SELL format (``formats/sell.py``): K1 per bucket without x (values,
  column indices at the width it reads them, the bucket's output
  written), x once for all of them, and the plain reassembly passes that
  `sell_spmv` runs where there is more than one bucket or anything to put
  back: the concatenation (each bucket output read and written again), the
  gather of the tiles into their order (read, written, the order), the
  tail (its three arrays, x gathered and the products per entry, the
  partial sums read, summed and written), the unpermutation (an 8-byte
  index, a read and a write per sub-row), the extra sub-rows' sums (the
  zeroed sums, the extras and their indices read, then the rows' sums read
  and written with them), and y as a pass of its own (read, the result
  read and written); all of it read off the split's shape
  (``formats/sell.SellShape``), which the chooser works out from the COO
  without building the split;
- CSR (``ops/csr.csr_spmv``): its cached SELL repack, the split diagonal's
  epilogue (the diagonal, x and the result read, the result written) and y
  as a pass of its own;
- the hybrid (``formats/hybrid.hybrid_spmv``): the hub's gather of x
  (`gather_bytes` by `hub_cols`), the hub's SELL without y, the rest's
  SELL with the hub's result as its y, and y as a pass of its own: the
  JAX package's sum of the two parts and the hub gather.

x is counted once: the kernels rely on L1/L2 for its re-reads.
"""

from __future__ import annotations

from ellspmv_tpu_torch.formats import tensor_bytes
from ellspmv_tpu_torch.formats.csr import CsrMatrix
from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import LBLOCK, EllMatrix
from ellspmv_tpu_torch.formats.hybrid import HybridMatrix
from ellspmv_tpu_torch.formats.sell import (BucketShape, SellMatrix,
                                             SellShape)
from ellspmv_tpu_torch.formats.stream import StreamMatrix
from ellspmv_tpu_torch.ops.permute import BLOCK


#: K1's launch geometry (``csrc/ell_spmv.cu``): the rows of one block (256
#: threads, two rows each), and the slots whose loads a thread issues
#: together (``kSlotBatch``), one dependent round of loads and gathers.
K1_BLOCK_ROWS = 512
K1_SLOT_BATCH = 4


def k1_rounds(width: int) -> int:
    """The rounds of loads each K1 thread walks over rows of `width`."""
    return -(-width // K1_SLOT_BATCH)


def k1_launch_seconds(rows: int, width: int, nbytes: int, rate: float,
                      round_s: float, sms: int) -> float:
    """The time one K1 launch over `rows` rows of `width` slots takes by
    its geometry as well as its bytes: `nbytes` at `rate`, and where its
    blocks do not fill the card's `sms`, at least its rounds of dependent
    loads at `round_s` each (``config.k1_round_seconds``), which no block
    can overlap with another's."""
    seconds = nbytes / rate
    if -(-rows // K1_BLOCK_ROWS) < sms:
        seconds = max(seconds, k1_rounds(width) * round_s)
    return seconds


def gather_bytes(src, value_bytes: int) -> int:
    """Bytes one gather by the map `src` (``ops/permute.apply_permute``)
    moves: the map, each live element read once, every output written."""
    n = int(src.shape[0])
    return n * (4 + value_bytes) + int((src >= 0).sum()) * value_bytes


def sum_bytes(table, value_bytes: int, with_map: bool = False) -> int:
    """Bytes one level of segmented sums (``ops/stream_sum.stream_sum``)
    moves: each live element read once (and its 4-byte map entry
    `with_map`, the entry points that read through a map), the outputs
    written, the table the kernel reads (the runs' starts and counts, and
    per block of the grid its place, first run and run count)."""
    live = int(table.run_count.sum())
    return (live * (value_bytes + (4 if with_map else 0))
            + table.num_subtiles * 1024 * value_bytes
            + 4 * (2 * int(table.run_start.shape[0])
                   + 3 * int(table.order.shape[0])))


def stream_bytes_estimate(nnz: int, num_rows: int, num_columns: int,
                          value_bytes: int, narrow: bool) -> int:
    """The stream format's bytes per SpMV by the counts alone, for the
    chooser: per padded product slot K1's value, index (2 bytes and a
    4-byte base per 256 slots when `narrow`, the layout of the built
    products, else 4) and product; per entry K3's read; per row K3's
    output, the final gather's map, read and write, and y; x once. The
    deeper levels (a few percent of the products on power-law matrices)
    and the alignment pad of the runs are left out."""
    slots = max(-(-nnz // BLOCK) * BLOCK, BLOCK)
    index = 2 * slots + 4 * (slots // LBLOCK) if narrow else 4 * slots
    return (slots * 2 * value_bytes + index + nnz * value_bytes
            + num_rows * (4 + 4 * value_bytes)
            + num_columns * value_bytes)


def stream_seconds_estimate(nnz: int, num_rows: int, num_columns: int,
                            value_bytes: int, narrow: bool, rate: float,
                            round_s: float, sms: int) -> float:
    """`stream_bytes_estimate` as seconds at `rate`, with K1 over the
    products (one slot a row over the padded products) priced by its
    geometry (`k1_launch_seconds`)."""
    slots = max(-(-nnz // BLOCK) * BLOCK, BLOCK)
    index = 2 * slots + 4 * (slots // LBLOCK) if narrow else 4 * slots
    k1 = 2 * slots * value_bytes + index
    rest = stream_bytes_estimate(nnz, num_rows, num_columns, value_bytes,
                                 narrow) - k1
    return rest / rate + k1_launch_seconds(slots, 1, k1, rate, round_s, sms)


def _bucket_bytes(b: BucketShape) -> int:
    """K1's bytes on one SELL bucket without x: its slots' values, their
    columns at the width it reads them, its output."""
    sv = b.value_bytes
    return b.rowsize * b.padded_rows * sv + b.index_bytes + b.num_rows * sv


def _shape(sm: SellMatrix | SellShape) -> SellShape:
    return sm.shape if isinstance(sm, SellMatrix) else sm


def sell_seconds(sm: SellMatrix | SellShape, rate: float, round_s: float,
                 sms: int) -> float:
    """`sell_bytes` (without y) as seconds at `rate`, with K1 on each
    bucket priced by its geometry (`k1_launch_seconds`). The chooser
    prices the SELL split by the shape alone (``formats/sell.sell_shape``)
    and builds it only where it is chosen."""
    shape = _shape(sm)
    seconds = sell_bytes(shape, with_y=False) / rate
    for b in shape.buckets:
        k1 = _bucket_bytes(b)
        seconds += k1_launch_seconds(b.num_rows, b.rowsize, k1, rate,
                                     round_s, sms) - k1 / rate
    return seconds


def sell_bytes(sm: SellMatrix | SellShape, with_y: bool = True) -> int:
    """Bytes one `sell_spmv` on `sm` moves (the module's docstring), y read
    and added when `with_y`. They depend on the split's shape alone
    (`SellMatrix.shape`, or ``formats/sell.sell_shape`` without a build),
    so a matrix and its shape give the same count."""
    s = _shape(sm)
    sv = s.value_bytes
    n = s.num_rows
    total = s.num_columns * sv                    # x, once for all buckets
    for b in s.buckets:
        total += _bucket_bytes(b)
    if not s.trivial_reassembly:
        tiles = sum(b.num_rows for b in s.buckets)
        if len(s.buckets) > 1:
            total += 2 * tiles * sv               # the concatenation
        total += 2 * tiles * sv + 8 * s.num_tiles
        if s.tail is not None:
            t = s.tail
            total += t.array_bytes
            total += 2 * t.csrsize * sv + 3 * t.num_rows * sv
        if s.unperm_rows is not None:
            total += s.unperm_rows * (8 + 2 * sv)
        if s.extra_rows is not None:
            total += n * sv + s.extra_rows * (8 + sv) + 3 * n * sv
    return total + (3 * n * sv if with_y else 0)


def csr_bytes(csr: CsrMatrix, with_y: bool = True) -> int:
    """Bytes one `csr_spmv` on `csr` moves: its SELL repack (built and
    cached if it is not yet), the split diagonal's epilogue, y."""
    from ellspmv_tpu_torch.ops.csr import to_sell
    sv = csr.values.element_size()
    total = sell_bytes(to_sell(csr), with_y=False)
    if csr.diag is not None:
        total += 4 * min(csr.num_rows, csr.num_columns) * sv
    return total + (3 * csr.num_rows * sv if with_y else 0)


def hybrid_bytes(hm: HybridMatrix, with_y: bool = True) -> int:
    """Bytes one `hybrid_spmv` on `hm` moves (the module's docstring), y
    read and added when `with_y`."""
    sv = hm.values.element_size()
    y_pass = 3 * hm.num_rows * sv if with_y else 0
    if hm.hub is None:
        return sell_bytes(hm.rest, with_y=False) + y_pass
    return (gather_bytes(hm.hub_cols, hm.hub.values.element_size())
            + sell_bytes(hm.hub, with_y=False)
            + sell_bytes(hm.rest, with_y=True) + y_pass)


def estimate_actual_bytes(matrix, with_y: bool = True) -> int:
    """Bytes one kernel call on `matrix` reads and writes, with y read when
    `with_y` (as in every accumulating call of the benchmark). For the
    stream, SELL and CSR formats, the bytes of all the passes of one
    SpMV."""
    if isinstance(matrix, SellMatrix):
        return sell_bytes(matrix, with_y)
    if isinstance(matrix, HybridMatrix):
        return hybrid_bytes(matrix, with_y)
    if isinstance(matrix, CsrMatrix):
        return csr_bytes(matrix, with_y)
    if isinstance(matrix, StreamMatrix):
        sv = matrix.values.element_size()
        plan = matrix.ddsum
        total = estimate_actual_bytes(matrix.prod, with_y=False)   # K1, x
        for lv in plan.levels:
            total += sum_bytes(lv.table, sv, with_map=lv.src is not None)
        total += gather_bytes(plan.final_src, sv)
        if matrix.diag is not None:
            total += matrix.num_rows * sv
        return total + (matrix.num_rows * sv if with_y else 0)
    if isinstance(matrix, EllMatrix):
        # every stored slot (padded or sliced); in the sliced layout each
        # slice's width and offset and each position's row id too
        sv = matrix.values.element_size()
        total = (matrix.values.numel() * sv + matrix.index_bytes
                 + tensor_bytes(matrix.slices))
        if matrix.diag is not None:
            total += matrix.num_rows * sv
    elif isinstance(matrix, DiaMatrix):
        sv = matrix.data.element_size()
        read = (sum(o >= 0 for o in matrix.offsets) if matrix.symmetric
                else matrix.num_diags)
        total = read * matrix.num_rows * sv
    else:
        raise NotImplementedError(
            f"traffic of {type(matrix).__name__} is not yet ported "
            "(see ROADMAP.md)")
    n, m = matrix.num_rows, matrix.num_columns
    return total + m * sv + (2 if with_y else 1) * n * sv


def dot_bytes(n: int, value_bytes: int = 8) -> int:
    """Bytes one dot product of two n-vectors reads."""
    return 2 * n * value_bytes


def cg_iteration_bytes(ell: EllMatrix) -> int:
    """Bytes one CG iteration on `ell` moves: the matvec (K1, no y), the
    dots p·Ap and r·r, and the updates of x, r and p."""
    n, sv = ell.num_rows, ell.values.element_size()
    return (estimate_actual_bytes(ell, with_y=False) + 2 * dot_bytes(n, sv)
            + 3 * 3 * n * sv)
