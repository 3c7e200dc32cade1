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
  padded_rows``) and the column indices at the width the kernel reads them
  (``EllMatrix.index_bytes``: 2 bytes a slot and one base per block of 256
  rows in the narrow layout, else 4 or 8), x once, the split diagonal when
  there is one, y when given, and the output;
- K2 (``csrc/dia_spmv.cu``): the diagonals' values (``num_diags *
  num_rows``), x once, y when given, and the output;
- K6 (``csrc/dot.cu``): both vectors once (the 8-byte result is left out);
- one CG iteration (``models/solvers.cg``): K1 without y, two K6 dots and
  three vector updates, each reading two vectors and writing one;
- the stream format (``formats/stream.py``), from its plan: K1 over the
  products, one slot per position of level 1 (values, column indices at
  the width K1 reads them, x once, the products written); per level K3
  (`sum_bytes`: the live elements read, and on the deeper levels their map
  entries, the outputs written, the table); the final gather
  (`gather_bytes`: its map, the live elements read, every row written);
  the diagonal and y, read once each.

x is counted once: the kernels rely on L1/L2 for its re-reads.
"""

from __future__ import annotations

from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import LBLOCK, EllMatrix
from ellspmv_tpu_torch.formats.stream import StreamMatrix
from ellspmv_tpu_torch.ops.permute import BLOCK


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


def estimate_actual_bytes(matrix, with_y: bool = True) -> int:
    """Bytes one kernel call on `matrix` reads and writes, with y read when
    `with_y` (as in every accumulating call of the benchmark). For the
    stream format, the bytes of all its kernels in one SpMV."""
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
        sv = matrix.values.element_size()
        total = matrix.rowsize * matrix.padded_rows * sv + matrix.index_bytes
        if matrix.diag is not None:
            total += matrix.num_rows * sv
    elif isinstance(matrix, DiaMatrix):
        sv = matrix.data.element_size()
        total = matrix.diasize * sv
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
