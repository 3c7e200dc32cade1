"""The port's SELL format (sliced ELL with a CSR tail) against the JAX
package's on the same seeded inputs: `dense_rows` bit for bit,
`ell_from_coo(row_tile=, rowsize=)` and `sell_from_coo` field for field on
the inputs of tests/test_sell.py, `sell_spmv` (K1's plain version on the
CPU) against JAX's ``sell_spmv`` and the NumPy oracle, the metrics and
bytes, the shape the chooser prices without a build (`sell_shape`) against
the built matrix's, the chooser's SELL branch, and `ellspmv
--format=sell|auto`.
Tolerances, per row relative to sum |a*x| + |y|: fp64 1e-13, f32 1e-5. The
``cuda`` tests hold the kernel route against the plain one on a card."""

import dataclasses
import io

import numpy as np
import pytest
import torch

from ellspmv_tpu.bench.harness import SpmvMetrics as JaxSpmvMetrics
from ellspmv_tpu.cli import ellspmv as jax_ellspmv
from ellspmv_tpu.formats.auto import auto_from_coo as jax_auto_from_coo
from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.formats.sell import sell_from_coo as jax_sell_from_coo
from ellspmv_tpu.formats.sell import sell_spmv as jax_sell_spmv
from ellspmv_tpu.io.mtx import read_vector, write_matrix
from ellspmv_tpu.models import generators as jax_generators
from ellspmv_tpu.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.bench.harness import SpmvMetrics
from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.bench.traffic import (estimate_actual_bytes,
                                             sell_bytes, sell_seconds)
from ellspmv_tpu_torch.cli import ellspmv
from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.ell import LBLOCK, ell_from_coo, narrow_bases
from ellspmv_tpu_torch.formats.sell import (SellMatrix, kernel_launches,
                                            sell_from_coo, sell_shape,
                                            sell_spmv)
from ellspmv_tpu_torch.formats.stream import StreamMatrix
from ellspmv_tpu_torch.models.generators import (banded_random, dense_rows,
                                                 power_law)
from ellspmv_tpu_torch.ops import ell_cuda
from ellspmv_tpu_torch.ops.dispatch import spmv
from tests.conftest import random_coo
from tests.test_torch_csr import assert_rows_close, port_coo


@pytest.mark.parametrize("args", [
    (4096, 4, 3, 2000, None, 2), (1024, 3, 2, 500, None, 3),
    (20_000, 8, 4, 2500, None, 0), (3000, 5, 2, 700, 40, 9),
])
def test_dense_rows_bit_equal_to_jax(args):
    n, base, num, dense, bw, seed = args
    want = jax_generators.dense_rows(n, base, num, dense, bandwidth=bw,
                                     seed=seed)
    got = dense_rows(n, base, num, dense, bandwidth=bw, seed=seed)
    assert (got.num_rows, got.num_columns) == (want.num_rows,
                                                want.num_columns)
    for field in ("rowidx", "colidx", "values"):
        w, g = getattr(want, field), getattr(got, field)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def assert_ell_equal(got, want):
    """The port's slot-major ELL against the JAX package's row-major one."""
    np.testing.assert_array_equal(got.colidx.t().numpy(),
                                  np.asarray(want.colidx))
    assert got.colidx.numpy().dtype == np.asarray(want.colidx).dtype
    np.testing.assert_array_equal(got.values.t().numpy(),
                                  np.asarray(want.values))
    assert got.values.numpy().dtype == np.asarray(want.values).dtype
    assert (want.diag is None) == (got.diag is None)
    if want.diag is not None:
        np.testing.assert_array_equal(got.diag.numpy(),
                                      np.asarray(want.diag))
    assert (got.num_rows, got.num_columns, got.num_nonzeros) == \
        (want.num_rows, want.num_columns, want.num_nonzeros)


@pytest.mark.parametrize("row_tile,rowsize", [(8, None), (128, 16),
                                              (1024, 32), (256, 19)])
@pytest.mark.parametrize("separate_diagonal", [False, True])
def test_ell_row_tile_and_rowsize_equal_jax(row_tile, rowsize,
                                            separate_diagonal):
    coo = random_coo(np.random.RandomState(21), 300, 250, 1500,
                     with_dups=True)
    kw = dict(separate_diagonal=separate_diagonal, sort_rows=True,
              row_tile=row_tile, rowsize=rowsize)
    want = jax_ell_from_coo(coo, **kw)
    got = ell_from_coo(port_coo(coo), **kw)
    assert_ell_equal(got, want)
    assert got.padded_rows % row_tile == 0
    if rowsize is not None:
        assert got.rowsize == rowsize


def test_ell_refuses_a_short_rowsize_and_an_odd_tile():
    coo = random_coo(np.random.RandomState(22), 100, 100, 800)
    natural = int(np.bincount(coo.rowidx).max())
    with pytest.raises(ValueError, match="requested rowsize"):
        jax_ell_from_coo(coo, rowsize=natural - 1)
    with pytest.raises(ValueError, match="requested rowsize"):
        ell_from_coo(port_coo(coo), rowsize=natural - 1)
    with pytest.raises(ValueError, match="row_tile"):
        ell_from_coo(port_coo(coo), row_tile=12)


def assert_sell_equal(got: SellMatrix, want):
    assert len(got.buckets) == len(want.buckets)
    for g, w in zip(got.buckets, want.buckets):
        assert_ell_equal(g, w)
    np.testing.assert_array_equal(got.order.numpy(), np.asarray(want.order))
    for field in ("row_unperm", "extra_rows"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (want.tail is None) == (got.tail is None)
    if want.tail is not None:
        from tests.test_torch_csr import assert_csr_equal
        assert_csr_equal(got.tail, want.tail)
    for attr in ("slice_rows", "num_rows", "num_columns", "num_nonzeros",
                 "num_sub_rows", "sellsize", "tailsize",
                 "trivial_reassembly"):
        assert getattr(got, attr) == getattr(want, attr), attr


def _jax_shuffled(coo, seed: int = 0):
    """`coo`'s entries in a random order: out of row order."""
    p = np.random.RandomState(seed).permutation(coo.num_nonzeros)
    return dataclasses.replace(coo, rowidx=coo.rowidx[p],
                               colidx=coo.colidx[p], values=coo.values[p])


def _long_rows_with_duplicates():
    """512 random rows, then rows 7 and 300 with 400 entries each among
    columns 0 .. 149, appended unsorted: each long row holds duplicate
    (row, column) entries whose values differ, so their file order shows
    in the built buckets."""
    rng = np.random.RandomState(35)
    base = random_coo(rng, 512, 512, 1500)
    rows = np.repeat(np.array([7, 300], np.int32), 400)
    cols = rng.randint(0, 150, len(rows)).astype(np.int32)
    return dataclasses.replace(
        base, rowidx=np.concatenate([base.rowidx, rows]),
        colidx=np.concatenate([base.colidx, cols]),
        values=np.concatenate([base.values, rng.randn(len(rows))]))


# name -> (matrix, sell_from_coo keywords): the inputs of tests/test_sell.py,
# and two of the split's entry order (file order within a row, duplicates)
CASES = {
    "power_law_tail": (lambda: jax_generators.power_law(3000, 8, seed=1),
                       dict(slice_rows=256, tail_cap=16, split_rows=False)),
    "power_law_split": (lambda: jax_generators.power_law(3000, 8, seed=1),
                        dict(slice_rows=256, tail_cap=16)),
    "dense_rows_split": (lambda: jax_generators.dense_rows(
        1024, 3, num_dense=2, dense_nnz=500, seed=3),
        dict(slice_rows=128, tail_cap=8)),
    "dense_rows_tail": (lambda: jax_generators.dense_rows(
        1024, 3, num_dense=2, dense_nnz=500, seed=3),
        dict(slice_rows=128, tail_cap=8, split_rows=False)),
    "uniform": (lambda: random_coo(np.random.RandomState(31), 512, 512,
                                   2000), dict(slice_rows=128, tail_cap=64)),
    "length_sort": (lambda: jax_generators.power_law(2000, 8, seed=6),
                    dict(slice_rows=128, tail_cap=2048, length_sort=True,
                         split_rows=False)),
    "length_sort_split": (lambda: jax_generators.dense_rows(
        4096, 4, num_dense=3, dense_nnz=2000, seed=2),
        dict(slice_rows=256, length_sort=True)),
    "length_sort_split_cols": (lambda: jax_generators.dense_rows(
        4096, 4, num_dense=3, dense_nnz=2000, seed=2),
        dict(slice_rows=256, length_sort=True, split_cols=512)),
    "symmetric": (lambda: random_coo(np.random.RandomState(32), 200, 200,
                                     900, symmetric=True, with_dups=True),
                  dict(slice_rows=128)),
    "rectangular": (lambda: random_coo(np.random.RandomState(33), 300, 150,
                                       700), dict(slice_rows=128)),
    "f32_int64": (lambda: jax_generators.power_law(1000, 6, seed=5),
                  dict(slice_rows=128, value_dtype="float32",
                       index_dtype="int64")),
    "banded_trivial": (lambda: jax_generators.fem_mesh_2d(32), {}),
    "split_shuffled_file_order": (lambda: _jax_shuffled(
        jax_generators.dense_rows(1024, 3, num_dense=2, dense_nnz=500,
                                  seed=3)),
        dict(slice_rows=128, tail_cap=8, sort_rows=False)),
    "split_duplicates": (_long_rows_with_duplicates,
                         dict(slice_rows=128, split_cols=64)),
}


def _both(name):
    make, kw = CASES[name]
    coo = make()
    return (coo, kw, jax_sell_from_coo(coo, **kw),
            sell_from_coo(port_coo(coo), **kw))


@pytest.mark.parametrize("name", sorted(CASES))
def test_sell_from_coo_equals_jax(name):
    _, _, want, got = _both(name)
    assert_sell_equal(got, want)


def test_the_cases_cover_every_branch():
    shapes = {name: _both(name)[3] for name in CASES}
    assert shapes["power_law_tail"].tail is not None
    assert shapes["dense_rows_split"].extra_rows is not None
    assert shapes["length_sort"].row_unperm is not None
    both = shapes["length_sort_split"]
    assert both.row_unperm is not None and both.extra_rows is not None
    assert shapes["banded_trivial"].trivial_reassembly
    assert all(b.rowsize <= 128 for b in shapes["power_law_split"].buckets)
    for name in ("split_shuffled_file_order", "split_duplicates"):
        assert shapes[name].extra_rows is not None


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("with_y", [False, True])
def test_sell_spmv_equals_jax_and_the_oracle(name, with_y):
    coo, kw, jsm, sm = _both(name)
    precision = kw.get("value_dtype", "float64")
    rng = np.random.RandomState(34)
    x = rng.rand(coo.num_columns)
    y = rng.randn(coo.num_rows) if with_y else None
    dt = sm.values.dtype
    calls = []

    def counted(ell, xv, yv=None):
        calls.append(ell)
        return real(ell, xv, yv)
    real = ell_cuda.ell_spmv
    ell_cuda.ell_spmv = counted
    try:
        got = spmv(sm, torch.from_numpy(x).to(dt),
                   None if y is None else torch.from_numpy(y).to(dt))
    finally:
        ell_cuda.ell_spmv = real
    # K1 once per bucket, the whole call
    assert len(calls) == kernel_launches(sm) == len(sm.buckets)
    assert got.dtype == dt and got.shape == (coo.num_rows,)
    assert_rows_close(got.double().numpy(), coo, x, y, precision)
    want = np.asarray(jax_sell_spmv(jsm, x.astype(precision),
                                    None if y is None
                                    else y.astype(precision)), np.float64)
    assert_rows_close(want, coo, x, y, precision)
    assert_rows_close(got.double().numpy(), coo, x, y, precision, want)


@pytest.mark.parametrize("name", ["power_law_tail", "length_sort_split",
                                  "uniform", "f32_int64", "banded_trivial"])
def test_metrics_equal_jax(name):
    _, _, jsm, sm = _both(name)
    assert vars(SpmvMetrics.for_matrix(sm)) == \
        vars(JaxSpmvMetrics.for_matrix(jsm))


def test_bytes_count_every_pass():
    """sell_bytes by hand on the split and length-sorted layout: K1 per
    bucket without x, x once, the concatenation, the tile gather, the
    unpermutation, the extras' sums, y."""
    _, _, _, sm = _both("length_sort_split")
    sv, n = 8, sm.num_rows
    k1 = sum(b.rowsize * b.padded_rows * sv + b.index_bytes
             + b.num_rows * sv for b in sm.buckets)
    tiles = sum(b.num_rows for b in sm.buckets)
    extra = int(sm.extra_rows.shape[0])
    want = (k1 + sm.num_columns * sv + 2 * tiles * sv
            + 2 * tiles * sv + 8 * int(sm.order.shape[0])
            + int(sm.row_unperm.shape[0]) * (8 + 2 * sv)
            + n * sv + extra * (8 + sv) + 3 * n * sv)
    assert len(sm.buckets) > 1
    assert sell_bytes(sm, with_y=False) == want
    assert estimate_actual_bytes(sm) == want + 3 * n * sv


def _kronecker(scale: int, seed: int = 2**33 + 7) -> CooMatrix:
    """The benchmark's Graph500 Kronecker graph (``spmv_bench/generators/
    kronecker.py``), on the CPU: rows in (row, column) order, skewed
    degrees, empty rows."""
    from spmv_bench.generators import kronecker
    g = kronecker.generate({"scale": scale, "edgefactor": 16, "a": 0.57,
                            "b": 0.19, "c": 0.19}, seed, "cpu")
    return CooMatrix(g.num_rows, g.num_rows, g.rows.numpy().astype(np.int32),
                     g.cols.numpy().astype(np.int32), g.values.numpy())


def _shuffled(coo: CooMatrix, seed: int = 0) -> CooMatrix:
    p = np.random.RandomState(seed).permutation(coo.num_nonzeros)
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx[p],
                     coo.colidx[p], coo.values[p], coo.symmetry)


def _upper_symmetric(coo: CooMatrix) -> CooMatrix:
    """A symmetric matrix stored as its lower triangle."""
    keep = coo.rowidx >= coo.colidx
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx[keep],
                     coo.colidx[keep], coo.values[keep], "symmetric")


def _far_from_padding() -> CooMatrix:
    """2,048 rows of 3 entries at columns 150,000 + i .. + 2 of 200,000:
    each block of 256 rows spans 258 columns, but the padding column of
    row i (one slot in each row of the width-4 bucket) is i, so the block
    spans about 150,000 with it and the narrow layout fails through the
    padding alone."""
    rows = np.repeat(np.arange(2048), 3)
    cols = 150_000 + rows + np.tile(np.arange(3), 2048)
    return CooMatrix(2048, 200_000, rows.astype(np.int32),
                     cols.astype(np.int32), np.ones(len(rows)))


def _far_entry_first() -> CooMatrix:
    """512 rows of 4 entries, listed as every row's entry at column
    190,000 first, then every row's i, i + 1, i + 2: past a tail cap of 3,
    a row keeps i .. i + 2 by column (the narrow layout holds), but
    190,000, i, i + 1 in file order (it fails)."""
    rows = np.concatenate([np.arange(512), np.repeat(np.arange(512), 3)])
    cols = np.concatenate([np.full(512, 190_000),
                           np.repeat(np.arange(512), 3)
                           + np.tile(np.arange(3), 512)])
    return CooMatrix(512, 200_000, rows.astype(np.int32),
                     cols.astype(np.int32), np.ones(len(rows)))


def _sparse_rows() -> CooMatrix:
    """3,000 rows of which only every third holds entries (4 each), and
    rows 1, 4 and 7 with 700: empty rows beside split ones."""
    rng = np.random.RandomState(40)
    rows = np.concatenate([np.repeat(np.arange(0, 3000, 3), 4),
                           np.repeat([1, 4, 7], 700)])
    cols = rng.randint(0, 3000, len(rows))
    return CooMatrix(3000, 3000, rows.astype(np.int32), cols.astype(np.int32),
                     rng.randn(len(rows)))


# name -> (matrix, sell_from_coo keywords): the chooser's keywords are
# sort_rows and length_sort, the split's defaults
CHOOSER = dict(sort_rows=True, length_sort=True)
SHAPE_CASES = {
    **{f"jax_{name}": (lambda make=make: port_coo(make()), kw)
       for name, (make, kw) in CASES.items()},
    "kronecker_s12": (lambda: _kronecker(12), CHOOSER),
    "kronecker_s12_bands": (lambda: _kronecker(12),
                            dict(CHOOSER, split_cols=1024)),
    "kronecker_s15_bands": (lambda: _kronecker(15), CHOOSER),
    "kronecker_s12_shuffled": (lambda: _shuffled(_kronecker(12)),
                               dict(CHOOSER, split_cols=512)),
    "kronecker_s12_symmetric": (lambda: _upper_symmetric(_kronecker(12)),
                                CHOOSER),
    "kronecker_s12_f32_int32": (lambda: _kronecker(12),
                                dict(CHOOSER, value_dtype="float32",
                                     index_dtype="int32")),
    "kronecker_s12_bf16_natural": (lambda: _kronecker(12),
                                   dict(value_dtype="bfloat16")),
    "kronecker_s12_tail": (lambda: _kronecker(12),
                           dict(CHOOSER, split_rows=False, tail_cap=32)),
    "shuffled_tail_file_order": (lambda: _shuffled(power_law(3000, 8,
                                                             seed=1)),
                                 dict(slice_rows=256, tail_cap=16,
                                      sort_rows=False, split_rows=False,
                                      length_sort=True)),
    "shuffled_tail_by_column": (lambda: _shuffled(power_law(3000, 8,
                                                            seed=1)),
                                dict(slice_rows=256, tail_cap=16,
                                     split_rows=False)),
    "shuffled_many_long_entries": (lambda: _shuffled(dense_rows(
        4096, 4, num_dense=200, dense_nnz=1000, seed=5)), CHOOSER),
    "tail_by_column_narrow": (lambda: _far_entry_first(),
                              dict(slice_rows=256, tail_cap=3,
                                   split_rows=False)),
    "tail_file_order_wide": (lambda: _far_entry_first(),
                             dict(slice_rows=256, tail_cap=3,
                                  sort_rows=False, split_rows=False)),
    "banded_narrow": (lambda: banded_random(5000, 8, 100, seed=1),
                      dict(slice_rows=256)),
    "wide_by_padding": (lambda: _far_from_padding(), dict(slice_rows=256)),
    "sparse_rows_split": (lambda: _sparse_rows(), dict(CHOOSER,
                                                       slice_rows=128)),
    "sparse_rows_natural": (lambda: _sparse_rows(), dict(slice_rows=128)),
}


@pytest.mark.parametrize("name", sorted(SHAPE_CASES))
def test_sell_shape_equals_the_built_shape(name):
    """`sell_shape` without a build gives the built split's shape field
    for field, and so the same bytes and price to the bit."""
    make, kw = SHAPE_CASES[name]
    coo = make()
    built = sell_from_coo(coo, **kw)
    shape = sell_shape(coo, **kw)
    assert shape == built.shape
    geometry = (3.35e12, *config.k1_geometry("cpu"))
    assert sell_seconds(shape, *geometry) == sell_seconds(built, *geometry)
    assert sell_bytes(shape) == sell_bytes(built)
    if name in ("banded_narrow", "tail_by_column_narrow"):
        assert all(b.lcol is not None for b in built.buckets)
    if name == "tail_file_order_wide":
        assert all(b.lcol is None for b in built.buckets)
    if name == "wide_by_padding":
        (bucket,) = built.buckets
        assert bucket.lcol is None
        # the entries alone would take the narrow layout
        assert narrow_bases(coo.rowidx // LBLOCK,
                            coo.colidx.astype(np.int64), 8) is not None
    if name.startswith("kronecker_s15"):
        # rows split across the column bands of 8,192
        assert coo.num_columns >= 4 * 8192 and shape.extra_rows
    if name == "sparse_rows_split":
        assert shape.extra_rows and shape.unperm_rows


def _blowup_rows():
    """20,000 rows of one entry and one of 300: ELLPACK would hold 6M
    slots for 20,299 nonzeros."""
    n = 20_000
    rows = np.concatenate([np.arange(n), np.zeros(299, np.int64)])
    cols = np.concatenate([np.arange(n), np.arange(1, 300)])
    return CooMatrix(n, n, rows.astype(np.int32), cols.astype(np.int32),
                     np.ones(len(rows)))


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_chooser_takes_the_stream_as_jax_does(precision, monkeypatch):
    # power_law(20,000, 8): random hub columns, no locality to keep; both
    # choosers take the stream format, the port by bytes
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    coo = jax_generators.power_law(20_000, 8, seed=0)
    want = jax_auto_from_coo(coo, value_dtype=precision)
    got = auto_from_coo(port_coo(coo), value_dtype=precision)
    assert want._auto_choice == got._auto_choice == "stream"
    assert isinstance(got, StreamMatrix)
    assert got._auto_reason.startswith("ELL padding blowup (")
    assert "; stream (" in got._auto_reason and \
        ") < SELL split (" in got._auto_reason


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_chooser_takes_the_stream_at_dense_rows_as_jax_does(precision,
                                                            monkeypatch):
    """dense_rows(100,000, 8, 16, 12,500), the suite's config-dense-rows at
    a tenth: the SELL split moves fewer bytes than the stream format, but
    its sub-row buckets (a few thousand rows of up to 128 slots) are short
    K1 launches, priced by their rounds of loads (ROADMAP F8), so the port
    takes the stream format, as JAX does by its v5e prices. At full width
    the card ran the stream format faster in both types (NVIDIA H100 80GB
    HBM3, 700 W: fp64 0.1359 ms against SELL's 0.1905, f32 0.0899 against
    0.1156, in a CUDA graph)."""
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    monkeypatch.setenv("HBM_PEAK_GBPS", "3350")
    coo = jax_generators.dense_rows(100_000, 8, num_dense=16,
                                    dense_nnz=12_500, seed=0)
    want = jax_auto_from_coo(coo, value_dtype=precision, sort_rows=True)
    got = auto_from_coo(port_coo(coo), value_dtype=precision)
    assert want._auto_choice == got._auto_choice == "stream"
    assert isinstance(got, StreamMatrix)
    # the SELL it weighed is --format=sell's, priced by its geometry
    sell = sell_from_coo(port_coo(coo), sort_rows=True, length_sort=True,
                         value_dtype=precision)
    assert_sell_equal(sell, jax_sell_from_coo(coo, sort_rows=True,
                                              length_sort=True,
                                              value_dtype=precision))
    bytes_ms = sell_bytes(sell, with_y=False) / 3.35e12 * 1e3
    priced_ms = sell_seconds(sell, 3.35e12, *config.k1_geometry("cpu")) * 1e3
    assert priced_ms > 4 * bytes_ms
    assert got._auto_reason.endswith(
        f") < SELL split (est {priced_ms:.3f} ms)")
    x = np.random.RandomState(35).rand(coo.num_columns)
    out = spmv(got, torch.from_numpy(x).to(got.values.dtype))
    assert_rows_close(out.double().numpy(), coo, x, None, precision)


def _price_by_bytes(monkeypatch):
    """K1's rounds cost nothing: the chooser prices by bytes alone, as on
    a card whose short launches hide their rounds."""
    monkeypatch.setitem(config.K1_ROUND_SECONDS, config.HOST_PRICED_CARD,
                        0.0)


def test_chooser_builds_the_sell_on_the_host(monkeypatch):
    """Only the chosen matrix reaches `device`: the SELL split is built and
    priced on the host, then moved (priced by bytes, where it wins)."""
    _price_by_bytes(monkeypatch)
    coo = port_coo(jax_generators.dense_rows(100_000, 8, num_dense=16,
                                             dense_nnz=12_500, seed=0))
    got = auto_from_coo(coo, value_dtype="float64", device="meta")
    assert got._auto_choice == "sell" and got.device.type == "meta"
    assert all(b.values.device.type == "meta" for b in got.buckets)


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def skewed(tmp_path):
    """A file of 3,000 rows of 4 entries and 3 of 600, small integer
    values: every sum is exact, in the JAX package's arithmetic as in
    fp64."""
    rng = np.random.RandomState(36)
    coo = jax_generators.dense_rows(3000, 4, num_dense=3, dense_nnz=600,
                                    seed=4)
    coo.values = rng.randint(-5, 6, coo.num_nonzeros).astype(np.float64)
    path = str(tmp_path / "skewed.mtx")
    write_matrix(path, coo)
    return path, coo


@pytest.mark.parametrize("flags", [
    ["--format=sell"], ["--format=sell", "--repeat=2"],
    ["--format=sell", "--precision=float32"],
    ["--format=sell", "--index-width=64"],
])
def test_sell_stdout_identical_to_jax(flags, skewed, capsys):
    path, coo = skewed
    rc_j, out_j, err_j = run(jax_ellspmv.main, flags + [path], capsys)
    rc_p, out_p, err_p = run(ellspmv.main, ["--device=cpu", "-v"] + flags
                             + [path], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j
    calls = 2 if "--repeat=2" in flags else 1
    np.testing.assert_array_equal(
        read_vector(io.BytesIO(out_p.encode())),
        calls * coo_spmv_numpy(coo, np.ones(coo.num_columns)))
    assert "sell_from_coo:" in err_p and " slice buckets" in err_p
    assert err_p.count("gemv_sell:") == calls


def test_sell_ignores_a_separate_diagonal(skewed, capsys):
    path, _ = skewed
    rc, out, err = run(ellspmv.main, ["--device=cpu", "-v", "--format=sell",
                                      "--separate-diagonal", path], capsys)
    assert rc == 0
    assert "note: --format=sell stores the diagonal inline" in err
    assert out == run(jax_ellspmv.main, ["--format=sell", path], capsys)[1]


def test_auto_chooses_sell_in_the_program(tmp_path, monkeypatch, capsys):
    # where the SELL split's price is the lower (here by bytes alone:
    # priced by its rounds the stream format wins, as above)
    _price_by_bytes(monkeypatch)
    coo = jax_generators.dense_rows(100_000, 8, num_dense=16,
                                    dense_nnz=12_500, seed=0)
    path = str(tmp_path / "dense_rows.mtx")
    write_matrix(path, coo)
    rc, out, err = run(ellspmv.main, ["--device=cpu", "--format=auto", "-v",
                                      path], capsys)
    assert rc == 0, err
    assert "auto_from_coo [sell]:" in err and "ELL padding blowup" in err
    assert err.count("gemv_sell:") == 1
    assert_rows_close(read_vector(io.BytesIO(out.encode())), coo,
                      np.ones(coo.num_columns), None, "float64")
