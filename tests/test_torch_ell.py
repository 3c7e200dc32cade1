"""`ell_spmv` (the plain PyTorch version, which the wrapper runs for CPU
tensors) against the NumPy oracle and against the JAX package's Pallas
kernel K1 (`ell_spmv_pallas`, in interpret mode on the CPU), on identical
ELLPACK data carried across with `ell_from_jax_arrays`; and the FMA probe's
plain version against the JAX probe's inputs and exact residual. The CUDA
kernels are held against the same plain versions on the card
(``chip_smoke.py``)."""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.models.generators import banded_random, poisson2d
from ellspmv_tpu.ops.ell_pallas import _two_prod, ell_spmv_pallas, get_plan
from ellspmv_tpu_torch.formats.ell import ell_from_jax_arrays
from ellspmv_tpu_torch.ops.dispatch import spmv
from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv, fma_probe
from ellspmv_tpu_torch.ops.ell_cuda import probe_inputs as fma_probe_inputs
from ellspmv_tpu_torch.ops.reference import ell_spmv_numpy
from tests.conftest import assert_fp64_close, random_coo

TORCH_DTYPE = {"float64": torch.float64, "float32": torch.float32,
               "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float64": np.float64, "float32": np.float32,
             "bfloat16": ml_dtypes.bfloat16}

# name -> (matrix, separate_diagonal, accumulate into y)
CASES = {
    "poisson2d": (lambda: poisson2d(24), False, False),
    "banded": (lambda: banded_random(400, 5, 32), False, False),
    "rectangular": (lambda: random_coo(np.random.RandomState(0), 150, 100,
                                       400), False, False),
    "separate_diagonal": (lambda: banded_random(300, 5, 40, seed=5), True,
                          False),
    "y_accumulate": (lambda: banded_random(300, 5, 40, seed=5), True, True),
}


@functools.cache
def _case(name: str, precision: str):
    """The JAX matrix, the port's copy of it, x and y (numpy, fp64)."""
    make, sep_diag, with_y = CASES[name]
    jell = jax_ell_from_coo(make(), sort_rows=True,
                            separate_diagonal=sep_diag,
                            value_dtype=JAX_DTYPE[precision])
    pell = ell_from_jax_arrays(np.asarray(jell.colidx),
                               np.asarray(jell.values),
                               None if jell.diag is None
                               else np.asarray(jell.diag),
                               jell.num_rows, jell.num_columns,
                               jell.num_nonzeros)
    x = np.random.RandomState(7).rand(jell.num_columns)
    y = np.random.RandomState(11).randn(jell.num_rows) if with_y else None
    return jell, pell, x, y


def _port(pell, x, y, precision):
    dt = TORCH_DTYPE[precision]
    out = ell_spmv(pell, torch.from_numpy(x).to(dt),
                   None if y is None else torch.from_numpy(y).to(dt))
    assert out.dtype == dt and out.shape == (pell.num_rows,)
    return out.double().numpy()


def _jax(jell, x, y, precision):
    assert get_plan(jell) is not None
    xj = x.astype(JAX_DTYPE[precision])
    yj = None if y is None else y.astype(JAX_DTYPE[precision])
    return np.asarray(ell_spmv_pallas(jell, xj, yj)).astype(np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp64_against_oracle(name):
    _, pell, x, y = _case(name, "float64")
    got = _port(pell, x, y, "float64")
    assert_fp64_close(got, ell_spmv_numpy(pell, x, y))
    # the dispatch takes the same path
    assert_fp64_close(spmv(pell, torch.from_numpy(x),
                           None if y is None else torch.from_numpy(y)).numpy(),
                      got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp64_against_jax_kernel(name):
    # JAX fp64 is double-double on the TPU path, even in interpret mode
    jell, pell, x, y = _case(name, "float64")
    got, want = _port(pell, x, y, "float64"), _jax(jell, x, y, "float64")
    scale = max(np.max(np.abs(want)), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_against_jax_kernel(name):
    jell, pell, x, y = _case(name, "float32")
    got, want = _port(pell, x, y, "float32"), _jax(jell, x, y, "float32")
    scale = max(np.max(np.abs(want)), 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def test_fma_probe_against_jax():
    # The port's probe inputs are the JAX probe's, and the plain version of
    # the probe kernel gives the exact residual that the JAX probe demands
    # (ell_pallas.py:169-170) and that JAX's Dekker two_prod computes.
    a, b = fma_probe_inputs("cpu")
    rng = np.random.RandomState(0)
    a_np = rng.uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    b_np = rng.uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    np.testing.assert_array_equal(a.numpy(), a_np)
    np.testing.assert_array_equal(b.numpy(), b_np)
    got = fma_probe(a, b).numpy()
    exact = (a_np.astype(np.float64) * b_np.astype(np.float64)
             - (a_np * b_np).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, exact)
    assert np.any(exact != 0)
    _, err = _two_prod(jnp.asarray(a_np), jnp.asarray(b_np))
    np.testing.assert_array_equal(got, np.asarray(err))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_against_jax_kernel(name):
    # Both round values and the result to bf16; the JAX epilogue adds the
    # diagonal and y in bf16, the port in f32. Compared in f32.
    jell, pell, x, y = _case(name, "bfloat16")
    got = _port(pell, x, y, "bfloat16").astype(np.float32)
    want = _jax(jell, x, y, "bfloat16").astype(np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * scale)


# --------------------------------------------------------------------------
# The narrow column layout (lbase + 16-bit lcol)
# --------------------------------------------------------------------------

def _block_coo(first_col: int, short_row: int | None):
    """256 rows, row i with columns first_col + i and first_col + i + 1;
    `short_row` (if any) keeps one entry, so that it gets a padding slot
    of column min(i, m - 1)."""
    rows = np.repeat(np.arange(256), 2)
    cols = first_col + rows + np.tile([0, 1], 256)
    keep = np.ones(len(rows), bool)
    if short_row is not None:
        keep[2 * short_row + 1] = False
    return port_coo_of(256, first_col + 300, rows[keep], cols[keep])


def port_coo_of(n, m, rows, cols):
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    return CooMatrix(n, m, rows.astype(np.int32), cols.astype(np.int32),
                     np.random.RandomState(0).randn(len(rows)))


# name -> (COO factory, narrow)
NARROW_RULE_CASES = {
    # a band: each block of 256 rows spans a few hundred columns
    "banded": (lambda: port_coo_of(
        1000, 1000, *np.nonzero(np.abs(np.subtract.outer(
            np.arange(1000), np.arange(1000))) <= 3)), True),
    # one block whose entries span 65,535 columns, then 65,536
    "span_65535": (lambda: port_coo_of(
        256, 70_000, np.array([0, 1]), np.array([0, 65_535])), True),
    "span_65536": (lambda: port_coo_of(
        256, 70_000, np.array([0, 1]), np.array([0, 65_536])), False),
    # entries far right of the diagonal: narrow while every row is full,
    # wide once a short row's padding slot (column 5) widens the block
    "full_rows_far_right": (lambda: _block_coo(66_000, None), True),
    "padding_widens": (lambda: _block_coo(66_000, 5), False),
}


@pytest.mark.parametrize("name", sorted(NARROW_RULE_CASES))
def test_narrow_rule_from_coo_matches_the_built_layout(name):
    from ellspmv_tpu_torch.formats.ell import ell_from_coo, narrow_columns_fit
    make, narrow = NARROW_RULE_CASES[name]
    coo = make()
    ell = ell_from_coo(coo)
    assert (ell.lcol is not None) == narrow
    assert narrow_columns_fit(coo.rowidx, coo.colidx, coo.num_rows,
                              coo.num_columns, ell.rowsize) == narrow
    if narrow:
        assert torch.equal(ell.columns(), ell.colidx)
        assert ell.index_bytes == 2 * ell.lcol.numel() + 4 * len(ell.lbase)
    else:
        assert ell.lbase is None and ell.lcol is None
        assert ell.index_bytes == 4 * ell.colidx.numel()


@pytest.mark.parametrize("index_dtype", ["int32", "int64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_narrow_encoding_round_trips_to_colidx(name, index_dtype):
    from ellspmv_tpu_torch.formats.ell import LBLOCK, ell_from_coo
    make, sep_diag, _ = CASES[name]
    ell = ell_from_coo(port_coo_of_jax(make()), sort_rows=True,
                       separate_diagonal=sep_diag, index_dtype=index_dtype)
    assert ell.lcol is not None and ell.lcol.dtype == torch.int16
    assert ell.lcol.shape == ell.colidx.shape and ell.lcol.is_contiguous()
    assert ell.lbase.dtype == ell.colidx.dtype
    assert ell.lbase.shape == (-(-ell.padded_rows // LBLOCK),)
    assert torch.equal(ell.columns(), ell.colidx)
    # each base is its block's least column
    blocks = torch.nn.functional.pad(
        ell.colidx, (0, len(ell.lbase) * LBLOCK - ell.padded_rows),
        value=2**31 - 1).view(ell.rowsize, -1, LBLOCK)
    assert torch.equal(blocks.amin(dim=(0, 2)), ell.lbase)
    moved = ell.to("cpu")
    assert torch.equal(moved.lcol, ell.lcol)
    assert torch.equal(moved.lbase, ell.lbase)


def port_coo_of_jax(coo):
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     coo.values, coo.symmetry, coo.field)


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("precision", ["float64", "float32", "bfloat16"])
def test_plain_on_narrow_layout_against_jax_kernel(precision, index_dtype):
    """The plain version decodes lbase + lcol; against the JAX kernel on the
    same arrays, at the tolerances of the tests above."""
    jell = jax_ell_from_coo(banded_random(600, 7, 40, seed=3),
                            sort_rows=True, separate_diagonal=True,
                            index_dtype=index_dtype,
                            value_dtype=JAX_DTYPE[precision])
    pell = ell_from_jax_arrays(np.asarray(jell.colidx),
                               np.asarray(jell.values), np.asarray(jell.diag),
                               jell.num_rows, jell.num_columns,
                               jell.num_nonzeros)
    assert pell.lcol is not None
    assert pell.lbase.dtype == torch.from_numpy(
        np.zeros(0, index_dtype)).dtype
    x = np.random.RandomState(7).rand(jell.num_columns)
    y = np.random.RandomState(11).randn(jell.num_rows)
    got = _port(pell, x, y, precision).astype(np.float32 if precision ==
                                              "bfloat16" else np.float64)
    want = _jax(jell, x, y, precision)
    tol = {"float64": 1e-12, "float32": 2e-5, "bfloat16": 1e-2}[precision]
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want.astype(got.dtype), rtol=tol,
                               atol=tol * scale)


# -- the sliced layout --------------------------------------------------------

def _sliced_everywhere(monkeypatch):
    """Make the whole-matrix ELLPACK take the sliced layout on the CPU too,
    as it does on a card, so that its build runs here."""
    from ellspmv_tpu_torch.formats import ell as ell_mod
    monkeypatch.setattr(ell_mod, "_slices_on", lambda device: True)


# name -> (rows' entry counts from a RandomState, padded_rows)
PLAN_CASES = {
    "poisson": (lambda rng: rng.poisson(15.8, 3000), 3000),
    "power_law": (lambda rng: np.minimum(
        (rng.pareto(1.5, 2048) * 4).astype(np.int64), 900), 2048),
    "empty_rows": (lambda rng: rng.poisson(3, 1000) * (rng.rand(1000) < .6),
                   1000),
    "odd_rows": (lambda rng: rng.randint(0, 40, 1533), 1536),
    "one_window": (lambda rng: rng.randint(1, 9, 72), 72),
    "equal": (lambda rng: np.full(640, 7), 640),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_slice_plan_orders_rows_within_windows(name):
    """`slice_plan`: each window's rows in a stable order by count, longest
    first, every row of the window once; each slice as wide as its longest
    row and placed after the one before; the slots stored the widths times
    the slice's rows, as counted from the rows' counts alone."""
    from ellspmv_tpu_torch.formats.ell import (SLICE_ROWS, SLICE_WINDOW,
                                               slice_plan, sliced_slots)
    make, p = PLAN_CASES[name]
    counts = make(np.random.RandomState(1)).astype(np.int64)
    padded = np.zeros(p, np.int64)
    padded[:len(counts)] = counts
    c = SLICE_ROWS
    rows, width, start = slice_plan(counts, p)
    assert rows.dtype == np.int16 and width.dtype == np.int32
    assert start.dtype == np.int64 and len(rows) == p
    assert len(width) == len(start) == -(-p // c)
    row = np.arange(p) // SLICE_WINDOW * SLICE_WINDOW + rows
    assert np.array_equal(np.sort(row), np.arange(p))
    for w0 in range(0, p, SLICE_WINDOW):
        w = slice(w0, min(w0 + SLICE_WINDOW, p))
        want = w0 + np.argsort(-padded[w], kind="stable")
        assert np.array_equal(row[w], want)
    held = np.zeros(len(width) * c, np.int64)
    held[:p] = padded[row]
    assert np.array_equal(width, held.reshape(-1, c).max(axis=1))
    assert np.array_equal(start, np.r_[0, np.cumsum(width * c)[:-1]])
    # the slots, from the counts sorted in each window
    by_window = np.zeros(-(-p // SLICE_WINDOW) * SLICE_WINDOW, np.int64)
    by_window[:p] = padded
    ranked = -np.sort(-by_window.reshape(-1, SLICE_WINDOW), axis=1)
    assert sliced_slots((rows, width, start)) == c * int(
        ranked.ravel()[:p:c].sum())


def _sliced_cases():
    from ellspmv_tpu_torch.models.generators import power_law
    from torch_cases import geometric_coo, random_coo
    rng = np.random.RandomState(4)
    return {
        "power_law": (lambda: power_law(3000, 8, seed=2), {}),
        "geometric": (lambda: geometric_coo(12, empty_row=100),
                      {"sort_rows": True}),
        "banded_diag": (lambda: port_coo_of_jax(
            banded_random(1533, 7, 40, seed=5)),
            {"separate_diagonal": True, "sort_rows": True}),
        "wide": (lambda: random_coo(rng, 2100, 300_000, 20_000), {}),
        "empty_rows": (lambda: port_coo_of(
            1000, 900, np.repeat(np.arange(0, 1000, 3), 5)[:1500],
            np.random.RandomState(3).randint(0, 900, 1500)), {}),
        "int64_f32": (lambda: power_law(1100, 6, seed=7),
                      {"index_dtype": "int64", "value_dtype": "float32"}),
        "bf16": (lambda: power_law(700, 6, seed=8),
                 {"value_dtype": "bfloat16"}),
    }


@pytest.mark.parametrize("name", sorted(_sliced_cases()))
def test_sliced_layout_keeps_every_rows_slots(name, monkeypatch):
    """The sliced layout against the padded one built from the same COO:
    slot s of each position's row at ``start + s * rows + i % rows`` for s
    below its slice's width, the same column (decoded from the narrow
    layout where it has one) and value; its narrow layout's bases each
    their block of positions' least column; fewer slots stored; laid back
    into the padded layout, the padded arrays bit for bit; and the same
    y, bit for bit."""
    from ellspmv_tpu_torch.formats.ell import (LBLOCK, SLICE_ROWS,
                                               SLICE_WINDOW, ell_from_coo)
    make, kw = _sliced_cases()[name]
    coo = make()
    padded = ell_from_coo(coo, **kw)
    _sliced_everywhere(monkeypatch)
    ell = ell_from_coo(coo, **kw)
    sl = ell.slices
    assert padded.slices is None and sl is not None
    assert (ell.rowsize, ell.padded_rows, ell.num_rows) == (
        padded.rowsize, padded.padded_rows, padded.num_rows)
    assert sl.stored < padded.values.numel()
    assert ell.values.shape == ell.colidx.shape == (sl.stored,)
    assert (ell.lcol is None) == (name == "wide")
    rows, width, start = (t.numpy() for t in (sl.rows, sl.width, sl.start))
    pos = np.arange(ell.padded_rows)
    row = pos // SLICE_WINDOW * SLICE_WINDOW + rows
    cols = ell.colidx.numpy().astype(np.int64)
    if ell.lcol is not None:
        block = np.empty(sl.stored, np.int64)
        for j in range(len(width)):
            block[start[j]:start[j] + width[j] * SLICE_ROWS] = \
                j * SLICE_ROWS // LBLOCK
        decoded = ell.lbase.numpy().astype(np.int64)[block] \
            + ell.lcol.numpy().view(np.uint16)
    want_c, want_v = padded.colidx.numpy(), padded.values
    got_v = ell.values
    for s in range(ell.rowsize):
        live = pos[width[pos // SLICE_ROWS] > s]
        dest = start[live // SLICE_ROWS] + s * SLICE_ROWS \
            + live % SLICE_ROWS
        assert np.array_equal(cols[dest], want_c[s, row[live]])
        assert torch.equal(got_v[dest], want_v[s, row[live]])
        if ell.lcol is not None:
            assert np.array_equal(decoded[dest], want_c[s, row[live]])
        # the slots dropped are padding: value 0, past the row's entries
        gone = pos[width[pos // SLICE_ROWS] <= s]
        assert not want_v[s, row[gone]].any()
    if ell.lcol is not None:
        lo = np.full(len(ell.lbase), np.iinfo(np.int64).max)
        np.minimum.at(lo, block, decoded)
        assert np.array_equal(ell.lbase.numpy()[lo < 2**62],
                              lo[lo < 2**62])
    back = ell.padded()
    assert torch.equal(back.colidx, padded.colidx)
    assert torch.equal(back.values, padded.values)
    assert torch.equal(ell.columns(), padded.colidx)
    if padded.diag is not None:
        assert torch.equal(ell.diag, padded.diag)
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.rand(coo.num_columns)).to(ell.values.dtype)
    y = torch.from_numpy(rng.randn(coo.num_rows)).to(ell.values.dtype)
    assert torch.equal(ell_spmv(ell, x, y), ell_spmv(padded, x, y))
    assert torch.equal(ell_spmv(ell, x), ell_spmv(padded, x))
    np.testing.assert_array_equal(
        ell_spmv_numpy(ell, x.double().numpy(), y.double().numpy()),
        ell_spmv_numpy(padded, x.double().numpy(), y.double().numpy()))
    moved = ell.to("cpu")
    assert moved.slices is not None and torch.equal(moved.values, ell.values)


def test_sliced_layout_holds_the_jax_packages_arrays(monkeypatch):
    """The host packing is the JAX package's whether or not the matrix is
    then sliced: the sliced matrix laid back into the padded layout holds
    the JAX package's colidx, values and diagonal, bit for bit, and the
    plain version gives the JAX kernel's y."""
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    coo = banded_random(1000, 9, 60, seed=2)
    jell = jax_ell_from_coo(coo, sort_rows=True, separate_diagonal=True,
                            value_dtype=np.float64)
    _sliced_everywhere(monkeypatch)
    ell = ell_from_coo(port_coo_of_jax(coo), sort_rows=True,
                       separate_diagonal=True, value_dtype="float64")
    assert ell.slices is not None
    back = ell.padded()
    np.testing.assert_array_equal(back.colidx.numpy(),
                                  np.asarray(jell.colidx).T)
    np.testing.assert_array_equal(back.values.numpy(),
                                  np.asarray(jell.values).T)
    np.testing.assert_array_equal(ell.diag.numpy(), np.asarray(jell.diag))
    x = np.random.RandomState(7).rand(jell.num_columns)
    assert_fp64_close(_port(ell, x, None, "float64"),
                      _jax(jell, x, None, "float64"))


def test_equal_rows_are_not_sliced(monkeypatch):
    """A matrix whose rows all hold the same count stores no fewer slots in
    slices: it keeps the padded layout, and so does a SELL bucket."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.formats.ell import (ell_from_coo, slice_plan,
                                               sliced_slots,
                                               whole_matrix_plan)
    from ellspmv_tpu_torch.utils import timing
    n, k = 1000, 7
    rows = np.repeat(np.arange(n), k).astype(np.int32)
    cols = ((rows.astype(np.int64) * 13 + np.tile(np.arange(k), n) * 101)
            % n).astype(np.int32)
    coo = CooMatrix(n, n, rows, cols, np.random.RandomState(0).rand(n * k))
    counts = np.full(n, k)
    assert sliced_slots(slice_plan(counts, n)) >= n * k
    assert whole_matrix_plan(counts, n, k) is None
    _sliced_everywhere(monkeypatch)
    with timing.recording() as rec:
        ell = ell_from_coo(coo)
    assert ell.slices is None and ell.values.shape == (k, n)
    (build,) = rec.find("formats.build.ell")
    assert build.attrs["sliced"] is False
    assert build.attrs["slots"] == build.attrs["padded_slots"] == n * k


def test_other_paths_keep_the_padded_layout(monkeypatch):
    """Where the whole matrix is sliced, the SELL buckets, the hybrid's
    parts, the stream format's products, the CSR's sliced-ELL repack and
    the shards over ranks (built from the sliced matrix) keep the padded
    layout, each through its own constructor."""
    from ellspmv_tpu_torch.formats.csr import csr_from_coo
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.formats.hybrid import hybrid_from_coo
    from ellspmv_tpu_torch.formats.sell import sell_from_coo
    from ellspmv_tpu_torch.formats.stream import stream_from_coo
    from ellspmv_tpu_torch.models.generators import power_law
    from ellspmv_tpu_torch.ops.csr import to_sell
    from ellspmv_tpu_torch.parallel.spmv import shard_matrix
    _sliced_everywhere(monkeypatch)
    coo = power_law(3000, 8, seed=2)
    whole = ell_from_coo(coo, sort_rows=True)
    assert whole.slices is not None
    sell = sell_from_coo(coo, sort_rows=True, length_sort=True)
    hybrid = hybrid_from_coo(coo)
    stream = stream_from_coo(coo)
    sharded = shard_matrix(whole, 3)
    padded = [*sell.buckets, *hybrid.rest.buckets,
              *([] if hybrid.hub is None else hybrid.hub.buckets),
              stream.prod, *to_sell(csr_from_coo(coo)).buckets,
              *(s.matrix for s in sharded.shards)]
    assert len(padded) > 6
    assert all(e.slices is None and e.values.dim() == 2 for e in padded)
    monkeypatch.undo()
    want = shard_matrix(ell_from_coo(coo, sort_rows=True), 3)
    for a, b in zip(sharded.shards, want.shards):
        assert torch.equal(a.matrix.colidx, b.matrix.colidx)
        assert torch.equal(a.matrix.values, b.matrix.values)


def test_sliced_bytes_count_the_slices():
    """`estimate_actual_bytes` of a sliced ELL: the slots stored, their
    columns at the width K1 reads them, each slice's width and offset and
    each position's row id, x, y and the output; below the padded
    layout's."""
    from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
    from ellspmv_tpu_torch.formats import ell as ell_mod
    from ellspmv_tpu_torch.models.generators import power_law
    coo = power_law(3000, 8, seed=2)
    padded = ell_mod.ell_from_coo(coo)
    counts = np.bincount(coo.rowidx, minlength=coo.num_rows)
    plan = ell_mod.whole_matrix_plan(counts, padded.padded_rows,
                                     padded.rowsize)
    rows_major = (padded.colidx.t(), padded.values.t())
    ell = ell_mod._sliced(*rows_major, None, padded.num_rows,
                          padded.num_columns, padded.num_nonzeros,
                          torch.float64, tuple(map(torch.from_numpy, plan)))
    sl, n, p = ell.slices, ell.num_rows, ell.padded_rows
    assert ell.lcol is not None
    table = 4 * len(sl.width) + 8 * len(sl.start) + 2 * p
    want = (8 * sl.stored + 2 * sl.stored + 4 * len(ell.lbase) + table
            + 8 * coo.num_columns + 2 * 8 * n)
    assert estimate_actual_bytes(ell) == want
    assert estimate_actual_bytes(ell, with_y=False) == want - 8 * n
    assert want < estimate_actual_bytes(padded)
