"""The port's CSR format, its SpMV and the `csrspmv` program against the JAX
package's on the same seeded inputs: `csr_from_coo` field for field, the
segment sum and the sliced-ELL route (K1's plain version on the CPU)
against JAX's ``csr_spmv_xla`` and ``csr_spmv_pallas`` (run as
tests/test_sell.py runs it) and the NumPy oracle, the metrics, and the
program's stdout, labels and refusals. Tolerances, per row relative to
sum |a*x| + |y|: fp64 1e-13, f32 1e-5. The ``cuda`` tests hold the kernel
route against the plain one on a card."""

import io

import numpy as np
import pytest
import torch

from ellspmv_tpu.bench.harness import SpmvMetrics as JaxSpmvMetrics
from ellspmv_tpu.cli import csrspmv as jax_csrspmv
from ellspmv_tpu.formats.csr import csr_from_coo as jax_csr_from_coo
from ellspmv_tpu.io.mtx import read_vector, write_matrix
from ellspmv_tpu.models.generators import fem_mesh_2d
from ellspmv_tpu.ops.csr_pallas import _to_sell as jax_to_sell
from ellspmv_tpu.ops.csr_pallas import csr_spmv_pallas
from ellspmv_tpu.ops.csr_xla import csr_spmv_xla
from ellspmv_tpu.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.bench.harness import SpmvMetrics
from ellspmv_tpu_torch.bench.traffic import csr_bytes, sell_bytes
from ellspmv_tpu_torch.cli import csrspmv
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.csr import (CsrMatrix, csr_from_coo,
                                           csr_from_jax_arrays)
from ellspmv_tpu_torch.ops import ell_cuda
from ellspmv_tpu_torch.ops.csr import csr_spmv_segment, to_sell
from ellspmv_tpu_torch.ops.dispatch import spmv
from tests.conftest import random_coo

TOLERANCE = {"float64": 1e-13, "float32": 1e-5}
EXAMPLES = ["examples/test.mtx", "examples/test_spd.mtx"]


def port_coo(coo) -> CooMatrix:
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     coo.values, coo.symmetry, coo.field)


def assert_rows_close(got, coo, x, y, precision, want=None):
    """got against `want` (default: the oracle), each row relative to
    sum |a*x| + |y|."""
    if want is None:
        want = coo_spmv_numpy(coo, x, y)
    scale = coo_spmv_numpy(
        CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                  np.abs(coo.values), coo.symmetry), np.abs(x),
        None if y is None else np.abs(y))
    err = np.abs(np.asarray(got, np.float64) - want) / np.maximum(scale,
                                                                  1e-300)
    assert err.max(initial=0.0) <= TOLERANCE[precision]


# name -> (matrix, csr_from_coo keywords)
CASES = {
    "general": (lambda: random_coo(np.random.RandomState(1), 60, 60, 400,
                                   with_dups=True), {}),
    "sorted": (lambda: random_coo(np.random.RandomState(2), 60, 60, 400),
               {"sort_rows": True}),
    "symmetric": (lambda: random_coo(np.random.RandomState(3), 50, 50, 300,
                                     symmetric=True, with_dups=True),
                  {"sort_rows": True}),
    "rectangular": (lambda: random_coo(np.random.RandomState(4), 70, 40,
                                       300), {}),
    "separate_diagonal": (lambda: random_coo(np.random.RandomState(5), 60,
                                             60, 500, with_dups=True),
                          {"separate_diagonal": True}),
    "rectangular_separate_diagonal": (
        lambda: random_coo(np.random.RandomState(6), 40, 70, 300),
        {"separate_diagonal": True}),
    "int64_f32": (lambda: random_coo(np.random.RandomState(7), 60, 60, 400),
                  {"index_dtype": "int64", "value_dtype": "float32",
                   "sort_rows": True}),
    "empty_rows": (lambda: random_coo(np.random.RandomState(8), 200, 30,
                                      40), {}),
}


def _both(name):
    make, kw = CASES[name]
    coo = make()
    return coo, kw, jax_csr_from_coo(coo, **kw), csr_from_coo(port_coo(coo),
                                                              **kw)


def assert_csr_equal(got: CsrMatrix, want):
    for field in ("rowptr", "colidx", "values", "rowids", "diag"):
        w, g = getattr(want, field), getattr(got, field)
        assert (w is None) == (g is None), field
        if w is not None:
            w = np.asarray(w)
            assert g.numpy().dtype == w.dtype, field
            np.testing.assert_array_equal(g.numpy(), w, err_msg=field)
    for attr in ("num_rows", "num_columns", "num_nonzeros", "csrsize",
                 "diagsize", "rowsize_min", "rowsize_max"):
        assert getattr(got, attr) == getattr(want, attr), attr


@pytest.mark.parametrize("name", sorted(CASES))
def test_csr_from_coo_equals_jax(name):
    _, _, want, got = _both(name)
    assert_csr_equal(got, want)


def test_csr_from_jax_arrays_round_trip():
    _, _, want, _ = _both("separate_diagonal")
    got = csr_from_jax_arrays(want.rowptr, want.colidx, want.values,
                              want.rowids, want.diag, want.num_rows,
                              want.num_columns, want.num_nonzeros)
    assert_csr_equal(got, want)


def test_diagonal_split_only_when_square():
    _, _, _, square = _both("separate_diagonal")
    _, _, _, rect = _both("rectangular_separate_diagonal")
    assert square.diag is not None and square.diagsize == 60
    assert rect.diag is None and rect.diagsize == 0


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("with_y", [False, True])
def test_segment_sum_equals_jax_and_the_oracle(name, with_y):
    coo, kw, jcsr, csr = _both(name)
    precision = kw.get("value_dtype", "float64")
    rng = np.random.RandomState(11)
    x = rng.rand(coo.num_columns)
    y = rng.randn(coo.num_rows) if with_y else None
    dt = csr.values.dtype
    got = csr_spmv_segment(csr, torch.from_numpy(x).to(dt),
                           None if y is None else torch.from_numpy(y).to(dt))
    assert got.dtype == dt and got.shape == (coo.num_rows,)
    assert_rows_close(got.double().numpy(), coo, x, y, precision)
    want = np.asarray(csr_spmv_xla(jcsr, x.astype(precision),
                                   None if y is None
                                   else y.astype(precision)), np.float64)
    assert_rows_close(want, coo, x, y, precision)
    assert_rows_close(got.double().numpy(), coo, x, y, precision, want)


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("with_y", [False, True])
def test_csr_spmv_equals_jax_route_and_the_oracle(name, with_y):
    coo, kw, jcsr, csr = _both(name)
    precision = kw.get("value_dtype", "float64")
    rng = np.random.RandomState(12)
    x = rng.rand(coo.num_columns)
    y = rng.randn(coo.num_rows) if with_y else None
    dt = csr.values.dtype
    before = ell_cuda.launches
    got = spmv(csr, torch.from_numpy(x).to(dt),
               None if y is None else torch.from_numpy(y).to(dt))
    assert ell_cuda.launches == before        # the CPU runs the plain K1
    assert got.dtype == dt and got.shape == (coo.num_rows,)
    assert_rows_close(got.double().numpy(), coo, x, y, precision)
    want = np.asarray(csr_spmv_pallas(jcsr, x.astype(precision),
                                      None if y is None
                                      else y.astype(precision)), np.float64)
    assert_rows_close(want, coo, x, y, precision)
    assert_rows_close(got.double().numpy(), coo, x, y, precision, want)


@pytest.mark.parametrize("name", ["general", "symmetric", "int64_f32",
                                  "separate_diagonal"])
def test_sell_repack_equals_jax_and_is_cached(name):
    from tests.test_torch_sell import assert_sell_equal
    _, _, jcsr, csr = _both(name)
    sm = to_sell(csr)
    assert_sell_equal(sm, jax_to_sell(jcsr))
    assert to_sell(csr) is sm
    moved = csr.to("cpu")
    assert to_sell(moved) is moved._sell_cache


def test_repack_of_a_banded_matrix_is_one_launch():
    """fem_mesh_2d: every slice's longest row rounds up to one width, so the
    repack is one bucket in natural order and one K1 launch a call."""
    from ellspmv_tpu_torch.formats.sell import kernel_launches
    coo = fem_mesh_2d(64)            # 4,096 rows: 4 whole slices
    csr = csr_from_coo(port_coo(coo))
    sm = to_sell(csr)
    assert sm.trivial_reassembly and kernel_launches(sm) == 1
    assert [b.rowsize for b in sm.buckets] == [32]
    assert sm.buckets[0].lcol is not None          # narrow columns
    # one K1 pass: the bucket's values, columns, x and y; nothing else
    b = sm.buckets[0]
    sv = 8
    assert sell_bytes(sm, with_y=False) == (b.rowsize * b.padded_rows * sv
                                            + b.index_bytes + 4096 * sv
                                            + 4096 * sv)
    assert csr_bytes(csr) == sell_bytes(sm, with_y=False) + 3 * 4096 * sv


@pytest.mark.parametrize("name", ["general", "symmetric", "int64_f32",
                                  "separate_diagonal", "rectangular"])
def test_metrics_equal_jax(name):
    _, _, jcsr, csr = _both(name)
    assert vars(SpmvMetrics.for_matrix(csr)) == \
        vars(JaxSpmvMetrics.for_matrix(jcsr))


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def port(argv, capsys):
    return run(csrspmv.main, ["--device=cpu"] + argv, capsys)


@pytest.mark.parametrize("path", EXAMPLES)
@pytest.mark.parametrize("flags", [
    [], ["--separate-diagonal"], ["--sort-rows", "--precision=float32"],
    ["--repeat=3", "--warmup=1"], ["--partition-nonzeros"],
    ["--rows-per-thread=2,2", "--index-width=64"],
])
def test_stdout_identical_to_jax(path, flags, capsys):
    rc_j, out_j, err_j = run(jax_csrspmv.main, flags + [path], capsys)
    rc_p, out_p, err_p = port(flags + [path], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j


@pytest.mark.parametrize("flags,label", [
    ([], "csrgemv"), (["--partition-rows"], "csrgemv"),
    (["--separate-diagonal"], "csrgemvsd"),
    (["--partition-nonzeros"], "csrgemvnz"),
    (["--precompute-partition", "--partition-nonzeros"], "csrgemvnz"),
    (["--rows-per-thread=2,2"], "csrgemvrp"),
])
def test_labels(flags, label, capsys):
    rc, out, err = port(["-q", "-v", "--repeat=2"] + flags + [EXAMPLES[0]],
                        capsys)
    assert rc == 0 and out == ""
    assert err.count(f"{label}:") == 2
    assert "csr_from_coo:" in err and ", 1 to 5 nonzeros per row" in err


def test_a64fx_flags_accepted_and_ignored(capsys):
    flags = ["--columns-per-thread=1,2", "--l1-prefetch-distance=4",
             "--l2-prefetch-distance", "8"]
    rc, out, err = port(["-v"] + flags + [EXAMPLES[0]], capsys)
    assert rc == 0
    assert "placement options have no analogue on a CUDA card; ignored" \
        in err
    assert out == port([EXAMPLES[0]], capsys)[1]
    np.testing.assert_array_equal(read_vector(io.BytesIO(out.encode())),
                                  [3, 1, 3, 6])


def test_csrspmv_needs_a_card_or_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(csrspmv.main, [EXAMPLES[0]], capsys)
    assert rc == 1 and out == ""
    assert "csrspmv: --device=cuda: no CUDA device is available" in err


@pytest.mark.parametrize("argv", [["--format=sell"], ["--bogus"],
                                  ["--rows-per-thread"]])
def test_refusals_match_jax(argv, capsys):
    tail = [] if argv == ["--rows-per-thread"] else [EXAMPLES[0]]
    rc_j, _, err_j = run(jax_csrspmv.main, argv + tail, capsys)
    rc_p, _, err_p = run(csrspmv.main, argv + tail, capsys)
    assert rc_j == rc_p == 1
    assert err_p == err_j


@pytest.mark.parametrize("argv,shown", [
    (["--devices=2"], "--devices=2"),
    # --backend=xla and --papi-event-summary are ported: each now runs
    # beside --devices=2, the one option still refused (the ids are the
    # cases' names from before)
    pytest.param(["--backend=xla", "--devices=2"], "--devices=2",
                 id="argv1---backend=xla"),
    pytest.param(["--papi-event-summary", "--devices=4"], "--devices=4",
                 id="argv2---papi-event-summary"),
])
def test_unported_options_refused(argv, shown, capsys):
    rc, out, err = port(argv + [EXAMPLES[0]], capsys)
    assert rc == 1 and out == ""
    assert err == f"csrspmv: {shown} is not yet ported (see ROADMAP.md)\n"


def test_help_lists_the_csr_options(capsys):
    with pytest.raises(SystemExit) as e:
        csrspmv.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--partition-nonzeros" in out and "--l2-prefetch-distance" in out
    assert "--format" not in out


def test_fem_mesh_through_both_programs(tmp_path, capsys):
    coo = fem_mesh_2d(24)
    path = str(tmp_path / "fem.mtx")
    write_matrix(path, coo)
    rc_j, out_j, err_j = run(jax_csrspmv.main, ["--sort-rows", path], capsys)
    rc_p, out_p, err_p = port(["--sort-rows", path], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    y_p = read_vector(io.BytesIO(out_p.encode()))
    assert len(y_p) == coo.num_rows
    assert_rows_close(y_p, coo, np.ones(coo.num_columns), None, "float64")
    np.testing.assert_allclose(y_p, read_vector(io.BytesIO(out_j.encode())),
                               rtol=1e-13, atol=1e-13 * np.abs(y_p).max())
