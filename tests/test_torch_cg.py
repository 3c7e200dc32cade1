"""The port's solver path against the JAX package's, on the CPU: RCM
(`models/reorder.py`, bit-equal), the fp64 dot product (`ops/dot_cuda.vdot`,
whose plain version runs on CPU tensors, against the Pallas ``dd_vdot`` in
interpret mode and `math.fsum`), CG (`models/solvers.cg` against
``ellspmv_tpu.models.solvers.cg`` on the same ELL data) and the `cgsolve`
and `ellspmv --reorder=rcm` programs against the JAX programs. The dot
kernel itself is held against its plain version on the card (the ``cuda``
test below, and ``chip_smoke.py``)."""

import dataclasses
import io
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ellspmv_tpu.cli import cgsolve as jax_cgsolve
from ellspmv_tpu.cli import ellspmv as jax_ellspmv
from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.io.mtx import read_vector, write_matrix, write_vector
from ellspmv_tpu.models import reorder as jax_reorder
from ellspmv_tpu.models.generators import banded_random, fem_mesh_2d, poisson2d
from ellspmv_tpu.models.solvers import cg as jax_cg
from ellspmv_tpu.ops.ell_xla import ell_spmv_xla
from ellspmv_tpu.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.bench.traffic import cg_iteration_bytes, dot_bytes
from ellspmv_tpu_torch.cli import cgsolve
from ellspmv_tpu_torch.cli import ellspmv
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix, ell_from_jax_arrays
from ellspmv_tpu_torch.models import reorder
from ellspmv_tpu_torch.models.solvers import cg
from ellspmv_tpu_torch.ops import dot_cuda
from ellspmv_tpu_torch.ops.dispatch import spmv
from tests.conftest import assert_fp64_close, random_coo


def port_coo(coo) -> CooMatrix:
    return CooMatrix(**dataclasses.asdict(coo))


def isolated_vertices_coo():
    """40 vertices: a path over 0..19, self-loops only on 20..29, nothing
    at all on 30..39."""
    rows = np.concatenate([np.arange(19), np.arange(1, 20), np.arange(30)])
    cols = np.concatenate([np.arange(1, 20), np.arange(19), np.arange(30)])
    from ellspmv_tpu.formats.coo import CooMatrix as JaxCoo
    return JaxCoo(40, 40, rows.astype(np.int32), cols.astype(np.int32),
                  np.random.RandomState(2).randn(len(rows)))


def shuffled_banded(n):
    """A banded matrix hidden behind a random permutation, the structure RCM
    recovers (as in tests/test_reorder.py)."""
    coo = banded_random(n, 6, 15, seed=7)
    p = np.random.RandomState(9).permutation(n).astype(coo.rowidx.dtype)
    return dataclasses.replace(coo, rowidx=p[coo.rowidx],
                               colidx=p[coo.colidx])


RCM_CASES = {
    "poisson2d(12)": lambda: poisson2d(12),
    "fem_mesh_2d(16)": lambda: fem_mesh_2d(16),
    "symmetric_file": lambda: random_coo(np.random.RandomState(3), 60, 60,
                                         200, symmetric=True),
    "isolated_vertices": isolated_vertices_coo,
    "shuffled_banded": lambda: shuffled_banded(500),
}


# -- RCM ----------------------------------------------------------------

@pytest.mark.parametrize("case", sorted(RCM_CASES))
def test_rcm_permutation_equals_jax(case):
    coo = RCM_CASES[case]().expand_symmetry()
    want = jax_reorder.rcm_permutation(coo)
    got = reorder.rcm_permutation(port_coo(coo))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(RCM_CASES))
def test_reorder_rcm_equals_jax(case):
    coo = RCM_CASES[case]()
    want = jax_reorder.reorder_rcm(coo)
    got = reorder.reorder_rcm(port_coo(coo))
    for name in ("perm", "inv"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name))
    assert dataclasses.asdict(got.coo).keys() == \
        dataclasses.asdict(want.coo).keys()
    for name, value in dataclasses.asdict(want.coo).items():
        mine = getattr(got.coo, name)
        if isinstance(value, np.ndarray):
            assert mine.dtype == value.dtype, name
            np.testing.assert_array_equal(mine, value, err_msg=name)
        else:
            assert mine == value, name
    assert reorder.bandwidth(got.coo) == jax_reorder.bandwidth(want.coo)
    x = np.random.RandomState(5).randn(coo.num_rows)
    np.testing.assert_array_equal(got.permute_x(x), want.permute_x(x))
    np.testing.assert_array_equal(got.unpermute_y(x), want.unpermute_y(x))


def test_rcm_reduces_bandwidth_and_keeps_the_product():
    coo = RCM_CASES["shuffled_banded"]()
    rm = reorder.reorder_rcm(port_coo(coo))
    assert reorder.bandwidth(port_coo(coo)) > 300
    assert reorder.bandwidth(rm.coo) < 100
    assert sorted(rm.perm) == list(range(500))
    x = np.random.RandomState(1).randn(500)
    assert_fp64_close(rm.unpermute_y(coo_spmv_numpy(rm.coo,
                                                    rm.permute_x(x))),
                      coo_spmv_numpy(coo, x))


def test_rcm_refuses_rectangular():
    coo = port_coo(random_coo(np.random.RandomState(0), 10, 12, 30))
    with pytest.raises(ValueError, match="square"):
        reorder.rcm_permutation(coo)


# -- the fp64 dot product (K6) -------------------------------------------

def _vectors(n):
    rng = np.random.RandomState(n)
    return rng.randn(n), rng.randn(n)


@pytest.mark.parametrize("n", [1, 1000, 1023, 1025, 5000])
def test_vdot_against_jax_dd_vdot(n, monkeypatch):
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    from ellspmv_tpu.ops.dd_reduce import _split, dd_vdot, dd_vdot_split
    x, y = _vectors(n)
    before = dot_cuda.launches
    got = dot_cuda.vdot(torch.from_numpy(x), torch.from_numpy(y))
    assert dot_cuda.launches == before      # the CPU runs the plain version
    assert got.shape == () and got.dtype == torch.float64
    scale = float(np.sum(np.abs(x * y)))
    assert abs(float(got) - math.fsum(x * y)) <= 1e-14 * scale
    xh, xl = _split(jnp.asarray(x))
    yh, yl = _split(jnp.asarray(y))
    for want in (dd_vdot(jnp.asarray(x), jnp.asarray(y)),
                 dd_vdot_split(xh, xl, yh, yl)):
        assert abs(float(got) - float(want)) <= 1e-13 * scale


def test_vdot_exact_on_integers():
    x = torch.arange(1, 1001, dtype=torch.float64)
    assert float(dot_cuda.vdot(x, x)) == float(np.sum(x.numpy() ** 2))
    assert float(dot_cuda.vdot(x[:0], x[:0])) == 0.0


@pytest.mark.parametrize("case", ["dtype", "length", "two_d",
                                  "noncontiguous", "mixed_device",
                                  "meta_device"])
def test_vdot_refuses(case):
    x = torch.ones(8, dtype=torch.float64)
    y = torch.ones(8, dtype=torch.float64)
    err = ValueError
    if case == "dtype":
        x, y, err = x.float(), y.float(), TypeError
    elif case == "length":
        y = torch.ones(9, dtype=torch.float64)
    elif case == "two_d":
        x, y = x.reshape(2, 4), y.reshape(2, 4)
    elif case == "noncontiguous":
        x = torch.ones(16, dtype=torch.float64)[::2]
    elif case == "mixed_device":
        y = y.to("meta")
    elif case == "meta_device":
        x, y = x.to("meta"), y.to("meta")
    with pytest.raises(err):
        dot_cuda.vdot(x, y)


# -- CG -------------------------------------------------------------------

CG_MATRICES = {"poisson2d(12)": lambda: poisson2d(12),
               "fem_mesh_2d(16)": lambda: fem_mesh_2d(16)}
CG_TOL = {"float64": (1e-8, 1e-10), "float32": (1e-4, 1e-4)}


def _both_ells(coo, precision):
    jell = jax_ell_from_coo(coo, sort_rows=True, value_dtype=precision)
    pell = ell_from_jax_arrays(np.asarray(jell.colidx),
                               np.asarray(jell.values), None,
                               jell.num_rows, jell.num_columns,
                               jell.num_nonzeros)
    return jell, pell


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("matrix", sorted(CG_MATRICES))
def test_cg_against_jax(matrix, precision):
    coo = CG_MATRICES[matrix]()
    tol, rel = CG_TOL[precision]
    jell, pell = _both_ells(coo, precision)
    b = np.random.RandomState(4).rand(coo.num_rows).astype(precision)
    want = jax_cg(lambda v: ell_spmv_xla(jell, v), jnp.asarray(b), tol=tol,
                  maxiter=500)
    got = cg(lambda v: spmv(pell, v), torch.from_numpy(b), tol=tol,
             maxiter=500)
    assert got.x.dtype == torch.from_numpy(b).dtype
    assert abs(got.iterations - int(want.iterations)) <= 1
    xj = np.asarray(want.x, np.float64)
    scale = np.max(np.abs(xj))
    np.testing.assert_allclose(got.x.double().numpy(), xj, rtol=0,
                               atol=rel * scale)
    assert abs(got.residual_norm - float(want.residual_norm)) \
        <= rel * np.linalg.norm(b)
    # the true residual of the fp64 solve
    if precision == "float64":
        r = b - coo_spmv_numpy(coo, got.x.numpy())
        assert np.linalg.norm(r) <= 10 * tol * np.linalg.norm(b)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_cg_dots_go_through_the_kernel_wrapper_in_fp64(precision,
                                                       monkeypatch):
    calls = []

    def counted(x, y):
        calls.append(x.dtype)
        return dot_cuda.vdot_torch(x, y)
    monkeypatch.setattr(dot_cuda, "vdot", counted)
    _, pell = _both_ells(poisson2d(8), precision)
    res = cg(lambda v: spmv(pell, v),
             torch.ones(64, dtype=pell.values.dtype), tol=1e-6)
    if precision == "float64":
        # 2 before the loop, 2 per iteration: the count K6 shows on a card
        assert len(calls) == 2 + 2 * res.iterations
        assert res.iterations > 0
    else:
        assert calls == []


def test_cg_operand_x0_and_maxiter():
    coo = poisson2d(6)
    _, pell = _both_ells(coo, "float64")
    b = torch.from_numpy(np.random.RandomState(2).rand(36))
    exact = np.linalg.solve(coo.to_dense(), b.numpy())
    res = cg(lambda op, v: spmv(op, v), b,
             x0=torch.ones(36, dtype=torch.float64), tol=1e-12,
             operand=pell)
    np.testing.assert_allclose(res.x.numpy(), exact, rtol=1e-9, atol=1e-9)
    again = cg(lambda v: spmv(pell, v), b, x0=res.x, tol=1e-8)
    assert again.iterations == 0
    assert again.residual_norm <= 1e-8 * float(b.norm())
    stopped = cg(lambda v: spmv(pell, v), b, maxiter=2)
    assert stopped.iterations == 2
    # plain versions given explicitly take the same steps
    plain = cg(lambda v: spmv(pell, v), b, maxiter=2,
               vdot=dot_cuda.vdot_torch)
    assert torch.equal(plain.x, stopped.x)


def test_cg_traffic():
    # fem_mesh_2d(1440): 2,073,600 rows, rowsize 21 (PERF.md), counted
    # from shapes alone on the meta device
    n, rowsize = 2_073_600, 21
    for dtype, want in ((torch.float64, 771_379_200),
                        (torch.float32, 472_780_800)):
        ell = EllMatrix(torch.empty((rowsize, n), dtype=torch.int32,
                                    device="meta"),
                        torch.empty((rowsize, n), dtype=dtype,
                                    device="meta"),
                        None, n, n, 32_344_962)
        assert cg_iteration_bytes(ell) == want
    assert dot_bytes(n) == 33_177_600


# -- the programs ----------------------------------------------------------

def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def poisson_file(tmp_path):
    coo = poisson2d(12)          # SPD, 144 rows
    p = str(tmp_path / "p.mtx")
    write_matrix(p, coo)
    b = np.random.RandomState(0).rand(144)
    bp = str(tmp_path / "b.mtx")
    write_vector(bp, b)
    rect = str(tmp_path / "r.mtx")
    write_matrix(rect, random_coo(np.random.RandomState(0), 10, 12, 30))
    return {"A": p, "b": bp, "rect": rect}


# the five cases of tests/test_cgsolve.py: (argv, JAX exit code, port's)
CGSOLVE_CASES = {
    "solve": (["-v", "{A}"], 0, 0),
    "b_and_reorder": (["--reorder=rcm", "--tol=1e-10", "-v", "{A}", "{b}"],
                      0, 0),
    "sharded": (["--devices=4", "-q", "-v", "{A}"], 0, 0),
    "rectangular": (["{rect}"], 1, 1),
    "nonconvergence": (["--maxiter=2", "--tol=1e-14", "-q", "-v", "{A}"],
                       2, 2),
}


def _iterations(err):
    found = re.search(r"cg: (\d+) iterations, residual \S+, \S+ seconds",
                      err)
    return None if found is None else int(found.group(1))


@pytest.mark.parametrize("case", sorted(CGSOLVE_CASES))
def test_cgsolve_against_jax(case, poisson_file, capsys):
    template, rc_jax, rc_port = CGSOLVE_CASES[case]
    argv = [a.format(**poisson_file) for a in template]
    rc_j, out_j, err_j = run(jax_cgsolve.main, argv, capsys)
    rc_p, out_p, err_p = run(cgsolve.main, ["--device=cpu"] + argv, capsys)
    assert (rc_j, rc_p) == (rc_jax, rc_port), (err_j, err_p)
    if case == "sharded":
        # four CPU ranks over gloo; JAX's double-double CG over 4 devices
        assert "devices: 4 ranks over gloo" in err_p
    if case == "rectangular":
        assert err_p == err_j == "cgsolve: CG needs a square (SPD) matrix\n"
        return
    if "-v" in argv:
        assert abs(_iterations(err_p) - _iterations(err_j)) <= 1
    if out_j:
        xj = read_vector(io.BytesIO(out_j.encode()))
        xp = read_vector(io.BytesIO(out_p.encode()))
        np.testing.assert_allclose(xp, xj, rtol=0,
                                   atol=1e-10 * np.max(np.abs(xj)))
        b = (np.ones(144) if "{b}" not in template
             else read_vector(poisson_file["b"]))
        r = b - poisson2d(12).to_dense() @ xp
        assert np.linalg.norm(r) <= 10 * 1e-8 * np.linalg.norm(b)
    else:
        assert out_p == ""


def test_cgsolve_float32(poisson_file, capsys):
    argv = ["--precision=float32", "--tol=1e-4", "-v", poisson_file["A"]]
    rc_j, out_j, err_j = run(jax_cgsolve.main, argv, capsys)
    rc_p, out_p, err_p = run(cgsolve.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert abs(_iterations(err_p) - _iterations(err_j)) <= 1
    xj = read_vector(io.BytesIO(out_j.encode()))
    xp = read_vector(io.BytesIO(out_p.encode()))
    np.testing.assert_allclose(xp, xj, rtol=0,
                               atol=1e-4 * np.max(np.abs(xj)))


@pytest.mark.parametrize("argv", [["--tol=abc"], ["--maxiter=x"],
                                  ["--bogus"], ["--tol"], []])
def test_cgsolve_bad_arguments_match_jax(argv, poisson_file, capsys):
    tail = [] if argv in (["--tol"], []) else [poisson_file["A"]]
    rc_j, _, err_j = run(jax_cgsolve.main, argv + tail, capsys)
    rc_p, _, err_p = run(cgsolve.main, argv + tail, capsys)
    assert rc_j == rc_p == 1
    assert err_p == err_j


def test_cgsolve_bad_files(poisson_file, tmp_path, capsys):
    short = str(tmp_path / "short.mtx")
    write_vector(short, np.ones(3))
    argv = [poisson_file["A"], short]
    rc_j, _, err_j = run(jax_cgsolve.main, argv, capsys)
    rc_p, _, err_p = run(cgsolve.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 1 and err_p == err_j
    rc, _, err = run(cgsolve.main, ["--device=cpu",
                                    str(tmp_path / "missing.mtx")], capsys)
    assert rc == 1 and err.startswith("cgsolve: ")


def test_cgsolve_device_flag(poisson_file, monkeypatch, capsys):
    rc, _, err = run(cgsolve.main, ["--device=tpu", poisson_file["A"]],
                     capsys)
    assert rc == 1 and err == "cgsolve: --device must be cuda or cpu\n"
    rc, _, err = run(cgsolve.main, ["--precision=bfloat16",
                                    poisson_file["A"]], capsys)
    assert rc == 1 and "float64 or float32" in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(cgsolve.main, [poisson_file["A"]], capsys)
    assert rc == 1 and out == ""
    assert "--device=cuda: no CUDA device is available" in err
    assert cgsolve.main(["--help"]) == 0
    assert "--device=cuda|cpu" in capsys.readouterr().out


def test_solve_keeps_the_original_order():
    coo = RCM_CASES["shuffled_banded"]()
    # make it SPD: symmetrise and boost the diagonal
    a = coo.to_dense()
    a = a + a.T + 40 * np.eye(500)
    r, c = np.nonzero(a)
    spd = CooMatrix(500, 500, r.astype(np.int32), c.astype(np.int32),
                    a[r, c])
    b = np.random.RandomState(3).rand(500)
    x_plain, res_plain, _ = cgsolve.solve(spd, b, device="cpu")
    x_rcm, res_rcm, _ = cgsolve.solve(spd, b, reorder="rcm", device="cpu")
    assert abs(res_plain.iterations - res_rcm.iterations) <= 1
    np.testing.assert_allclose(x_rcm, x_plain, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(a @ x_rcm, b, rtol=0, atol=1e-6)


@pytest.fixture
def reorder_files(tmp_path):
    paths = {}
    for name, coo in (("poisson", poisson2d(12)),
                      ("fem", fem_mesh_2d(16))):
        paths[name] = str(tmp_path / f"{name}.mtx")
        write_matrix(paths[name], coo)
    n = 256
    paths["x"], paths["y"] = str(tmp_path / "x.mtx"), str(tmp_path / "y.mtx")
    write_vector(paths["x"], np.random.RandomState(1).rand(n))
    write_vector(paths["y"], np.random.RandomState(2).randn(n))
    return paths


@pytest.mark.parametrize("flags,matrix,vectors", [
    ([], "poisson", False),
    (["--sort-rows"], "fem", False),
    (["--separate-diagonal", "--repeat=2"], "fem", True),
    (["--format=dia"], "poisson", False),
    (["--precision=float32"], "fem", False),
])
def test_ellspmv_reorder_rcm_against_jax(flags, matrix, vectors,
                                         reorder_files, capsys):
    argv = ["--reorder=rcm"] + flags + [reorder_files[matrix]]
    if vectors:
        argv += [reorder_files["x"], reorder_files["y"]]
    rc_j, out_j, err_j = run(jax_ellspmv.main, argv, capsys)
    rc_p, out_p, err_p = run(ellspmv.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    yj = read_vector(io.BytesIO(out_j.encode()))
    yp = read_vector(io.BytesIO(out_p.encode()))
    if matrix == "poisson":
        assert out_p == out_j        # integer sums: the same text
    elif "--precision=float32" in flags:
        scale = np.max(np.abs(yj))
        np.testing.assert_allclose(yp, yj, rtol=2e-5, atol=2e-5 * scale)
    else:
        assert_fp64_close(yp, yj)


def test_ellspmv_reorder_rcm_verbose_and_rectangular(reorder_files,
                                                    poisson_file, capsys):
    rc, out, err = run(ellspmv.main, ["--device=cpu", "-q", "-v",
                                      "--reorder=rcm",
                                      reorder_files["poisson"]], capsys)
    assert rc == 0 and out == ""
    assert re.search(r"^reorder_rcm: \d+\.\d{6} seconds$", err, re.M)
    argv = ["--reorder=rcm", poisson_file["rect"]]
    rc_j, _, err_j = run(jax_ellspmv.main, argv, capsys)
    rc_p, _, err_p = run(ellspmv.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 1
    assert err_p == err_j == ("ellspmv: --reorder=rcm needs a square "
                              "matrix\n")
