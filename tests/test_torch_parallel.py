"""The port's multi-device path (``ellspmv_tpu_torch/parallel/``) against
the JAX package's (``ellspmv_tpu/parallel/``) on the CPU: gloo ranks here,
JAX's 8 virtual host devices there (``tests/conftest.py``).

- the row boundaries of every partition, and the error texts of bad
  ``rows_per_device`` lists, equal to JAX's;
- the workload table and the ``-v`` summary equal to JAX's, for ELL, CSR
  and the stream format;
- the sharded ELL and CSR y bit-equal to the port's one-device y, and
  within rtol 1e-12 (fp64; f32: 1e-5 of sum |a*x| per row) of JAX's
  sharded ``xla`` result;
- the sharded stream against the NumPy oracle per row (fp64 1e-13, f32
  1e-5) and JAX's sharded ``xla`` stream (rtol 1e-12);
- CG within one iteration of JAX's generic sharded CG, its true residual
  at most 10*tol;
- the chained protocol over ranks against the same recurrence on one
  device;
- the programs with ``--devices=N`` against the JAX programs;
- a rank that raises, or runs out of time, fails the call.

The ranks of most cases come from one module-scoped pool of four, so the
file pays for its processes once. Inputs come from numpy seeds."""

import dataclasses
import io
import re
import time

import numpy as np
import pytest
import torch

from ellspmv_tpu.cli import cgsolve as jax_cgsolve
from ellspmv_tpu.cli import csrspmv as jax_csrspmv
from ellspmv_tpu.cli import ellspmv as jax_ellspmv
from ellspmv_tpu.cli.common import _workload_summary as jax_summary
from ellspmv_tpu.formats.csr import csr_from_coo as jax_csr_from_coo
from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.io.mtx import read_vector, write_matrix
from ellspmv_tpu.models.generators import fem_mesh_2d, poisson2d, power_law
from ellspmv_tpu.models.solvers import cg as jax_cg
from ellspmv_tpu.parallel import spmv as jax_par
from ellspmv_tpu.parallel import stream as jax_par_stream
from ellspmv_tpu_torch.bench.harness import CHAINED_SCALE, benchmark_sharded
from ellspmv_tpu_torch.cli import cgsolve, csrspmv, ellspmv
from ellspmv_tpu_torch.cli.common import workload_summary
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.csr import csr_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.ops.dispatch import spmv
from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.parallel import launch, mesh
from ellspmv_tpu_torch.parallel.solver import solve_sharded
from ellspmv_tpu_torch.parallel.spmv import (collectives_task,
                                             partition_boundaries, run_spmv,
                                             shard_matrix)
from ellspmv_tpu_torch.parallel.stream import shard_stream
from tests.conftest import random_coo
from torch_cases import assert_rows_close

RANKS = 4


@pytest.fixture(scope="module")
def pool():
    with launch.RankPool(["cpu"] * RANKS, timeout=120) as p:
        yield p


def port_coo(coo) -> CooMatrix:
    return CooMatrix(**dataclasses.asdict(coo))


def convert(fmt, coo, **kw):
    """The same COO through the port's and JAX's converter of `fmt`."""
    port = {"ell": ell_from_coo, "csr": csr_from_coo}[fmt]
    jax = {"ell": jax_ell_from_coo, "csr": jax_csr_from_coo}[fmt]
    return port(port_coo(coo), **kw), jax(coo, **kw)


def skewed_coo(n=53, m=53, seed=3):
    """Rows of very different lengths (the first rows dense), with
    duplicates: the nonzeros partition moves its boundaries far from the
    rows partition's."""
    rng = np.random.RandomState(seed)
    rows = np.concatenate([np.zeros(40, np.int32), np.full(25, 1, np.int32),
                           rng.randint(0, n, 3 * n).astype(np.int32)])
    cols = rng.randint(0, m, len(rows)).astype(np.int32)
    from ellspmv_tpu.formats.coo import CooMatrix as JaxCoo
    return JaxCoo(n, m, rows, cols, rng.randn(len(rows)))


# -- boundaries and the workload report ---------------------------------------

BOUNDARY_CASES = {
    "rows": dict(partition="rows"),
    "nonzeros": dict(partition="nonzeros"),
    "explicit": dict(rows_per_device="auto"),
}


def _explicit(n, n_dev):
    """An explicit list with an empty rank where there are two or more."""
    counts = [0] + [n // (n_dev - 1)] * (n_dev - 1) if n_dev > 1 else [n]
    counts[-1] += n - sum(counts)
    return counts


@pytest.mark.parametrize("n_dev", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("case", sorted(BOUNDARY_CASES))
@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_boundaries_equal_jax(fmt, case, n_dev):
    coo = skewed_coo()
    port, jax = convert(fmt, coo)
    kw = dict(BOUNDARY_CASES[case])
    if kw.get("rows_per_device") == "auto":
        kw["rows_per_device"] = _explicit(coo.num_rows, n_dev)
    want = jax_par._partition_boundaries(jax, n_dev, kw.get("partition",
                                                            "rows"),
                                         kw.get("rows_per_device"))
    got = partition_boundaries(port, n_dev, **kw)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("partition", ["rows", "nonzeros"])
@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_more_ranks_than_rows_equal_jax(fmt, partition):
    rng = np.random.RandomState(5)
    coo = random_coo(rng, 5, 7, 12, with_dups=True)
    port, jax = convert(fmt, coo)
    want = jax_par._partition_boundaries(jax, 8, partition, None)
    got = partition_boundaries(port, 8, partition)
    np.testing.assert_array_equal(got, want)
    assert (np.diff(got) == 0).any()          # some ranks have no rows


BAD_LISTS = {"short": [10, 30, 13], "wrong_sum": [10, 30, 13, 1],
             "long": [10, 30, 13, 0, 0]}


@pytest.mark.parametrize("bad", sorted(BAD_LISTS))
@pytest.mark.parametrize("fmt", ["ell", "csr", "stream"])
def test_bad_rows_per_device_errors_equal_jax(fmt, bad):
    coo = skewed_coo()
    rows = BAD_LISTS[bad]
    with pytest.raises(ValueError) as want:
        if fmt == "stream":
            jax_par_stream.shard_stream(coo, 4, rows_per_device=rows)
        else:
            jax_par.shard_matrix(convert(fmt, coo)[1], 4,
                                 rows_per_device=rows)
    with pytest.raises(ValueError) as got:
        if fmt == "stream":
            shard_stream(port_coo(coo), 4, rows_per_device=rows)
        else:
            shard_matrix(convert(fmt, coo)[0], 4, rows_per_device=rows)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("partition", ["rows", "nonzeros"])
@pytest.mark.parametrize("fmt", ["ell", "csr", "stream"])
def test_workload_report_equal_jax(fmt, partition):
    coo = skewed_coo()
    if fmt == "stream":
        jax_sm = jax_par_stream.shard_stream(coo, RANKS, partition=partition,
                                             separate_diagonal=True)
        port_sm = shard_stream(port_coo(coo), RANKS, partition=partition,
                               separate_diagonal=True)
    else:
        port, jax = convert(fmt, coo, separate_diagonal=True)
        jax_sm = jax_par.shard_matrix(jax, RANKS, partition=partition)
        port_sm = shard_matrix(port, RANKS, partition=partition)
    assert port_sm.workload_report() == jax_sm.workload_report()
    assert workload_summary(port_sm) == jax_summary(jax_sm)
    np.testing.assert_array_equal(port_sm.boundaries, jax_sm.boundaries)


def test_formats_jax_cannot_shard_raise_type_error():
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    with pytest.raises(TypeError, match="unsupported matrix type"):
        shard_matrix(dia_from_coo(port_coo(poisson2d(8))), 2)


# -- the sharded y ------------------------------------------------------------

def _jax_sharded_y(jax_mat, n_dev, x, y, **kw):
    sm = jax_par.shard_matrix(jax_mat, n_dev, **kw)
    fn = jax_par.sharded_spmv_fn(sm, backend="xla")
    return np.asarray(fn(sm, x, y), np.float64)


def _check_sharded(pool, coo, fmt, sep, precision, **kw):
    """The port's sharded y, both backends, against its one-device y (bit
    for bit) and against JAX's sharded xla y."""
    rng = np.random.RandomState(11)
    x = rng.randn(coo.num_columns)
    y = rng.randn(coo.num_rows)
    port, jax = convert(fmt, coo, separate_diagonal=sep,
                        value_dtype=precision)
    dt = port.values.dtype
    xt, yt = torch.from_numpy(x).to(dt), torch.from_numpy(y).to(dt)
    sm = shard_matrix(port, pool.world, **kw)
    for backend, yy in (("auto", None), ("xla", None), ("auto", yt),
                        ("xla", yt)):
        got = run_spmv(pool, sm, xt, yy, backend=backend)
        want = spmv(port, xt, yy, backend=backend)
        assert got.dtype == want.dtype
        assert torch.equal(got, want), (backend, yy is None)
    want = _jax_sharded_y(jax, pool.world, x.astype(precision),
                          y.astype(precision), **kw)
    if precision == "float64":
        np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())
    else:
        assert_rows_close(got.double().numpy(), port_coo(coo),
                          x.astype(np.float32).astype(np.float64),
                          y.astype(np.float32).astype(np.float64),
                          precision)
        assert_rows_close(want, port_coo(coo),
                          x.astype(np.float32).astype(np.float64),
                          y.astype(np.float32).astype(np.float64),
                          precision)


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("sep", [False, True], ids=["nodiag", "diag"])
@pytest.mark.parametrize("shape", [(64, 64), (100, 52), (53, 101)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_sharded_y(pool, fmt, shape, sep, precision):
    n, m = shape
    coo = random_coo(np.random.RandomState(n * m), n, m, 4 * n,
                     with_dups=True)
    _check_sharded(pool, coo, fmt, sep, precision)


@pytest.mark.parametrize("kw", [dict(partition="nonzeros"),
                                dict(rows_per_device=[0, 30, 3, 20])],
                         ids=["nonzeros", "explicit"])
@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_sharded_y_partitions(pool, fmt, kw):
    _check_sharded(pool, skewed_coo(), fmt, True, "float64", **kw)


def test_sharded_y_on_eight_ranks():
    coo = random_coo(np.random.RandomState(8), 64, 64, 300, with_dups=True)
    with launch.RankPool(["cpu"] * 8, timeout=120) as eight:
        _check_sharded(eight, coo, "ell", True, "float64")


# -- the sharded stream -------------------------------------------------------

@pytest.mark.parametrize("partition", ["rows", "nonzeros"])
@pytest.mark.parametrize("sep", [False, True], ids=["nodiag", "diag"])
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_sharded_stream(pool, precision, sep, partition):
    coo = power_law(600, 5, seed=4)
    rng = np.random.RandomState(2)
    x = rng.randn(coo.num_columns)
    y = rng.randn(coo.num_rows)
    ss = shard_stream(port_coo(coo), RANKS, partition=partition,
                      value_dtype=precision, separate_diagonal=sep)
    dt = ss.dtype
    got = run_spmv(pool, ss, torch.from_numpy(x).to(dt),
                   torch.from_numpy(y).to(dt)).double().numpy()
    xq = x.astype(precision).astype(np.float64)
    yq = y.astype(precision).astype(np.float64)
    assert_rows_close(got, port_coo(coo), xq, yq, precision)
    if precision == "float64":
        jss = jax_par_stream.shard_stream(coo, RANKS, partition=partition,
                                          value_dtype=np.float64,
                                          separate_diagonal=sep)
        fn = jax_par_stream.sharded_stream_spmv_fn(jss, backend="xla")
        want = np.asarray(fn(jss, x, y), np.float64)
        np.testing.assert_allclose(got, want, rtol=1e-12,
                                   atol=1e-12 * np.abs(want).max())


# -- CG and the chained protocol ----------------------------------------------

@pytest.mark.parametrize("case", ["poisson2d(12)", "fem_mesh_2d(16)"])
def test_cg_sharded_against_jax(pool, case):
    coo = poisson2d(12) if case == "poisson2d(12)" else fem_mesh_2d(16)
    n, tol = coo.num_rows, 1e-8
    b = np.random.RandomState(0).rand(n)
    port, jax = convert("ell", coo, sort_rows=True)
    out = solve_sharded(pool, shard_matrix(port, RANKS), torch.from_numpy(b),
                        tol=tol, maxiter=1000)
    jsm = jax_par.shard_matrix(jax, RANKS)
    fn = jax_par.sharded_spmv_fn(jsm)
    want = jax_cg(lambda v: fn(jsm, v), b, tol=tol, maxiter=1000)
    assert abs(out["iterations"] - int(want.iterations)) <= 1
    r = b - coo_spmv_numpy(port_coo(coo), out["x"])
    assert np.linalg.norm(r) <= 10 * tol * np.linalg.norm(b)


@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_chained_over_ranks_is_the_one_device_recurrence(pool, fmt):
    coo = fem_mesh_2d(12)
    port, _ = convert(fmt, coo, sort_rows=True)
    x0 = torch.from_numpy(np.random.RandomState(1).rand(coo.num_rows))
    sm = shard_matrix(port, RANKS, partition="nonzeros")
    res = benchmark_sharded(pool, sm, x0, repeat=2, warmup=1,
                            protocol="chained", matrix=port)
    # the last long loop: lo + span iterations from (x0, 0)
    xk, yk = x0.clone(), torch.zeros(coo.num_rows, dtype=torch.float64)
    for _ in range(1 + res.span_iters):
        yk = spmv(port, xk, yk)
        torch.mul(yk, CHAINED_SCALE, out=xk)
    assert torch.equal(res.y, yk)
    assert res.best > 0 and len(res.times) == 2
    assert [c["ell_spmv"] for c in res.rank_launches] == [0] * RANKS


# -- the programs -------------------------------------------------------------

def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


SUMMARY = re.compile(r"^(rows|nonzeros) per device: |^device  rows|^\d+ +\d+")


def _workload_lines(err):
    return [line for line in err.splitlines() if SUMMARY.match(line)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("par")
    paths = {"test": "examples/test.mtx"}
    for name, coo in (("fem", fem_mesh_2d(16)),
                      ("pl", power_law(500, 4, seed=2)),
                      ("rect", random_coo(np.random.RandomState(4), 40, 70,
                                          200))):
        paths[name] = str(d / f"{name}.mtx")
        write_matrix(paths[name], coo)
    return paths


# (JAX program, port program, argv, stdout equal): the stream format (each
# rank its own plan, JAX one SPMD plan) and CSR's split diagonal (JAX's
# segment sum against the port's SELL repack) sum in other orders, so their
# y is held at rtol 1e-12 instead
PROGRAM_CASES = {
    "ellspmv_test_v": (jax_ellspmv, ellspmv,
                       ["--devices=4", "-v", "{test}"], True),
    "ellspmv_test_vv_diag": (jax_ellspmv, ellspmv,
                             ["--devices=4", "-vv", "--sort-rows",
                              "--separate-diagonal", "{test}"], True),
    "ellspmv_fem_vv": (jax_ellspmv, ellspmv,
                       ["--devices=3", "-vv", "--repeat=2", "{fem}"], True),
    "ellspmv_rect_diag": (jax_ellspmv, ellspmv,
                          ["--devices=4", "-vv", "--separate-diagonal",
                           "{rect}"], True),
    "ellspmv_stream_vv": (jax_ellspmv, ellspmv,
                          ["--devices=4", "-vv", "--format=stream",
                           "--separate-diagonal", "{pl}"], False),
    "ellspmv_f32": (jax_ellspmv, ellspmv,
                    ["--devices=2", "--precision=float32", "{fem}"], True),
    "csrspmv_nonzeros_v": (jax_csrspmv, csrspmv,
                           ["--devices=4", "--partition-nonzeros", "-vv",
                            "{test}"], True),
    "csrspmv_rows_per_thread": (jax_csrspmv, csrspmv,
                                ["--devices=4", "--rows-per-thread=0,2,1,1",
                                 "-vv", "{test}"], True),
    "csrspmv_fem_diag": (jax_csrspmv, csrspmv,
                         ["--devices=4", "--separate-diagonal", "-v",
                          "--partition-nonzeros", "{fem}"], False),
}


def _values(out):
    return read_vector(io.BytesIO(out.encode()))


@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_programs_against_jax(case, files, capsys):
    jax_main, port_mod, template, same_stdout = PROGRAM_CASES[case]
    argv = [a.format(**files) for a in template]
    rc_j, out_j, err_j = run(jax_main.main, argv, capsys)
    rc_p, out_p, err_p = run(port_mod.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert _workload_lines(err_p) == _workload_lines(err_j)
    assert ("devices: " in err_p) == any(a.startswith("-v") for a in argv)
    if same_stdout:
        assert out_p == out_j
    else:
        np.testing.assert_allclose(_values(out_p), _values(out_j),
                                   rtol=1e-12, atol=1e-12)


def test_cgsolve_sharded_against_jax(files, capsys):
    argv = ["--devices=4", "-v", files["fem"]]
    rc_j, out_j, err_j = run(jax_cgsolve.main, argv, capsys)
    rc_p, out_p, err_p = run(cgsolve.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    pattern = r"cg: (\d+) iterations, residual \S+, \S+ seconds"
    it_j = int(re.search(pattern, err_j).group(1))
    it_p = int(re.search(pattern, err_p).group(1))
    assert abs(it_p - it_j) <= 1
    x = _values(out_p)
    coo = fem_mesh_2d(16)
    r = np.ones(coo.num_rows) - coo_spmv_numpy(port_coo(coo), x)
    assert np.linalg.norm(r) <= 10 * 1e-8 * np.sqrt(coo.num_rows)


@pytest.mark.parametrize("fmt", ["dia", "sell", "hybrid"])
def test_formats_jax_cannot_shard_exit_1(fmt, files, capsys):
    argv = [f"--format={fmt}", "--devices=2", files["fem"]]
    rc_j, out_j, err_j = run(jax_ellspmv.main, argv, capsys)
    rc_p, out_p, err_p = run(ellspmv.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 1 and out_j == out_p == ""
    assert "unsupported matrix type" in err_j
    assert "unsupported matrix type" in err_p


def test_auto_leaves_dia_out_over_ranks(files, capsys):
    argv = ["--format=auto", "--devices=2", "-v", files["fem"]]
    rc_j, out_j, err_j = run(jax_ellspmv.main, argv, capsys)
    rc_p, out_p, err_p = run(ellspmv.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 0
    assert "auto_from_coo [ell]" in err_p and "[dia]" not in err_j
    np.testing.assert_allclose(_values(out_p), _values(out_j), rtol=1e-12)


def test_more_devices_than_cards_exit_1(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    for main in (ellspmv.main, csrspmv.main, cgsolve.main):
        rc, out, err = run(main, ["--devices=2", "examples/test.mtx"],
                           capsys)
        assert rc == 1 and out == ""
        assert "requested 2 devices, have 1" in err
    assert mesh.placement(3, "cpu") == ["cpu"] * 3


def test_dryrun_runs_on_the_card_unless_asked(monkeypatch, capsys):
    from ellspmv_tpu_torch.parallel import dryrun
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dryrun.main(["2"]) == 1
    assert "--device=cuda: no CUDA device" in capsys.readouterr().err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert dryrun.main(["2"]) == 1
    assert "requested 2 devices, have 1" in capsys.readouterr().err


def test_dryrun_on_cpu_ranks(capsys):
    from ellspmv_tpu_torch.parallel import dryrun
    assert dryrun.main(["2", "--device=cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 1 and out[0].startswith("dryrun_multichip(2): ")
    assert "2 ranks over gloo: cpu, cpu" in out[0]


def test_placement_and_backend():
    assert mesh.backend_for(["cpu"] * 3) == "gloo"
    assert mesh.backend_for(["cuda:0", "cuda:1"]) == "nccl"
    assert mesh.backend_for(["cuda:0"] * 4) == "gloo"
    with pytest.raises(ValueError, match="mixes"):
        mesh.backend_for(["cpu", "cuda:0"])


# -- failure ------------------------------------------------------------------

def test_collectives_over_gloo(pool):
    out = pool.run(collectives_task, [(5, 2)] * RANKS)
    assert out == [{"gathered": True, "reduced": 6.0}] * RANKS


def test_a_raising_rank_fails_the_call():
    # rank 1 cannot make its block (a negative length) while the other
    # ranks wait for it in the allgather
    t0 = time.monotonic()
    with launch.RankPool(["cpu"] * 3, timeout=60) as p:
        with pytest.raises(launch.RankFailure, match="rank 1 raised"):
            p.run(collectives_task, [(4,), (-1,), (4,)])
        with pytest.raises(launch.RankFailure, match="closed"):
            p.run(collectives_task, [(4,)] * 3)
        assert not any(proc.is_alive() for proc in p._procs)
    assert time.monotonic() - t0 < 60


def test_a_rank_left_in_a_collective_fails_the_call():
    # rank 1 runs no collective, so rank 0 waits in the allgather until the
    # group's timeout; the call has no deadline of its own
    t0 = time.monotonic()
    with launch.RankPool(["cpu"] * 2, timeout=3) as p:
        with pytest.raises(launch.RankFailure, match="rank 0 raised"):
            p.run(collectives_task, [(4, 1), (4, 0)])
        assert not any(proc.is_alive() for proc in p._procs)
    assert time.monotonic() - t0 < 60


def test_a_rank_out_of_time_fails_the_call():
    with launch.RankPool(["cpu"] * 2, timeout=60) as p:
        with pytest.raises(launch.RankFailure, match="did not finish"):
            p.run(collectives_task, [(4, 10 ** 9)] * 2, timeout=2)
        assert not any(proc.is_alive() for proc in p._procs)
