"""The sharded traceable form (``parallel/spmv.sharded_spmv_fn``) and the
loops over ranks built on it, against the JAX package on the CPU: gloo
ranks here, JAX's virtual host devices there (``tests/conftest.py``).

- `fn` equals ``sharded_spmv`` bit for bit on ELL, CSR and stream shards,
  over 1, 2 and 4 ranks, with and without y and the split diagonal, under
  both backends;
- the chained recurrence over ranks in ``bench/harness._block_loop``'s
  blocks (q·64 + r iterations) equals the one-device recurrence bit for
  bit (the stream format, each rank its own plan: the eager loop over the
  same ranks), and JAX's sharded ``.traceable`` under one ``jax.jit`` of a
  ``lax.fori_loop`` on 4 devices within rtol 1e-12 normwise in fp64; the
  sharded stream's ``.traceable`` (its Pallas path, in interpret mode)
  likewise in f32, every row of both within 1e-5 of its sum |a*x| over the
  iterations;
- sharded CG through the masked step (``models.solvers.cg`` with
  ``sharded_vdot``) takes ``cg_eager``'s iterations to its x bit for bit,
  every rank the same iterations and steps; extra masked steps keep x, r,
  r·r and the count bit for bit on every rank; `maxiter` holds exactly;
  on 4 ranks x is held against JAX's generic sharded CG as
  ``tests/test_torch_parallel.py`` holds it.

The four ranks are ``tests/test_torch_parallel.py``'s module-scoped pool;
one and two ranks get pools of their own. The captured forms are held
against the eager ones on a card in ``tests/test_torch_card.py``."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ellspmv_tpu.models.generators import fem_mesh_2d, power_law
from ellspmv_tpu.models.solvers import cg as jax_cg
from ellspmv_tpu.parallel import spmv as jax_par
from ellspmv_tpu.parallel import stream as jax_par_stream
from ellspmv_tpu_torch.bench.harness import (CHAINED_BLOCK, CHAINED_SCALE,
                                             run_chained)
from ellspmv_tpu_torch.ops.dispatch import spmv
from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.parallel.launch import RankPool
from ellspmv_tpu_torch.parallel.solver import masked_steps_task, solve_sharded
from ellspmv_tpu_torch.parallel.spmv import run_spmv, shard_matrix
from ellspmv_tpu_torch.parallel.stream import shard_stream
from tests.conftest import random_coo
from tests.test_torch_parallel import RANKS, convert, pool, port_coo  # noqa: F401


@pytest.fixture(scope="module")
def small_pools():
    with RankPool(["cpu"], timeout=120) as one, \
            RankPool(["cpu"] * 2, timeout=120) as two:
        yield {1: one, 2: two}


@pytest.fixture(params=[1, 2, RANKS], ids=lambda n: f"{n}ranks")
def ranks(request, small_pools):
    """A pool of 1, 2 or 4 gloo ranks on the CPU."""
    if request.param == RANKS:
        return request.getfixturevalue("pool")
    return small_pools[request.param]


def _sharded(fmt, coo, world, sep=False, precision="float64", **kw):
    """`coo` cut for `world` ranks in `fmt` (the port's converters), and
    the whole matrix (None for the stream format)."""
    if fmt == "stream":
        return shard_stream(port_coo(coo), world, value_dtype=precision,
                            separate_diagonal=sep, **kw), None
    port, _ = convert(fmt, coo, separate_diagonal=sep, value_dtype=precision,
                      sort_rows=True)
    return shard_matrix(port, world, **kw), port


def _vectors(sm, seed=11):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(sm.num_columns)).to(sm.dtype)
    y = torch.from_numpy(rng.randn(sm.num_rows)).to(sm.dtype)
    return x, y


# -- the traceable fn ---------------------------------------------------------

@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("sep", [False, True], ids=["nodiag", "diag"])
@pytest.mark.parametrize("fmt", ["ell", "csr", "stream"])
def test_fn_is_sharded_spmv_bit_for_bit(ranks, fmt, sep, backend):
    coo = random_coo(np.random.RandomState(5), 70, 70, 300, with_dups=True)
    sm, _ = _sharded(fmt, coo, ranks.world, sep)
    x, y = _vectors(sm)
    for yv in (None, y):
        want = run_spmv(ranks, sm, x, yv, backend=backend)
        got = run_spmv(ranks, sm, x, yv, backend=backend, traceable=True)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_fn_on_a_rectangular_matrix(ranks, fmt):
    coo = random_coo(np.random.RandomState(6), 53, 101, 250, with_dups=True)
    sm, port = _sharded(fmt, coo, ranks.world, True)
    x, y = _vectors(sm)
    got = run_spmv(ranks, sm, x, y, traceable=True)
    assert torch.equal(got, run_spmv(ranks, sm, x, y))
    assert torch.equal(got, spmv(port, x, y))


# -- the chained protocol over ranks -------------------------------------------

def _recurrence(matrix, x0, iters):
    xk, yk = x0.clone(), torch.zeros(matrix.num_rows, dtype=x0.dtype)
    for _ in range(iters):
        yk = spmv(matrix, xk, yk)
        torch.mul(yk, CHAINED_SCALE, out=xk)
    return yk


@pytest.mark.parametrize("iters", [5, CHAINED_BLOCK, 2 * CHAINED_BLOCK + 3])
@pytest.mark.parametrize("fmt", ["ell", "csr", "stream"])
def test_chained_blocks_over_ranks(ranks, fmt, iters):
    coo = fem_mesh_2d(12)
    sm, port = _sharded(fmt, coo, ranks.world, partition="nonzeros")
    x0 = torch.from_numpy(np.random.RandomState(1).rand(coo.num_rows)).to(
        sm.dtype)
    got = run_chained(ranks, sm, x0, iters)
    if port is not None:
        assert torch.equal(got, _recurrence(port, x0, iters))
    assert torch.equal(got, run_chained(ranks, sm, x0, iters, eager=True))


def _jax_chained(traceable, x0, iters):
    """`iters` chained iterations of the JAX package's sharded traceable
    form inside one ``jax.jit`` of a ``lax.fori_loop``, from (x0, 0)."""
    operand, fn = traceable

    @jax.jit
    def run(op, x):
        def body(_, carry):
            xk, yk = carry
            yn = fn(op, xk, yk)
            return (CHAINED_SCALE * yn).astype(yn.dtype), yn
        return jax.lax.fori_loop(0, iters, body, (x, jnp.zeros_like(x)))[1]

    return np.asarray(run(operand, jnp.asarray(x0)), np.float64)


def _normwise(got, want):
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("sep", [False, True], ids=["nodiag", "diag"])
@pytest.mark.parametrize("fmt", ["ell", "csr"])
def test_chained_over_ranks_against_jax(pool, fmt, sep):
    coo = fem_mesh_2d(12)
    iters = CHAINED_BLOCK + 7
    x0 = np.random.RandomState(2).rand(coo.num_rows)
    port, jmat = convert(fmt, coo, separate_diagonal=sep, sort_rows=True)
    got = run_chained(pool, shard_matrix(port, RANKS), torch.from_numpy(x0),
                      iters).numpy()
    jsm = jax_par.shard_matrix(jmat, RANKS)
    want = _jax_chained(jax_par.sharded_spmv_fn(jsm).traceable, x0, iters)
    assert _normwise(got, want) <= 1e-12


def _chained_rows_scale(coo, x0, iters):
    """The fp64 chained recurrence from (x0, 0) on the NumPy oracle, and
    each row's sum over the iterations of sum |a*x_k|."""
    absolute = port_coo(coo)
    absolute.values = np.abs(absolute.values)
    xk, yk = x0.astype(np.float64), np.zeros(coo.num_rows)
    scale = np.zeros(coo.num_rows)
    for _ in range(iters):
        scale += coo_spmv_numpy(absolute, np.abs(xk))
        yk = coo_spmv_numpy(port_coo(coo), xk, yk)
        xk = CHAINED_SCALE * yk
    return yk, scale


@pytest.mark.parametrize("sep", [False, True], ids=["nodiag", "diag"])
def test_chained_stream_over_ranks_against_jax(pool, sep):
    # the JAX sharded stream's traceable form is its Pallas path (interpret
    # mode on the CPU, whose fp64 pairs round as f32 there): held in f32,
    # every row of both within 1e-5 of its sum |a*x| over the iterations
    coo = power_law(600, 5, seed=4)
    iters = CHAINED_BLOCK + 7
    x0 = np.random.RandomState(3).rand(coo.num_columns).astype(np.float32)
    ss = shard_stream(port_coo(coo), RANKS, value_dtype="float32",
                      separate_diagonal=sep)
    got = run_chained(pool, ss, torch.from_numpy(x0), iters).double().numpy()
    jss = jax_par_stream.shard_stream(coo, RANKS, value_dtype=np.float32,
                                      separate_diagonal=sep)
    want = _jax_chained(jax_par_stream.sharded_stream_spmv_fn(jss).traceable,
                        x0, iters)
    oracle, scale = _chained_rows_scale(coo, x0, iters)
    for y in (got, want):
        assert np.max(np.abs(y - oracle) / scale) <= 1e-5


# -- CG over ranks through the masked step ------------------------------------

def _cg_case(world, precision="float64"):
    coo = fem_mesh_2d(16)
    port, _ = convert("ell", coo, sort_rows=True, value_dtype=precision)
    b = torch.from_numpy(np.random.RandomState(0).rand(coo.num_rows)).to(
        port.values.dtype)
    return coo, shard_matrix(port, world), b


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_masked_cg_over_ranks_is_cg_eager(ranks, precision):
    _, sm, b = _cg_case(ranks.world, precision)
    tol = 1e-8 if precision == "float64" else 1e-4
    got = solve_sharded(ranks, sm, b, tol=tol)
    want = solve_sharded(ranks, sm, b, tol=tol, eager=True)
    assert got["iterations"] == want["iterations"] > 0
    assert np.array_equal(got["x"], want["x"])
    assert got["residual_norm"] == want["residual_norm"]
    # on the CPU the flag is read after every step: no step is masked
    assert got["rank_steps"] == [(got["iterations"],) * 2] * ranks.world


def test_masked_cg_over_ranks_against_jax(pool):
    coo, sm, b = _cg_case(RANKS)
    tol = 1e-8
    out = solve_sharded(pool, sm, b, tol=tol, maxiter=1000)
    _, jmat = convert("ell", coo, sort_rows=True)
    jsm = jax_par.shard_matrix(jmat, RANKS)
    fn = jax_par.sharded_spmv_fn(jsm)
    want = jax_cg(lambda v: fn(jsm, v), b.numpy(), tol=tol, maxiter=1000)
    assert abs(out["iterations"] - int(want.iterations)) <= 1
    r = b.numpy() - coo_spmv_numpy(port_coo(coo), out["x"])
    assert np.linalg.norm(r) <= 10 * tol * np.linalg.norm(b.numpy())


def test_masked_steps_after_convergence_change_nothing_over_ranks(ranks):
    _, sm, b = _cg_case(ranks.world)
    bs = sm.split_y(b)
    outs = ranks.run(masked_steps_task,
                     [(sm.shards[r], bs[r], 1e-8, 5)
                      for r in range(ranks.world)])
    assert all(o["unchanged"] for o in outs)
    want = solve_sharded(ranks, sm, b, tol=1e-8, eager=True)
    assert [o["iterations"] for o in outs] == \
        [want["iterations"]] * ranks.world


@pytest.mark.parametrize("maxiter", [0, 1, 3])
def test_masked_cg_over_ranks_honours_maxiter(ranks, maxiter):
    _, sm, b = _cg_case(ranks.world)
    got = solve_sharded(ranks, sm, b, tol=1e-14, maxiter=maxiter)
    want = solve_sharded(ranks, sm, b, tol=1e-14, maxiter=maxiter,
                         eager=True)
    assert got["rank_steps"] == [(maxiter, maxiter)] * ranks.world
    assert want["iterations"] == maxiter
    assert np.array_equal(got["x"], want["x"])


def test_cgsolve_over_ranks_prints_its_steps(capsys):
    from ellspmv_tpu_torch.cli import cgsolve
    for argv, steps in ((["--devices=2"], True), ([], False)):
        rc = cgsolve.main(["--device=cpu", "-v", "-q", *argv,
                           "examples/test_spd.mtx"])
        err = capsys.readouterr().err
        assert rc == 0, err
        line = re.search(r"^cg: (\d+) iterations, residual \S+, \S+ "
                         r"seconds(, (\d+) steps)?$", err, re.M)
        assert line and (line.group(2) is not None) == steps
        if steps:       # on the CPU no step is masked
            assert line.group(3) == line.group(1)
