"""The traceable SpMV and the loops built on it, against the JAX package.

``ops.dispatch.traceable_spmv`` is held against ``ops.dispatch.spmv`` bit
for bit, on every format and under both backends, and against the JAX
package's ``traceable_spmv`` run under ``jax.jit`` on the CPU (its XLA
path, as the JAX tests run it without interpret mode), per row relative to
sum |a*x| + |y|: fp64 1e-13, f32 1e-5, bf16 1e-2. The chained protocol's
blocks (``bench/harness._block_loop``, eager on the CPU) give the plain
recurrence bit for bit; the masked CG step (`models.solvers.cg`, eager on
the CPU) matches the JAX solver within `test_torch_cg`'s tolerances, keeps
its state bit for bit once converged, honours `maxiter` and equals
`cg_eager`. The captured forms are held against the eager ones on a card
in ``tests/test_torch_card.py``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ellspmv_tpu.formats import csr as jax_csr
from ellspmv_tpu.formats import dia as jax_dia
from ellspmv_tpu.formats import ell as jax_ell
from ellspmv_tpu.formats import hybrid as jax_hybrid
from ellspmv_tpu.formats import sell as jax_sell
from ellspmv_tpu.formats import stream as jax_stream
from ellspmv_tpu.formats.coo import CooMatrix as JaxCoo
from ellspmv_tpu.models.solvers import cg as jax_cg
from ellspmv_tpu.ops.dispatch import traceable_spmv as jax_traceable_spmv
from ellspmv_tpu_torch.bench import harness
from ellspmv_tpu_torch.bench.harness import (CHAINED_BLOCK, CHAINED_SCALE,
                                             benchmark_spmv)
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.models import solvers
from ellspmv_tpu_torch.models.generators import fem_mesh_2d, poisson2d
from ellspmv_tpu_torch.ops import dispatch
from ellspmv_tpu_torch.ops.dispatch import spmv, traceable_spmv
from torch_cases import TRACEABLE_CASES, assert_rows_close, traceable_case

JAX_CONSTRUCTORS = {"ell": jax_ell.ell_from_coo, "dia": jax_dia.dia_from_coo,
                "sell": jax_sell.sell_from_coo, "csr": jax_csr.csr_from_coo,
                "hybrid": jax_hybrid.hybrid_from_coo,
                "stream": jax_stream.stream_from_coo}


def _jax_coo(coo) -> JaxCoo:
    return JaxCoo(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                  coo.values, coo.symmetry, coo.field)


@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("name", sorted(TRACEABLE_CASES))
def test_traceable_fn_is_spmv_bit_for_bit(name, backend):
    _, matrix, x, y = traceable_case(name)
    operand, fn = traceable_spmv(matrix, backend=backend)
    for yv in (None, y):
        want = spmv(matrix, x, yv, backend=backend)
        got = fn(operand, x, yv)
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("precision", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(TRACEABLE_CASES))
def test_traceable_fn_against_jax(name, precision):
    coo, matrix, x, y = traceable_case(name, precision)
    _, fmt, kw = TRACEABLE_CASES[name]
    jmat = JAX_CONSTRUCTORS[fmt](_jax_coo(coo), value_dtype=precision,
                             **kw).device_put()
    joperand, jfn = jax_traceable_spmv(jmat)
    operand, fn = traceable_spmv(matrix)
    x64, y64 = x.double().numpy(), y.double().numpy()
    jdt = jax_value_dtype(jmat)
    for yv, y_np in ((None, None), (y, y64)):
        jy = None if y_np is None else jnp.asarray(y_np, jdt)
        want = np.asarray(jax.jit(jfn)(joperand, jnp.asarray(x64, jdt), jy),
                          np.float64)
        got = fn(operand, x, yv).double().numpy()
        assert_rows_close(got, coo, x64, y_np, precision)
        if precision == "bfloat16":
            # the JAX package's XLA path adds in bf16 and the port in f32,
            # so JAX's rows stray further from the oracle (1.4e-2 on DIA);
            # held normwise, as test_torch_ell's bf16 test holds them
            scale = max(float(np.max(np.abs(want))), 1.0)
            np.testing.assert_allclose(got, want, rtol=1e-2,
                                       atol=1e-2 * scale)
        else:
            assert_rows_close(got, coo, x64, y_np, precision, want)


def jax_value_dtype(jmat):
    """The JAX matrix's value type."""
    values = getattr(jmat, "values", None)
    return np.asarray(jmat.data if values is None else values).dtype


def test_sell_to_carries_trivial_reassembly():
    # worked out from `order` on the host at construction; moving the
    # matrix must not read `order` again (a meta tensor cannot be read)
    for name, want in (("sell_trivial", True), ("sell_length_sort", False)):
        _, sm, _, _ = traceable_case(name)
        moved = sm.to("meta")
        assert moved.trivial_reassembly is sm.trivial_reassembly is want
        assert moved.order.device.type == "meta"
        with pytest.raises(NotImplementedError):
            dataclasses.replace(moved, trivial_reassembly=None)


def test_traceable_makes_its_first_call_before_it_returns(monkeypatch):
    calls = []
    real = dispatch.spmv

    def counted(matrix, x, y=None, backend="auto"):
        calls.append((x.abs().sum().item(), y, backend))
        return real(matrix, x, y, backend)
    monkeypatch.setattr(dispatch, "spmv", counted)
    _, matrix, _, _ = traceable_case("csr")
    operand, fn = traceable_spmv(matrix, backend="xla")
    assert operand is matrix
    assert calls == [(0.0, None, "xla")]
    # the CSR's repack, first-use work of the auto backend, is done and
    # cached by then
    traceable_spmv(matrix)
    assert getattr(matrix, "_sell_cache", None) is not None
    with pytest.raises(TypeError, match="no traceable spmv"):
        traceable_spmv(object())


# -- the chained protocol's blocks -------------------------------------------

@pytest.mark.parametrize("name", ["ell", "dia", "sell_split", "hybrid",
                                  "stream"])
def test_chained_blocks_give_the_plain_recurrence(name):
    _, matrix, x, y = traceable_case(name)
    operand, fn = traceable_spmv(matrix)
    iters = 2 * CHAINED_BLOCK + 5
    xk, yk = x.clone(), y.clone()
    for _ in range(iters):
        yk = spmv(matrix, xk, yk)
        xk = yk * CHAINED_SCALE
    with harness._block_loop(fn, operand, x, y) as (start, run):
        for _ in range(2):     # a second run starts from x and y again
            start()
            got = run(iters)
            assert torch.equal(got, yk)
    start, run = harness._eager_loop(fn, operand, x, y)
    start()
    assert torch.equal(run(iters), yk)


def test_chained_protocol_goes_through_traceable_spmv(monkeypatch):
    seen = []

    def recorded(matrix, backend="auto"):
        seen.append(matrix)
        return traceable_spmv(matrix, backend)
    monkeypatch.setattr(dispatch, "traceable_spmv", recorded)
    _, matrix, x, _ = traceable_case("ell")
    res = benchmark_spmv(None, matrix, x, repeat=2, warmup=1,
                         protocol="chained")
    assert seen == [matrix] and res.span_iters >= 8
    res = benchmark_spmv(None, matrix, x, repeat=2, warmup=1)
    assert seen == [matrix]         # per_iter calls the dispatch itself


# -- CG: the masked step ------------------------------------------------------

CG_MATRICES = {"poisson2d(12)": lambda: poisson2d(12),
               "fem_mesh_2d(16)": lambda: fem_mesh_2d(16)}
CG_TOL = {"float64": (1e-8, 1e-10), "float32": (1e-4, 1e-4)}


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("matrix", sorted(CG_MATRICES))
def test_masked_cg_against_jax(matrix, precision):
    coo = CG_MATRICES[matrix]()
    tol, rel = CG_TOL[precision]
    jell = jax_ell.ell_from_coo(_jax_coo(coo), sort_rows=True,
                                value_dtype=precision).device_put()
    jop, jfn = jax_traceable_spmv(jell)
    b = np.random.RandomState(4).rand(coo.num_rows).astype(precision)
    want = jax_cg(lambda op, v: jfn(op, v), jnp.asarray(b), tol=tol,
                  maxiter=500, operand=jop)
    op, fn = traceable_spmv(ell_from_coo(coo, sort_rows=True,
                                         value_dtype=precision))
    got = solvers.cg(lambda o, v: fn(o, v), torch.from_numpy(b), tol=tol,
                     maxiter=500, operand=op)
    assert got.iterations == int(want.iterations) == got.steps
    xj = np.asarray(want.x, np.float64)
    np.testing.assert_allclose(got.x.double().numpy(), xj, rtol=0,
                               atol=rel * np.max(np.abs(xj)))
    assert abs(got.residual_norm - float(want.residual_norm)) \
        <= rel * np.linalg.norm(b)
    eager = solvers.cg_eager(lambda o, v: fn(o, v), torch.from_numpy(b),
                             tol=tol, maxiter=500, operand=op)
    assert (eager.iterations, eager.residual_norm) == (got.iterations,
                                                        got.residual_norm)
    assert torch.equal(eager.x, got.x)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_masked_steps_after_convergence_change_nothing(precision):
    ell = ell_from_coo(fem_mesh_2d(16), sort_rows=True,
                       value_dtype=precision)
    b = torch.from_numpy(np.random.RandomState(5).rand(ell.num_rows)
                         .astype(precision))
    mv, vdot = solvers._operators(lambda v: spmv(ell, v), b, None, None)
    s = solvers.cg_start(mv, vdot, b, None, CG_TOL[precision][0])
    for _ in range(200):
        if not bool(s.active):
            break
        solvers.masked_step(s, mv, vdot)
    assert not bool(s.active) and int(s.k) > 0
    frozen = [t.clone() for t in (s.x, s.r, s.rs, s.k)]
    for _ in range(5):
        solvers.masked_step(s, mv, vdot)
        for t, f in zip((s.x, s.r, s.rs, s.k), frozen):
            assert t.dtype == f.dtype and torch.equal(t, f)
        assert bool(torch.isfinite(s.p).all()) and not bool(s.active)
    # the solve that stopped there took the same steps to the same bits
    res = solvers.cg(lambda v: spmv(ell, v), b, tol=CG_TOL[precision][0])
    assert res.iterations == int(s.k) and torch.equal(res.x, s.x)


@pytest.mark.parametrize("maxiter", [0, 1, 3])
def test_cg_honours_maxiter(maxiter):
    ell = ell_from_coo(poisson2d(10), sort_rows=True)
    b = torch.from_numpy(np.random.RandomState(6).rand(100))
    got = solvers.cg(lambda v: spmv(ell, v), b, tol=1e-14, maxiter=maxiter)
    want = solvers.cg_eager(lambda v: spmv(ell, v), b, tol=1e-14,
                            maxiter=maxiter)
    assert got.iterations == got.steps == want.iterations == maxiter
    assert torch.equal(got.x, want.x)
    assert got.residual_norm == want.residual_norm
