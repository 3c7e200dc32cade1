"""NPB CG, the NAS Parallel Benchmarks' inverse power iteration, on the CPU:
the benchmark's generator (``spmv_bench/generators/npb_cg.py``) against
NPB's ``makea`` written out one draw at a time, the plain reference
(``spmv_bench/reference_npb.py``) and the port's normal path (the chooser,
``traceable_spmv`` and ``models/solvers.power_step``) against NPB's
published ζ at classes S and W, the outer step against the plain
reference on a seeded random SPD matrix, and `pcg_set`'s start from r = b.

Tolerances: ζ within NPB's own verification limit, 1e-10 of the published
value. x is a unit vector; the port and the reference compute the same
operations in fp64 with sums in other orders, which part them by a few
units of the last place (measured: below 1e-15 of the largest |x| after 15
steps at S and W), so x is held within 1e-12 of the reference's largest
|x|.
"""

import numpy as np
import pytest
import torch

from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.formats.stream import stream_from_coo
from ellspmv_tpu_torch.models import multigrid, solvers
from ellspmv_tpu_torch.ops.dispatch import traceable_spmv
from ellspmv_tpu_torch.utils import timing
from spmv_bench import reference, reference_npb
from spmv_bench.generators import Matrix, npb_cg

F64 = torch.float64
#: NPB's classes S and W (npbparams.h) and their nonzeros after makea.
CLASSES = {
    "S": (dict(na=1400, nonzer=7, rcond=0.1, shift=10.0, niter=15,
               zeta_verify=8.5971775078648), 78_148),
    "W": (dict(na=7000, nonzer=8, rcond=0.1, shift=12.0, niter=15,
               zeta_verify=10.362595087124), 508_402),
}
CG_ITERATIONS = 25
ZETA_LIMIT = 1e-10
X_LIMIT = 1e-12


def makea_one_draw_at_a_time(n, nonzer, rcond, shift):
    """NPB's ``makea`` as cg.f writes it, one randlc draw and one entry at
    a time: (rows, cols, values) sorted, duplicates summed in the order
    made, exact zeros dropped."""
    state = npb_cg.SEED

    def randlc():
        nonlocal state
        state = state * npb_cg.AMULT & npb_cg.MASK
        return state * 2.0**-46
    randlc()                               # main's draw
    nn1 = 1
    while nn1 < n:
        nn1 *= 2
    sums = {}
    size, ratio = 1.0, rcond ** (1.0 / n)
    for iouter in range(1, n + 1):
        v, iv = [], []
        while len(v) < nonzer:             # sprnvc
            vecelt, vecloc = randlc(), randlc()
            i = int(nn1 * vecloc) + 1
            if i > n or i in iv:
                continue
            v.append(vecelt)
            iv.append(i)
        if iouter in iv:                   # vecset
            v[iv.index(iouter)] = 0.5
        else:
            v.append(0.5)
            iv.append(iouter)
        for b in range(len(v)):
            scale = size * v[b]
            for a in range(len(v)):
                key = (iv[a] - 1, iv[b] - 1)
                sums[key] = sums[key] + v[a] * scale if key in sums \
                    else v[a] * scale
        size *= ratio
    for i in range(n):
        sums[(i, i)] = sums[(i, i)] + (rcond - shift)
    keys = sorted(k for k, s in sums.items() if s != 0)
    return (np.array([k[0] for k in keys]), np.array([k[1] for k in keys]),
            np.array([sums[k] for k in keys]))


def _make(name):
    params, _ = CLASSES[name]
    return params, npb_cg.generate(params, 2**40 + 1, "cpu")


def test_randlc_in_bulk_is_randlc_one_at_a_time():
    got = npb_cg.randlc_after(npb_cg.SEED, 3 * npb_cg.JUMP + 5)
    state = npb_cg.SEED
    for k, value in enumerate(got):
        state = state * npb_cg.AMULT & npb_cg.MASK
        assert int(value) == state, k


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_generator_is_makea(name):
    params, m = _make(name)
    n, want_nnz = params["na"], CLASSES[name][1]
    rows, cols, values = makea_one_draw_at_a_time(
        n, params["nonzer"], params["rcond"], params["shift"])
    assert m.num_rows == n and m.num_nonzeros == want_nnz
    assert np.array_equal(m.rows.numpy(), rows)
    assert np.array_equal(m.cols.numpy(), cols)
    assert np.array_equal(m.values.numpy(), values)
    assert m.distinct_values == want_nnz
    assert m.referenced_columns == n
    key = m.rows * n + m.cols
    assert bool((key[1:] > key[:-1]).all())        # sorted, no duplicates
    # symmetric in pattern, not in every bit
    a = torch.zeros(n, n, dtype=F64)
    a[m.rows, m.cols] = m.values
    assert torch.equal(a != 0, a.T != 0)
    assert not torch.equal(a, a.T)
    torch.testing.assert_close(a, a.T, rtol=1e-15, atol=0)
    assert npb_cg.made[n] == params
    other = npb_cg.generate(params, 7, "cpu")      # the seed changes nothing
    assert torch.equal(other.values, m.values)


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_reference_zeta_is_npbs(name):
    params, m = _make(name)
    a = reference.Coo(m.num_rows, m.rows, m.cols, m.values)
    x, zeta, rnorm = reference_npb.timed(a, params["niter"], params["shift"],
                                         CG_ITERATIONS)
    want = params["zeta_verify"]
    assert abs(float(zeta) - want) / want <= ZETA_LIMIT
    assert float(rnorm) < 1e-12
    assert float(torch.linalg.vector_norm(x)) == pytest.approx(1, abs=1e-14)


def _port(m, form="auto"):
    coo = CooMatrix(m.num_rows, m.num_rows, m.rows.int().numpy(),
                    m.cols.int().numpy(), m.values.numpy())
    build = {"auto": auto_from_coo, "ell": ell_from_coo,
             "stream": stream_from_coo}[form]
    return traceable_spmv(build(coo))


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_port_normal_path_gives_npbs_zeta(name):
    """The chooser, ``traceable_spmv`` and `power_stepper`, as the
    benchmark's driver runs them: NITER steps from x = 1."""
    params, m = _make(name)
    operand, fn = _port(m)
    s = solvers.power_state(m.num_rows, CG_ITERATIONS)
    step, graph = solvers.power_stepper(s, fn, params["shift"],
                                        operand=operand)
    assert graph is None                           # eager on the CPU
    for _ in range(params["niter"]):
        step()
    want = params["zeta_verify"]
    assert abs(float(s.zeta) - want) / want <= ZETA_LIMIT
    assert int(s.steps) == params["niter"]
    a = reference.Coo(m.num_rows, m.rows, m.cols, m.values)
    x, zeta, rnorm = reference_npb.timed(a, params["niter"], params["shift"],
                                         CG_ITERATIONS)
    assert float((s.x - x).abs().max()) <= X_LIMIT * float(x.abs().max())
    assert abs(float(s.rnorm) - float(rnorm)) < 1e-13


def random_spd(n, per_row, seed):
    """B·Bᵀ + n·I over a seeded random sparse B: SPD, with rows of varied
    length."""
    rng = np.random.default_rng(seed)
    b = np.zeros((n, n))
    for i in range(n):
        cols = rng.choice(n, rng.integers(1, per_row + 1), replace=False)
        b[i, cols] = rng.uniform(-1, 1, cols.size)
    a = b @ b.T + n * np.eye(n)
    rows, cols = np.nonzero(a)
    return n, rows, cols, a[rows, cols]


@pytest.mark.parametrize("form", ["ell", "stream"])
@pytest.mark.parametrize("steps", [1, 4])
def test_outer_step_is_the_references_on_a_random_spd_matrix(form, steps):
    n, rows, cols, values = random_spd(300, 4, seed=11)
    shift = 3.5
    m = Matrix(n, torch.from_numpy(rows), torch.from_numpy(cols),
               torch.from_numpy(values), len(values), n)
    operand, fn = _port(m, form)
    s = solvers.power_state(n, 10)
    a = reference.Coo(n, m.rows, m.cols, m.values)
    x = torch.ones(n, dtype=F64)
    for _ in range(steps):
        solvers.power_step(s, fn, shift, operand=operand)
        x, zeta, rnorm = reference_npb.outer_step(a, x, shift, 10)
    assert float((s.x - x).abs().max()) <= X_LIMIT * float(x.abs().max())
    assert abs(float(s.zeta) - float(zeta)) <= 1e-13 * abs(float(zeta))
    torch.testing.assert_close(s.rnorm, rnorm, rtol=1e-6, atol=1e-14)
    assert int(s.steps) == steps


def _parents_pcg_set(s, matvec, b, precond=None, operand=None):
    """`pcg_set` as it was before it started from r = b: r = b - A·0, and
    r·z taken afresh in every iteration."""
    mv, vdot = solvers._operators(matvec, b, operand, None)
    s.x.zero_()
    torch.sub(b, mv(s.x), out=s.r)
    torch.sqrt(vdot(s.r, s.r), out=s.norms[0])
    for k in range(1, s.norms.numel()):
        z = s.r if precond is None else precond(s.r)
        rz = vdot(s.r, z)
        if k == 1:
            s.p.copy_(z)
        else:
            torch.addcmul(z, rz / s.rz, s.p, out=s.p)
        s.rz.copy_(rz)
        ap = mv(s.p)
        alpha = rz / vdot(s.p, ap)
        s.x.addcmul_(alpha, s.p)
        s.r.addcmul_(alpha, ap, value=-1)
        torch.sqrt(vdot(s.r, s.r), out=s.norms[k])


@pytest.mark.parametrize("grid,depth,vcycle", [
    ((16, 16, 16), 3, True), ((16, 24, 32), 3, True),
    ((32, 32, 32), 4, True), ((16, 16, 16), 1, False)],
    ids=["16^3", "16x24x32", "32^3", "16^3-no-preconditioner"])
def test_pcg_set_from_r_equals_b_is_the_parents_set(grid, depth, vcycle,
                                                    monkeypatch):
    """HPCG's sets (b = A·1, x = 0) bit for bit as the parent's b - A·0
    start gave them, with one multiply fewer; without a preconditioner
    one dot an iteration fewer too."""
    from ellspmv_tpu_torch.ops import dot_cuda
    hierarchy = multigrid.hpcg(*grid, depth=depth)
    lv = hierarchy.levels[0]
    b = lv.fn(lv.matrix, torch.ones(lv.matrix.num_rows, dtype=F64))
    precond = hierarchy if vcycle else None
    iterations = 12
    want = solvers.pcg_set_state(b, iterations)
    _parents_pcg_set(want, lv.fn, b, precond, lv.matrix)
    calls = {"mv": 0, "dot": 0}

    def mv(op, v):
        calls["mv"] += 1
        return lv.fn(op, v)

    def dot(x, y):
        calls["dot"] += 1
        return dot_cuda.vdot(x, y)
    got = solvers.pcg_set_state(b, iterations)
    solvers.pcg_set(got, mv, b, precond=precond, operand=lv.matrix,
                    vdot=dot)
    for a, c in zip(want, got):
        assert torch.equal(a, c)
    assert calls["mv"] == iterations
    assert calls["dot"] == 1 + (3 if vcycle else 2) * iterations


def test_a_step_records_no_span_and_counts_itself():
    params, m = _make("S")
    operand, fn = _port(m)
    s = solvers.power_state(m.num_rows, CG_ITERATIONS)
    with timing.recording() as rec:
        step, graph = solvers.power_stepper(s, fn, params["shift"],
                                            operand=operand)
        for _ in range(3):
            step()
    assert rec.spans == []                         # no capture off a card
    assert int(s.steps) == 3
    # the step restarts the inner solve from z = 0 on the new x
    x = s.x.clone()
    step()
    a = reference.Coo(m.num_rows, m.rows, m.cols, m.values)
    nx, _, _ = reference_npb.outer_step(a, x, params["shift"],
                                        CG_ITERATIONS)
    assert float((s.x - nx).abs().max()) <= X_LIMIT * float(nx.abs().max())
