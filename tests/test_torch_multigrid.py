"""HPCG's multigrid PCG in the port (``models/multigrid.py``, K8's plain
version in ``ops/symgs_cuda.py`` and ``models/solvers.pcg_set``) against
the plain reference ``tests/reference_hpcg.py``, on the CPU.

Grids: 16³ and 16×24×32 (not a cube, so that swapped axes show) at three
levels, and 32³ at HPCG's four. Four levels need a fine grid of at least
32 in each dimension: below 4 points a side the coarsest stencil is too
dense for its diagonals to be half full, and at 2³ it is one dense 8×8
block, which the chooser rightly sends to ELL
(`test_a_level_that_is_not_dia_raises`).

Tolerances: port and reference compute in fp64 the same operations on the
same values, with sums taken in another order (the reference's
``index_add_`` over the COO, the port's slots of DIA storage), so each
result differs by the rounding of those sums. A row sums at most 27 terms,
so one update differs by a few units of the last place of its terms' size;
50 iterations of PCG then carry that forward, which the measured gaps show
to stay near 1e-15. The tolerances are 1e-13 on one update and one
V-cycle, and 1e-12 on a 50-iteration set (x against its own size, about 1
in every row; the residual norms against the first): more than fifty
times the gaps measured, and below any gap that a wrong colour, sweep
order, transfer or coefficient gives, which is of the size of x itself.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import spsolve_triangular

import reference_hpcg as ref
from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.dia import dia_from_coo
from ellspmv_tpu_torch.models import multigrid, solvers
from ellspmv_tpu_torch.models.generators import hpcg_27pt
from ellspmv_tpu_torch.ops import symgs_cuda
from ellspmv_tpu_torch.utils import timing

F64 = torch.float64
ONE_STEP = 1e-13
ONE_SET = 1e-12
GRIDS = [((16, 16, 16), 3), ((16, 24, 32), 3), ((32, 32, 32), 4)]
IDS = ["16^3", "16x24x32", "32^3"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """These grids are small and their operations many: one thread does
    them as fast as eight alone, and far faster beside other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", params=GRIDS, ids=IDS)
def pair(request):
    """The port's hierarchy and the reference's, on one grid."""
    grid, depth = request.param
    return (multigrid.hpcg(*grid, depth=depth),
            ref.hierarchy(*grid, depth=depth))


def _rand(n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, generator=g, dtype=F64)


def _b(levels):
    return levels[0].matvec(torch.ones(levels[0].n, dtype=F64))


@pytest.mark.parametrize("grid", [(4, 4, 4), (3, 5, 6), (16, 24, 32)])
def test_generator_is_hpcgs_stencil(grid):
    coo = hpcg_27pt(*grid)
    n, rows, cols, values = ref.stencil_coo(*grid)
    nx, ny, nz = grid
    assert coo.num_rows == coo.num_columns == n == nx * ny * nz
    assert coo.num_nonzeros == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    np.testing.assert_array_equal(coo.rowidx, rows.numpy())
    np.testing.assert_array_equal(coo.colidx, cols.numpy())
    np.testing.assert_array_equal(coo.values, values.numpy())
    a = sp.csr_matrix((coo.values, (coo.rowidx, coo.colidx)), shape=(n, n))
    assert (a != a.T).nnz == 0


@pytest.mark.parametrize("grid", [(4, 4, 4), (3, 5, 6), (16, 24, 32)])
def test_no_two_rows_of_one_colour_couple(grid):
    coo = hpcg_27pt(*grid)
    colour = symgs_cuda.colour_of(grid).numpy()
    off = coo.rowidx != coo.colidx
    assert not (colour[coo.rowidx[off]] == colour[coo.colidx[off]]).any()
    seen = np.zeros(coo.num_rows, int)
    for c in range(8):
        rows = symgs_cuda.colour_rows(grid, c).numpy()
        assert (colour[rows] == c).all()
        seen[rows] += 1
    assert (seen == 1).all()
    if all(g % 2 == 0 for g in grid):   # colour 7 is the coarse points
        np.testing.assert_array_equal(
            np.sort(symgs_cuda.colour_rows(grid, 7).numpy()),
            np.sort(ref.f2c(*grid).numpy()))


@pytest.mark.parametrize("grid", [(4, 4, 4), (3, 5, 6), (16, 24, 32)])
def test_colour_major_holds_each_colours_dia_columns(grid):
    """Column t of colour c's block is the DIA column of the colour's row
    t, for every colour: on (3, 5, 6) the colours differ in size. The
    blocks fill the buffer end to end."""
    dia = dia_from_coo(hpcg_27pt(*grid))
    cm = symgs_cuda.colour_major(dia, grid, dia.offsets.index(0))
    assert cm.values.shape == (dia.num_diags * dia.num_rows,)
    assert cm.offsets == dia.offsets and cm.grid == grid
    counts = [symgs_cuda.colour_count(grid, c) for c in range(8)]
    assert sum(counts) == dia.num_rows
    if grid == (3, 5, 6):
        assert len(set(counts)) > 1
    end = 0
    for c in range(8):
        rows = symgs_cuda.colour_rows(grid, c)
        assert counts[c] == len(rows)
        assert cm.starts[c] == end
        block = cm.block(c)
        assert block.shape == (dia.num_diags, counts[c])
        assert torch.equal(block, dia.data[:, rows])
        end += block.numel()
    assert end == cm.values.numel()


def _natural_colour_update(dia, r, x, grid, colour, slot):
    """One colour of the update on the natural-order DIA array: the plain
    formula before the colour-major copy, the oracle of the copy's
    indexing."""
    n = dia.num_rows
    rows = symgs_cuda.colour_rows(grid, colour)
    j = rows + torch.tensor(dia.offsets)[:, None]
    inside = (j >= 0) & (j < n)
    inside[slot] = False
    products = dia.data[:, rows] * x[j.clamp(0, n - 1)]
    acc = torch.where(inside, products, 0.0).sum(0)
    x[rows] = (r[rows] - acc) / dia.data[slot, rows]


@pytest.mark.parametrize("grid", [(4, 4, 4), (3, 5, 6), (16, 24, 32)])
def test_colour_major_update_equals_the_natural_one_bit_for_bit(grid):
    dia = dia_from_coo(hpcg_27pt(*grid))
    slot = dia.offsets.index(0)
    cm = symgs_cuda.colour_major(dia, grid, slot)
    n = dia.num_rows
    r, x = _rand(n, 6), _rand(n, 7)
    for c in range(8):
        want = x.clone()
        _natural_colour_update(dia, r, want, grid, c, slot)
        got = x.clone()
        symgs_cuda.dia_symgs_torch(cm, r, got, c)
        assert torch.equal(got, want), c
        x = want


def test_every_level_is_dia(pair):
    port, reference = pair
    assert len(port.levels) == len(reference)
    for lv, rl in zip(port.levels, reference):
        assert lv.grid == rl.grid
        assert lv.matrix._auto_choice == "dia"
        assert set(lv.matrix.offsets) == multigrid.stencil_offsets(lv.grid)
        assert lv.colour_major.offsets == lv.matrix.offsets
        assert lv.matrix.offsets[lv.colour_major.diag_slot] == 0


def test_a_level_that_is_not_dia_raises():
    with pytest.raises(ValueError, match="level 3 .*2x2x2.* went to ell"):
        multigrid.hpcg(16, depth=4)


def test_a_grid_that_does_not_halve_raises():
    with pytest.raises(ValueError, match="does not halve"):
        multigrid.hpcg(12, 16, 16, depth=4)


def test_a_matrix_off_its_grid_raises():
    fine = auto_from_coo(hpcg_27pt(8, 8, 8))
    with pytest.raises(ValueError, match="not the 27-point stencil"):
        multigrid.build(fine, (16, 8, 4), depth=2)


def test_the_kernel_refuses_what_it_does_not_take():
    dia = dia_from_coo(hpcg_27pt(4, 4, 4))
    r, x = _rand(64, 0), torch.zeros(64, dtype=F64)
    slot = dia.offsets.index(0)
    cm = symgs_cuda.colour_major(dia, (4, 4, 4), slot)
    with pytest.raises(ValueError, match="not the diagonal"):
        symgs_cuda.dia_symgs(dataclasses.replace(cm, diag_slot=slot + 1),
                             r, x, 0)
    with pytest.raises(ValueError, match="one buffer"):
        symgs_cuda.dia_symgs(cm, x, x, 0)
    with pytest.raises(ValueError, match="grid"):
        symgs_cuda.dia_symgs(dataclasses.replace(cm, grid=(4, 4, 8)), r, x,
                             0)
    with pytest.raises(ValueError, match="values for a 4x4x4 grid"):
        symgs_cuda.dia_symgs(dataclasses.replace(cm, values=cm.values[1:]),
                             r, x, 0)
    with pytest.raises(ValueError, match="starts .* 4x4x4 grid"):
        symgs_cuda.dia_symgs(dataclasses.replace(
            cm, starts=symgs_cuda.colour_starts((4, 4, 4), 26)), r, x, 0)
    with pytest.raises(ValueError, match="colour 8"):
        symgs_cuda.dia_symgs(cm, r, x, 8)
    with pytest.raises(ValueError, match="grid"):
        symgs_cuda.colour_major(dia, (4, 4, 8), slot)
    f32 = dia_from_coo(hpcg_27pt(4, 4, 4), value_dtype="float32")
    with pytest.raises(TypeError, match="fp64"):
        symgs_cuda.dia_symgs(symgs_cuda.colour_major(f32, (4, 4, 4), slot),
                             r.float(), x.float(), 0)


@pytest.mark.parametrize("colour", [0, 5, 7])
def test_one_colour_equals_the_reference(pair, colour):
    port, reference = pair
    lv, rl = port.levels[0], reference[0]
    r, x = _rand(rl.n, 1), _rand(rl.n, 2)
    want = x.clone()
    rl.colour_update(r, want, colour)
    got = x.clone()
    symgs_cuda.dia_symgs(lv.colour_major, r, got, colour)
    others = symgs_cuda.colour_of(lv.grid) != colour
    assert torch.equal(got[others], x[others])
    torch.testing.assert_close(got, want, rtol=ONE_STEP, atol=ONE_STEP)


def test_one_symgs_equals_the_reference(pair):
    port, reference = pair
    r = _rand(reference[0].n, 3)
    want = torch.zeros_like(r)
    reference[0].symgs(r, want)
    port.levels[0].x.zero_()
    port.symgs(0, r)
    torch.testing.assert_close(port.levels[0].x, want, rtol=ONE_STEP,
                               atol=ONE_STEP)


def test_one_vcycle_equals_the_reference(pair):
    port, reference = pair
    r = _rand(reference[0].n, 4)
    want = ref.vcycle(reference, r)
    got = port(r)
    assert got.data_ptr() == port.levels[0].x.data_ptr()
    torch.testing.assert_close(got, want, rtol=ONE_STEP, atol=ONE_STEP)


def test_a_pcg_set_equals_the_reference(pair):
    """50 iterations with tolerance 0: x and every residual norm."""
    port, reference = pair
    b = _b(reference)
    x, norms = ref.pcg_set(reference, b, 50)
    lv = port.levels[0]
    s = solvers.pcg_set_state(b, 50)
    solvers.pcg_set(s, lv.fn, b, precond=port, operand=lv.matrix)
    torch.testing.assert_close(s.x, x, rtol=ONE_SET, atol=0)
    torch.testing.assert_close(s.norms / norms[0], norms / norms[0],
                               rtol=0, atol=ONE_SET)
    # the residual falls: the preconditioner works
    assert float(norms[-1] / norms[0]) < 1e-8


def test_a_second_set_restarts_from_zero():
    port = multigrid.hpcg(16, depth=3)
    lv = port.levels[0]
    b = lv.fn(lv.matrix, torch.ones(lv.matrix.num_rows, dtype=F64))
    s = solvers.pcg_set_state(b, 12)
    solvers.pcg_set(s, lv.fn, b, precond=port, operand=lv.matrix)
    first = [t.clone() for t in s]
    solvers.pcg_set(s, lv.fn, b, precond=port, operand=lv.matrix)
    for a, c in zip(first, s):
        assert torch.equal(a, c)


def test_a_set_without_preconditioner_is_cg():
    """HPCG's recurrence with z = r is CG: the same iterates as `cg_eager`
    up to the rounding of a different grouping."""
    lv = multigrid.hpcg(16, depth=1).levels[0]
    b = lv.fn(lv.matrix, _rand(lv.matrix.num_rows, 5))
    s = solvers.pcg_set_state(b, 20)
    solvers.pcg_set(s, lv.fn, b, operand=lv.matrix)
    plain = solvers.cg_eager(lv.fn, b, tol=0.0, maxiter=20,
                             operand=lv.matrix)
    assert plain.iterations == 20
    torch.testing.assert_close(s.x, plain.x, rtol=ONE_SET, atol=0)
    torch.testing.assert_close(s.norms[-1], torch.tensor(
        plain.residual_norm, dtype=F64), rtol=1e-9, atol=0)


def test_the_vcycle_needs_under_half_of_cgs_iterations():
    """`pcg_set` with the V-cycle reaches ‖r‖/‖r0‖ <= 1e-10 in under half
    the iterations that `pcg_set` without it needs."""
    port = multigrid.hpcg(16, 24, 32, depth=3)
    lv = port.levels[0]
    b = lv.fn(lv.matrix, torch.ones(lv.matrix.num_rows, dtype=F64))
    reached = []
    for precond, iterations in ((port, 40), (None, 80)):
        s = solvers.pcg_set_state(b, iterations)
        solvers.pcg_set(s, lv.fn, b, precond=precond, operand=lv.matrix)
        below = torch.nonzero(s.norms <= 1e-10 * s.norms[0]).flatten()
        assert len(below), f"1e-10 not reached in {iterations} iterations"
        reached.append(int(below[0]))
    vcycle, plain = reached
    assert 2 * vcycle < plain


def test_the_build_is_recorded_in_spans():
    with timing.recording() as rec:
        multigrid.hpcg(16, 24, 32, depth=3)
    (root,) = rec.find("multigrid.build")
    index = rec.spans.index(root)
    assert root.attrs == {"grid": (16, 24, 32), "depth": 3}
    levels = [s for s in rec.children(index) if s.name == "multigrid.level"]
    assert [s.attrs["level"] for s in levels] == [1, 2]
    for s in levels:
        names = [c.name for c in rec.children(rec.spans.index(s))]
        assert names == ["multigrid.generate", "formats.auto_from_coo",
                         "dispatch.first_call", "multigrid.colour_order"]
    # the colour-major copies: level 0's inside the build, the others
    # inside their level; each the size of its level's DIA values
    orders = rec.find("multigrid.colour_order")
    assert [s.attrs["level"] for s in orders] == [0, 1, 2]
    assert orders[0] in rec.children(index)
    for s, n in zip(orders, (16 * 24 * 32, 8 * 12 * 16, 4 * 6 * 8)):
        assert s.attrs["bytes"] == 27 * n * 8


def _lexicographic(levels):
    """HPCG's reference SymGS, in natural order, by triangular solves:
    forward (D+L)·x = r - U·x, then backward (D+U)·x = r - L·x."""
    parts = {}
    for lv in levels:
        a = sp.csr_matrix((lv.values.numpy(), (lv.rows.numpy(),
                                               lv.cols.numpy())),
                          shape=(lv.n, lv.n))
        parts[lv.grid] = (sp.tril(a, format="csr"), sp.triu(a, format="csr"),
                          sp.tril(a, -1, format="csr"),
                          sp.triu(a, 1, format="csr"))

    def symgs(lv, r, x):
        lower, upper, strict_lower, strict_upper = parts[lv.grid]
        rn = r.numpy()
        xn = spsolve_triangular(lower, rn - strict_upper @ x.numpy(),
                                lower=True)
        xn = spsolve_triangular(upper, rn - strict_lower @ xn, lower=False)
        x.copy_(torch.from_numpy(xn))
    return symgs


#: HPCG's validation count at 32³: the iterations the port's 8-colour PCG
#: needs to reach the residual reduction that the reference's
#: lexicographic SymGS reaches in 50. That reduction, about 2e-21, lies
#: below fp64's rounding, where the order of the sums moves the recursive
#: residual by a factor of about 2: on one thread (`one_thread`) the count
#: is 52, on eight threads 53.
VALIDATION_COUNT_32 = 52


def test_hpcg_validation_count_at_32():
    reference = ref.hierarchy(32, 32, 32)
    b = _b(reference)
    _, lex = ref.pcg_set(reference, b, 50, symgs=_lexicographic(reference))
    reduction = float(lex[50] / lex[0])
    port = multigrid.hpcg(32)
    lv = port.levels[0]
    s = solvers.pcg_set_state(b, 60)
    solvers.pcg_set(s, lv.fn, b, precond=port, operand=lv.matrix)
    reached = torch.nonzero(s.norms / s.norms[0] <= reduction).flatten()
    assert int(reached[0]) == VALIDATION_COUNT_32
