"""The yardstick of ``hpcg_256.pcg``'s roofline metrics: the least bytes of
HPCG's passes, from the grids alone.

A level's matrix is the 27-point stencil on its grid: n rows and
``(3·nx - 2)·(3·ny - 2)·(3·nz - 2)`` nonzeros. It is symmetric, so no
storage holds fewer than its independent values, (nnz + n) / 2: a pair
once and the diagonal once (the generator's `distinct_values`). HPCG's
values are two constants, but the program reads every value as stored,
so the counts do not take them as known. Each vector is read or written
once a pass. fp64: 8 bytes a value.
"""

from __future__ import annotations

VALUE_BYTES = 8


def rows(grid) -> int:
    nx, ny, nz = grid
    return nx * ny * nz


def nonzeros(grid) -> int:
    nx, ny, nz = grid
    return (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)


def distinct_values(grid) -> int:
    return (nonzeros(grid) + rows(grid)) // 2


def grids(fine, depth: int) -> list[tuple]:
    """The levels' grids, finest first, each halved in every dimension."""
    out = [tuple(fine)]
    for _ in range(depth - 1):
        out.append(tuple(g // 2 for g in out[-1]))
    return out


def sweep_bytes(grid) -> int:
    """One Gauss-Seidel sweep (eight colours) of a level: its independent
    values, r read, x read and written."""
    return VALUE_BYTES * (distinct_values(grid) + 3 * rows(grid))


def spmv_bytes(grid) -> int:
    """One ``y = A·x``: the values, x read, y written."""
    return VALUE_BYTES * (distinct_values(grid) + 2 * rows(grid))


def vcycle_bytes(levels: list[tuple]) -> int:
    """One V-cycle: at each level x zeroed and its sweeps (two SymGS of
    two sweeps each, one SymGS at the coarsest); above the coarsest the
    residual's SpMV, the restriction (r and A·x read at the coarse points,
    rc written) and the prolongation (x read and written at the coarse
    points, xc read)."""
    total = 0
    for k, grid in enumerate(levels):
        last = k == len(levels) - 1
        total += VALUE_BYTES * rows(grid) + (2 if last else 4) \
            * sweep_bytes(grid)
        if not last:
            coarse = rows(levels[k + 1])
            total += spmv_bytes(grid) + VALUE_BYTES * 6 * coarse
    return total


def pcg_iteration_bytes(levels: list[tuple]) -> int:
    """One PCG iteration: the V-cycle, A·p, the dots r·z and p·A·p (two
    vectors each) and r·r (one), and the updates of p, x and r (two
    vectors read and one written each)."""
    n = rows(levels[0])
    return vcycle_bytes(levels) + spmv_bytes(levels[0]) \
        + VALUE_BYTES * (2 + 2 + 1 + 3 * 3) * n
