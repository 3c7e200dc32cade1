"""HPCG's multigrid preconditioner on the port's DIA path.

HPCG 3.1 (hpcg-benchmark.org; Dongarra, Heroux and Luszczek,
SAND2013-8752) preconditions CG with one V-cycle of four levels over its
27-point stencil (``models/generators.hpcg_27pt``). `build` makes the
hierarchy from level 0's matrix and its grid:

- each coarse grid is the finer one halved in each dimension, and its
  operator is the same stencil generated on its own grid, as HPCG's
  GenerateCoarseProblem does, then converted by the chooser
  (``formats/auto.auto_from_coo``) like any matrix;
- every level must come out DIA, since K2 (``ops/dia_cuda``, through
  ``ops/dispatch.traceable_spmv``) multiplies it and K8
  (``ops/symgs_cuda``) sweeps its values: a level that is not DIA, or
  whose diagonals are not the grid's 27-point stencil, raises. Nothing
  falls back. Values are read as stored: nothing assumes HPCG's constants;
- each level keeps, beside its DIA array, a colour-major copy of its
  values (``symgs_cuda.ColourMajor``), in K8's thread order, so that a
  colour reads every sector it loads; from the natural-order array a
  colour would read every other value of each diagonal and a sweep would
  move the values twice. K2 still multiplies the natural-order array (the
  residual, A·p and b), so the copy costs each level's DIA storage once
  more: 3.62 GB at 256³ and 4.14 GB over HPCG's four levels, in fp64;
- the transfers use HPCG's injection map f2c, fine point (2i, 2j, 2k) for
  coarse point (i, j, k). In natural order that is the fine vector viewed
  as (nz, ny, nx) and stepped by 2 on each axis, so restriction and
  prolongation are one elementwise launch each on such views.

`Hierarchy.vcycle(r)` is HPCG's ComputeMG: at each level x is zeroed, one
SymGS runs before and one after the coarse-grid correction (``rc =
r[f2c] - (A·x)[f2c]``, the coarser level, ``x[f2c] += xc``), and one SymGS
alone at the coarsest level. Every launch's shape follows from the grid and
nothing reads the host, so a V-cycle can be captured in a CUDA graph.

Departures from HPCG's reference:

- the smoother is coloured, which HPCG allows optimised runs (its
  validation then counts the iterations the reordered solver needs): in
  place of the lexicographic sweep, the eight colours of the points'
  parities, which no 27-point coupling joins, are each updated at once by
  K8. One SymGS is the forward sweep over colours `FORWARD` (0…7) and the
  backward sweep over `BACKWARD` (7…0). The coarse points, all of whose
  coordinates are even, are colour 7 (``symgs_cuda.PARITIES``): a colour's
  update does not read its own rows' x, so the colour updated first after
  the prolongation throws the correction at its rows away unread. Last in
  the forward sweep, it has first been read by every other colour;
- one process: the grid is the whole problem, with no halo exchange.
"""

from __future__ import annotations

import dataclasses

import torch

from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.ops import symgs_cuda
from ellspmv_tpu_torch.utils.timing import span

#: HPCG's levels: the fine grid and three coarser ones.
DEPTH = 4
#: The colours of the forward and the backward sweep of one SymGS.
FORWARD = tuple(range(8))
BACKWARD = tuple(reversed(FORWARD))


def stencil_offsets(grid) -> set[int]:
    """The DIA offsets of the 27-point stencil on the nx×ny×nz `grid`."""
    nx, ny, _ = grid
    return {(dz * ny + dy) * nx + dx for dz in (-1, 0, 1)
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)}


def points(v: torch.Tensor, grid) -> torch.Tensor:
    """The view of natural-order `v` at the coarse points (2i, 2j, 2k):
    f2c's rows, in the coarse grid's natural order."""
    nx, ny, nz = grid
    return v.view(nz, ny, nx)[::2, ::2, ::2]


@dataclasses.dataclass
class Level:
    """One grid: its DIA operator, the SpMV that multiplies it, the
    colour-major copy of its values that K8 sweeps, and its vectors: the
    correction x and, below the fine level, the restricted residual r."""
    grid: tuple
    matrix: DiaMatrix
    fn: object
    colour_major: symgs_cuda.ColourMajor
    x: torch.Tensor
    r: torch.Tensor | None

    @property
    def shape(self) -> tuple:
        """The grid as a tensor shape, (nz, ny, nx)."""
        return self.grid[::-1]


class Hierarchy:
    """The levels, finest first; `vcycle` (or a call) applies the
    preconditioner."""

    def __init__(self, levels: list[Level]):
        self.levels = levels

    def sweep(self, k: int, r: torch.Tensor, colours) -> None:
        lv = self.levels[k]
        for c in colours:
            symgs_cuda.dia_symgs(lv.colour_major, r, lv.x, c)

    def symgs(self, k: int, r: torch.Tensor) -> None:
        """One symmetric Gauss-Seidel on level k's x."""
        self.sweep(k, r, FORWARD)
        self.sweep(k, r, BACKWARD)

    def restrict(self, k: int, r: torch.Tensor) -> None:
        """Level k+1's r = r[f2c] - (A·x)[f2c], with K2 over level k."""
        lv, coarse = self.levels[k], self.levels[k + 1]
        ax = lv.fn(lv.matrix, lv.x)
        torch.sub(points(r, lv.grid), points(ax, lv.grid),
                  out=coarse.r.view(coarse.shape))

    def prolong(self, k: int) -> None:
        """Level k's x[f2c] += level k+1's x."""
        lv, coarse = self.levels[k], self.levels[k + 1]
        points(lv.x, lv.grid).add_(coarse.x.view(coarse.shape))

    def vcycle(self, r: torch.Tensor, k: int = 0) -> torch.Tensor:
        """HPCG's ComputeMG from level k: level k's x, which the next
        V-cycle overwrites."""
        lv = self.levels[k]
        lv.x.zero_()
        self.symgs(k, r)
        if k + 1 < len(self.levels):
            self.restrict(k, r)
            self.vcycle(self.levels[k + 1].r, k + 1)
            self.prolong(k)
            self.symgs(k, r)
        return lv.x

    __call__ = vcycle

    def sweeps_per_cycle(self) -> list[int]:
        """Sweeps of each level in one V-cycle (a SymGS is two): K8 launches
        8 for each."""
        last = len(self.levels) - 1
        return [4 if k < last else 2 for k in range(last + 1)]


def _level(matrix, grid, k: int) -> Level:
    from ellspmv_tpu_torch.ops.dispatch import traceable_spmv
    if not isinstance(matrix, DiaMatrix):
        raise ValueError(
            f"multigrid: level {k} ({'x'.join(map(str, grid))}) went to "
            f"{getattr(matrix, '_auto_choice', type(matrix).__name__)}, not "
            "DIA: K8 sweeps DIA storage")
    n = grid[0] * grid[1] * grid[2]
    if matrix.num_rows != n or matrix.num_columns != n:
        raise ValueError(f"multigrid: level {k}'s matrix is "
                         f"{matrix.num_rows}x{matrix.num_columns}, its grid "
                         f"{'x'.join(map(str, grid))}")
    if not set(matrix.offsets) <= stencil_offsets(grid) \
            or 0 not in matrix.offsets:
        raise ValueError(f"multigrid: level {k}'s diagonals are not the "
                         "27-point stencil's with its own: the colours "
                         "would couple")
    operand, fn = traceable_spmv(matrix)
    data = operand.data
    with span("multigrid.colour_order", level=k,
              bytes=data.numel() * data.element_size()):
        colour_major = symgs_cuda.colour_major(operand, grid,
                                               operand.offsets.index(0))
        if data.device.type == "cuda":
            torch.cuda.synchronize(data.device)
    zeros = torch.zeros(n, dtype=data.dtype, device=data.device)
    return Level(grid, operand, fn, colour_major, zeros,
                 zeros.clone() if k else None)


def build(fine, grid, depth: int = DEPTH) -> Hierarchy:
    """The hierarchy from `fine`, level 0's matrix as the chooser built it
    on the nx×ny×nz `grid` (natural order); the coarse operators go to the
    fine one's device. Each dimension must be divisible by
    ``2**(depth-1)``. Recorded in the span ``multigrid.build``, with a
    ``multigrid.level`` (inside it ``multigrid.generate``, the chooser's
    ``formats.*``, ``dispatch.first_call`` and ``multigrid.colour_order``)
    for each coarse level; level 0's ``dispatch.first_call`` and
    ``multigrid.colour_order`` lie directly inside the build's span."""
    grid = tuple(int(g) for g in grid)
    step = 2 ** (depth - 1)
    if depth < 1 or any(g < step or g % step for g in grid):
        raise ValueError(f"multigrid: a {'x'.join(map(str, grid))} grid "
                         f"does not halve {depth - 1} times")
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.models.generators import hpcg_27pt
    with span("multigrid.build", grid=grid, depth=depth):
        levels = [_level(fine, grid, 0)]
        device = levels[0].matrix.device
        for k in range(1, depth):
            grid = tuple(g // 2 for g in grid)
            with span("multigrid.level", level=k, grid=grid):
                with span("multigrid.generate"):
                    coo = hpcg_27pt(*grid)
                levels.append(_level(auto_from_coo(coo, device=device),
                                     grid, k))
        return Hierarchy(levels)


def hpcg(nx: int, ny: int | None = None, nz: int | None = None,
         depth: int = DEPTH, device="cpu") -> Hierarchy:
    """HPCG's problem on an nx×ny×nz grid: level 0 generated and chosen as
    the coarse ones are, then `build`."""
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.models.generators import hpcg_27pt
    grid = (nx, ny or nx, nz or nx)
    return build(auto_from_coo(hpcg_27pt(*grid), device=device), grid, depth)
