"""HPCG's preconditioned CG in plain torch: the benchmark's reference for
``hpcg_256.pcg``. It imports nothing of the port and takes nothing the
port made: the fine level is the generator's COO, made again from the
seed, and each coarse level comes from the same generator
(``generators/hpcg_27pt.py``) on its own grid.

The semantics, those of HPCG 3.1's reference code with its smoother
coloured:

- the colours: point (ix, iy, iz) takes colour ``(1 - ix%2) + 2·(1 -
  iy%2) + 4·(1 - iz%2)``, so the coarse points (all coordinates even) are
  colour 7; no two points of one colour couple in a 27-point stencil;
- one SymGS: the forward sweep over colours 0…7, then the backward sweep
  over 7…0; the rows of a colour take ``x_i ← (r_i - Σ_{j≠i} a_ij·x_j) /
  a_ii`` from the x that the earlier colours left;
- the V-cycle (ComputeMG): x zeroed at each level's entry, one SymGS,
  ``rc = r[f2c] - (A·x)[f2c]`` (injection at (2i, 2j, 2k)), the coarser
  level, ``x[f2c] += xc``, one SymGS; at the coarsest level one SymGS;
- the PCG set (CG.cpp with tolerance 0): x = 0, r = b - A·x, then each
  iteration z = M·r, rz = r·z, p = z (first) or z + (rz/rz_old)·p, A·p,
  α = rz/(p·A·p), x += α·p, r -= α·A·p.

Products are summed by ``index_add_`` over the COO, split by colour once,
in blocks of at most `BLOCK` entries. Each level's entries are put in the
order of their diagonal (col - row), then row, once: neighbouring entries
of a block then add into different rows, which the card's atomic adds
take without contention.
"""

from __future__ import annotations

import torch

from spmv_bench.generators import hpcg_27pt

BLOCK = 1 << 25


def colours(grid, device) -> torch.Tensor:
    nx, ny, nz = grid
    i = torch.arange(nx * ny * nz, device=device)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    return (1 - ix % 2) + 2 * (1 - iy % 2) + 4 * (1 - iz % 2)


def f2c(grid, device) -> torch.Tensor:
    """The fine rows at the coarse grid's points, in the coarse order."""
    nx, ny, nz = grid
    cx, cy, cz = nx // 2, ny // 2, nz // 2
    c = torch.arange(cx * cy * cz, device=device)
    ix, iy, iz = 2 * (c % cx), 2 * ((c // cx) % cy), 2 * (c // (cx * cy))
    return (iz * ny + iy) * nx + ix


def _sum_into(out, rows, cols, values, x):
    for lo in range(0, rows.numel(), BLOCK):
        out.index_add_(0, rows[lo:lo + BLOCK],
                       values[lo:lo + BLOCK] * x[cols[lo:lo + BLOCK]])
    return out


class Level:
    """One grid's operator in `dtype`, split by colour once: for colour c,
    its rows and the off-diagonal entries of those rows."""

    def __init__(self, grid, n, rows, cols, values, dtype):
        device = rows.device
        self.grid, self.n = grid, n
        order = torch.argsort(cols - rows, stable=True)
        self.rows, self.cols = rows[order], cols[order]
        self.values = values[order].to(dtype)
        del order
        diag = self.rows == self.cols
        self.diag = torch.zeros(n, dtype=dtype, device=device)
        self.diag[self.rows[diag]] = self.values[diag]
        colour = colours(grid, device)
        row_colour = colour[self.rows]
        self.by_colour = []
        for c in range(8):
            pick = ~diag & (row_colour == c)
            self.by_colour.append((torch.nonzero(colour == c).flatten(),
                                   self.rows[pick], self.cols[pick],
                                   self.values[pick]))

    def matvec(self, x):
        return _sum_into(torch.zeros_like(x), self.rows, self.cols,
                         self.values, x)

    def colour_update(self, r, x, c):
        own, rows, cols, values = self.by_colour[c]
        s = _sum_into(torch.zeros_like(x), rows, cols, values, x)
        x[own] = (r[own] - s[own]) / self.diag[own]

    def symgs(self, r, x):
        for c in list(range(8)) + list(range(7, -1, -1)):
            self.colour_update(r, x, c)


def hierarchy(fine, grid, depth: int, dtype=torch.float64) -> list[Level]:
    """`depth` levels: `fine` (a ``reference.Coo``) on the nx×ny×nz `grid`,
    then each grid halved, its COO from the benchmark's generator."""
    levels = [Level(grid, fine.n, fine.rows, fine.cols, fine.values, dtype)]
    device = fine.rows.device
    for _ in range(depth - 1):
        grid = tuple(g // 2 for g in grid)
        m = hpcg_27pt.generate(dict(zip(("nx", "ny", "nz"), grid)), 0,
                               device)
        levels.append(Level(grid, m.num_rows, m.rows, m.cols, m.values,
                            dtype))
    return levels


def vcycle(levels, r, k=0):
    lv = levels[k]
    x = torch.zeros_like(r)
    lv.symgs(r, x)
    if k + 1 < len(levels):
        idx = f2c(lv.grid, r.device)
        rc = r[idx] - lv.matvec(x)[idx]
        x[idx] += vcycle(levels, rc, k + 1)
        lv.symgs(r, x)
    return x


def pcg_set(levels, b, iterations):
    """One set from x = 0: x and the residual norms ‖r_k‖, k = 0…
    `iterations`."""
    a = levels[0]
    x = torch.zeros_like(b)
    r = b - a.matvec(x)
    norms = [torch.sqrt(torch.dot(r, r))]
    p = rz = None
    for _ in range(iterations):
        z = vcycle(levels, r)
        rz_new = torch.dot(r, z)
        p = z.clone() if p is None else z + (rz_new / rz) * p
        rz = rz_new
        ap = a.matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        norms.append(torch.sqrt(torch.dot(r, r)))
    return x, torch.stack(norms)
