"""HPCG's preconditioned CG in plain PyTorch: the tests' reference.

It imports nothing of the port and nothing of JAX, launches no kernel of
its own and captures no graph. The same semantics as
``ellspmv_tpu_torch.models.multigrid`` and the PCG set of
``ellspmv_tpu_torch.models.solvers``, written the plain way:

- the matrix: HPCG 3.1's 27-point stencil on an nx×ny×nz grid in natural
  order, row ``(iz·ny + iy)·nx + ix``, diagonal 26, every neighbour -1;
  as a COO, generated here;
- the colours: point (ix, iy, iz) takes colour
  ``(1 - ix%2) + 2·(1 - iy%2) + 4·(1 - iz%2)``, so the coarse points (all
  coordinates even) are colour 7;
- one SymGS: the forward sweep over colours 0…7, then the backward sweep
  over 7…0; each colour's rows take ``x_i ← (r_i - Σ_{j≠i} a_ij·x_j) /
  a_ii`` from the x that the earlier colours left;
- the V-cycle of HPCG's ComputeMG: x zeroed at the level's entry, one
  SymGS, ``rc = r[f2c] - (A·x)[f2c]`` (injection at (2i, 2j, 2k)), the
  coarse level, ``x[f2c] += xc``, one SymGS; one SymGS alone at the
  coarsest level;
- the PCG set of HPCG's CG.cpp with tolerance 0: x = 0, r = b - A·x,
  then each iteration z = M·r, β from r·z, p, A·p, α, x and r.

Products are summed by ``index_add_`` over the COO, split by colour once,
in blocks of at most `BLOCK` entries.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25


def stencil_coo(nx: int, ny: int, nz: int, dtype=torch.float64):
    """HPCG's matrix as (n, rows, cols, values), row-sorted."""
    n = nx * ny * nz
    i = torch.arange(n)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    rows, cols = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                      & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
                rows.append(i[ok])
                cols.append(i[ok] + (dz * ny + dy) * nx + dx)
    rows, cols = torch.cat(rows), torch.cat(cols)
    order = torch.argsort(rows * n + cols)
    rows, cols = rows[order], cols[order]
    values = torch.where(rows == cols, 26.0, -1.0).to(dtype)
    return n, rows, cols, values


def colours(nx: int, ny: int, nz: int) -> torch.Tensor:
    i = torch.arange(nx * ny * nz)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    return (1 - ix % 2) + 2 * (1 - iy % 2) + 4 * (1 - iz % 2)


def f2c(nx: int, ny: int, nz: int) -> torch.Tensor:
    """The fine rows at the coarse grid's points, in the coarse order."""
    cx, cy, cz = nx // 2, ny // 2, nz // 2
    c = torch.arange(cx * cy * cz)
    ix, iy, iz = 2 * (c % cx), 2 * ((c // cx) % cy), 2 * (c // (cx * cy))
    return (iz * ny + iy) * nx + ix


def _sum_into(out, rows, cols, values, x):
    for lo in range(0, rows.numel(), BLOCK):
        out.index_add_(0, rows[lo:lo + BLOCK],
                       values[lo:lo + BLOCK] * x[cols[lo:lo + BLOCK]])
    return out


class Level:
    """One grid's operator, split by colour once: for colour c, its rows
    and the off-diagonal entries of those rows."""

    def __init__(self, grid, n, rows, cols, values, dtype=torch.float64):
        self.grid, self.n = grid, n
        self.rows, self.cols = rows, cols
        self.values = values.to(dtype)
        diag = rows == cols
        self.diag = torch.zeros(n, dtype=dtype, device=rows.device)
        self.diag[rows[diag]] = self.values[diag]
        colour = colours(*grid).to(rows.device)
        off = ~diag
        self.by_colour = []
        for c in range(8):
            pick = off & (colour[rows] == c)
            self.by_colour.append((torch.nonzero(colour == c).flatten(),
                                   rows[pick], cols[pick],
                                   self.values[pick]))

    def matvec(self, x):
        return _sum_into(torch.zeros_like(x), self.rows, self.cols,
                         self.values, x)

    def colour_update(self, r, x, c):
        """x_i ← (r_i - Σ_{j≠i} a_ij·x_j) / a_ii on colour c's rows."""
        own, rows, cols, values = self.by_colour[c]
        s = _sum_into(torch.zeros_like(x), rows, cols, values, x)
        x[own] = (r[own] - s[own]) / self.diag[own]

    def symgs(self, r, x, order=None):
        order = order or (list(range(8)) + list(range(7, -1, -1)))
        for c in order:
            self.colour_update(r, x, c)


def hierarchy(nx, ny, nz, depth=4, dtype=torch.float64, device="cpu",
              make=stencil_coo):
    """`depth` levels from the nx×ny×nz grid down, each halved in every
    dimension; `make(nx, ny, nz)` gives a level's COO."""
    levels = []
    for _ in range(depth):
        n, rows, cols, values = make(nx, ny, nz)
        levels.append(Level((nx, ny, nz), n, rows.to(device),
                            cols.to(device), values.to(device), dtype))
        nx, ny, nz = nx // 2, ny // 2, nz // 2
    return levels


def vcycle(levels, r, k=0, symgs=None):
    """HPCG's ComputeMG from level k: returns x ≈ A_k^-1 r. `symgs(level,
    r, x)` replaces the smoother (the lexicographic one of the
    validation count)."""
    symgs = symgs or (lambda lv, r, x: lv.symgs(r, x))
    lv = levels[k]
    x = torch.zeros_like(r)
    symgs(lv, r, x)
    if k + 1 < len(levels):
        idx = f2c(*lv.grid).to(r.device)
        rc = r[idx] - lv.matvec(x)[idx]
        x[idx] += vcycle(levels, rc, k + 1, symgs)
        symgs(lv, r, x)
    return x


def pcg_set(levels, b, iterations, precondition=True, symgs=None):
    """HPCG's CG.cpp with tolerance 0 from x = 0: returns x and the
    residual norms ‖r_k‖ for k = 0…iterations."""
    a = levels[0]
    x = torch.zeros_like(b)
    r = b - a.matvec(x)
    norms = [torch.sqrt(torch.dot(r, r))]
    p, rz = None, None
    for _ in range(iterations):
        z = vcycle(levels, r, symgs=symgs) if precondition else r.clone()
        rz_new = torch.dot(r, z)
        p = z.clone() if p is None else z + (rz_new / rz) * p
        rz = rz_new
        ap = a.matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        norms.append(torch.sqrt(torch.dot(r, r)))
    return x, torch.stack(norms)
