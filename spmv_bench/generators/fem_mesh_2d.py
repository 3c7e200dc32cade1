"""Jittered-mesh FEM matrix in banded node order, on the device.

The class of ``ellspmv_tpu_torch.models.generators.fem_mesh_2d`` (a NumPy
generator on the host), rewritten in torch: nodes on an nx×ny grid in
row-major order, each coupled to itself, its 8-neighbourhood and `extras`
random neighbours on the distance-2 ring, symmetrised; one random normal
value per unordered pair; the diagonal `diagonal` + U(0, 1), which keeps
the matrix SPD (its off-diagonal part has spectral radius about
2·sqrt(row length) < `diagonal`). The offsets stay within the 5×5
stencil, so the matrix has at most 25 diagonals.

params: ``nx``, ``ny`` (default nx), ``extras``, ``diagonal``.
"""

from __future__ import annotations

import torch

from spmv_bench.generators import Matrix, referenced_columns

# the distance-2 ring, one of each pair (i, j), (j, i): (di, dj) > (0, 0)
_RING = [(di, dj) for di in (-2, -1, 0, 1, 2) for dj in (-2, -1, 0, 1, 2)
         if max(abs(di), abs(dj)) == 2 and (di, dj) > (0, 0)]


def generate(params: dict, seed: int, device) -> Matrix:
    nx = int(params["nx"])
    ny = int(params.get("ny", nx))
    extras = int(params["extras"])
    diagonal = float(params["diagonal"])
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    n = nx * ny
    idx = torch.arange(n, device=device)
    ii, jj = idx // ny, idx % ny

    def inside(di, dj):
        return ((ii + di >= 0) & (ii + di < nx)
                & (jj + dj >= 0) & (jj + dj < ny))

    rows, cols = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            r = idx[inside(di, dj)]
            rows.append(r)
            cols.append(r + di * ny + dj)
    ring = torch.tensor(_RING, device=device)
    for _ in range(extras):
        pick = ring[torch.randint(0, len(_RING), (n,), generator=g,
                                  device=device)]
        di, dj = pick[:, 0], pick[:, 1]
        ok = inside(di, dj)
        r = idx[ok]
        c = r + di[ok] * ny + dj[ok]
        rows += [r, c]
        cols += [c, r]
    key = torch.unique(torch.cat(rows) * n + torch.cat(cols))   # sorted
    del rows, cols
    r, c = key // n, key % n
    del key
    pair = torch.minimum(r, c) * n + torch.maximum(r, c)
    uniq, inv = torch.unique(pair, return_inverse=True)
    del pair
    values = torch.randn(uniq.numel(), generator=g, dtype=torch.float64,
                         device=device)[inv]
    distinct = uniq.numel()
    del uniq, inv
    diag = r == c
    values[diag] = diagonal + torch.rand(int(diag.sum()), generator=g,
                                         dtype=torch.float64, device=device)
    return Matrix(n, r, c, values, distinct, referenced_columns(c, n))
