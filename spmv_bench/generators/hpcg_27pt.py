"""HPCG 3.1's matrix on the device: the 27-point stencil on an nx×ny×nz
grid in natural order (row ``(iz·ny + iy)·nx + ix``), each point coupled
to itself with 26 and to each of its up to 26 neighbours with -1, so SPD
(GenerateProblem_ref in hpcg-benchmark.org's reference code). Rows in
order, columns sorted within each row, no duplicates:
``(3·nx - 2)·(3·ny - 2)·(3·nz - 2)`` entries.

The problem is HPCG's and has no random part: the seed changes nothing.
`distinct_values` counts a symmetric matrix's independent values, (nnz +
n) / 2, a pair (i, j), (j, i) once and the diagonal once, not HPCG's two
constants: the program reads every value as stored.

params: ``nx``, ``ny`` (default nx), ``nz`` (default nx).
"""

from __future__ import annotations

import torch

from spmv_bench.generators import Matrix


def generate(params: dict, seed: int, device) -> Matrix:
    del seed                       # HPCG's problem is the same for any seed
    nx = int(params["nx"])
    ny = int(params.get("ny", nx))
    nz = int(params.get("nz", nx))
    n = nx * ny * nz
    idx = torch.arange(n, device=device)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    neighbours = []                # in increasing column order
    counts = torch.zeros(n, dtype=torch.int64, device=device)
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                ok = ((ix + dx >= 0) & (ix + dx < nx) & (iy + dy >= 0)
                      & (iy + dy < ny) & (iz + dz >= 0) & (iz + dz < nz))
                neighbours.append(((dz * ny + dy) * nx + dx, ok))
                counts += ok
    del ix, iy, iz
    nnz = int(counts.sum())
    fill = torch.cumsum(counts, 0) - counts      # each row's first entry
    rows = torch.repeat_interleave(idx, counts)
    del counts
    cols = torch.empty(nnz, dtype=torch.int64, device=device)
    values = torch.empty(nnz, dtype=torch.float64, device=device)
    for off, ok in neighbours:
        at = fill[ok]
        cols[at] = idx[ok] + off
        values[at] = 26.0 if off == 0 else -1.0
        fill[ok] += 1
    return Matrix(n, rows, cols, values, (nnz + n) // 2, n)
