"""The 10th DIMACS Implementation Challenge's random geometric graph
(``rgg_n_2_<scale>_s0``; Holtgrewe, Sanders and Schulz, IPDPS 2010) as a
symmetric matrix, on the device.

2^scale points are drawn uniformly in the unit square [0, 1)²; an edge
joins two points whose Euclidean distance is below
``r = radius_factor·√(ln n / n)`` (0.55 in the challenge, which makes the
graph connected almost surely). No self-loops. Each edge gets one weight,
uniform on [0, 1), stored as (i, j) and (j, i); rows are sorted row-major,
with columns sorted within each row. Vertices that no edge touches are
empty rows.

The vertices are numbered by grid cell: k×k square cells of side
``1/k ≥ r`` (``k = ⌊1/r⌋``), taken row-major, the points inside a cell in
the order drawn. That is the order a cell-list neighbour search leaves,
and it keeps each row's columns within three rows of cells. The search
itself runs over that grid: each point against the points of its own cell
and of the four neighbouring cells ahead of it, one offset at a time and
in chunks of points, so that the candidate pairs stay a few GB.

The graph is one point set, as the challenge's ``_s0`` is: the points are
drawn on the CPU from a generator seeded with `POINTS_SEED`, the same in
every run and on every device, so its longest row (which sets the
ELLPACK's width, and so the multiply's bytes) is too. The run's `seed`
draws the weights.

params: ``scale``, ``radius_factor``.
"""

from __future__ import annotations

import math

import torch

from spmv_bench.generators import Matrix, referenced_columns

#: Cell offsets (dx, dy) searched from each point's cell: its own and the
#: four of the eight neighbours that lie ahead of it in the cell order,
#: so that each pair of points is met once.
OFFSETS = ((0, 0), (1, 0), (-1, 1), (0, 1), (1, 1))
#: Points a step of the search takes at a time.
CHUNK = 1 << 22
#: The seed of the one point set. At 2^24 its longest row is 41 (40 to 42
#: over seeds 0-7, each slot 2.4% of K1's bytes): a point set drawn per
#: run would move the multiply's bytes with the run's seed.
POINTS_SEED = 0


def radius(n: int, factor: float) -> float:
    return factor * math.sqrt(math.log(n) / n)


def drawn_points(params: dict) -> torch.Tensor:
    """The (n, 2) points in [0, 1)², in the order drawn, on the CPU."""
    g = torch.Generator().manual_seed(POINTS_SEED)
    return torch.rand(1 << int(params["scale"]), 2, generator=g,
                      dtype=torch.float64)


def cells(xy: torch.Tensor, r: float) -> tuple[torch.Tensor, int]:
    """Each point's cell, ``cy·k + cx``, on a k×k grid of side ``1/k ≥ r``,
    and k."""
    k = max(int(1.0 / r), 1)
    c = (xy * k).long().clamp_(0, k - 1)
    return c[:, 1] * k + c[:, 0], k


def numbered_points(params: dict, device):
    """The points in vertex order on `device`: sorted by cell, stably, so
    that a cell keeps its points in the order drawn. Returns the points,
    their cells, k and r."""
    n = 1 << int(params["scale"])
    r = radius(n, float(params["radius_factor"]))
    xy = drawn_points(params).to(device)
    cell, k = cells(xy, r)
    cell, order = torch.sort(cell, stable=True)
    return xy[order], cell, k, r


def edges(xy: torch.Tensor, cell: torch.Tensor, k: int,
          r: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Each edge once, as (i, j) with i < j in the cell order of `OFFSETS`:
    the pairs of points in a cell and in the cells around it whose
    squared distance is below r²."""
    n, device = xy.shape[0], xy.device
    count = torch.bincount(cell, minlength=k * k)
    start = torch.cumsum(count, 0) - count
    r2 = r * r
    found_i, found_j = [], []
    for lo in range(0, n, CHUNK):
        src = torch.arange(lo, min(lo + CHUNK, n), device=device)
        cx, cy = cell[src] % k, cell[src] // k
        for dx, dy in OFFSETS:
            tx, ty = cx + dx, cy + dy
            ok = (tx >= 0) & (tx < k) & (ty < k)
            s, t = src[ok], (ty * k + tx)[ok]
            per = count[t]
            total = int(per.sum())
            rep = torch.repeat_interleave(
                torch.arange(s.numel(), device=device), per,
                output_size=total)
            first = torch.cumsum(per, 0) - per
            i = s[rep]
            j = start[t][rep] + torch.arange(total, device=device) \
                - first[rep]
            del rep
            d = xy[i] - xy[j]
            keep = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] < r2
            del d
            if (dx, dy) == (0, 0):
                keep &= j > i
            found_i.append(i[keep])
            found_j.append(j[keep])
            del i, j, keep
    return torch.cat(found_i), torch.cat(found_j)


def generate(params: dict, seed: int, device) -> Matrix:
    xy, cell, k, r = numbered_points(params, device)
    n = xy.shape[0]
    i, j = edges(xy, cell, k, r)
    del xy, cell
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    weight = torch.rand(i.numel(), generator=g, dtype=torch.float64,
                        device=device)
    key, order = torch.sort(torch.cat([i * n + j, j * n + i]))
    del i, j
    distinct = weight.numel()
    values = torch.cat([weight, weight])[order]
    del weight, order
    rows, cols = key // n, key % n
    del key
    return Matrix(n, rows, cols, values, distinct, referenced_columns(cols, n))
