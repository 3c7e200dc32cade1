"""Benchmark matrix generators, built directly as COO so that benchmarks need
no large files on disk. Each gives arrays identical to its counterpart in
``ellspmv_tpu.models.generators`` for the same arguments and seed:

- `poisson2d`: 2-D 5-point Poisson stencil (5 nnz/row, no ELL padding);
- `banded_random`: random banded matrix (bounded bandwidth, no local
  smoothness);
- `fem_mesh_2d`: jittered-mesh FEM matrix in banded node order, the stand-in
  for the reference's published Lynx68_reordered.mtx (README:130);
- `power_law`: skewed rows and hub columns, the webbase-1M class that the
  stream format serves (BASELINE.json configs[3]).
"""

from __future__ import annotations

import numpy as np

from ellspmv_tpu_torch.formats.coo import CooMatrix


def _index_dtype(n: int):
    return np.int32 if n < 2**31 else np.int64


def poisson2d(nx: int, ny: int | None = None) -> CooMatrix:
    """5-point Laplacian on an nx×ny grid, natural (row-major) ordering.

    Row i=(r,c) couples to (r±1,c) and (r,c±1) with -1, diagonal 4.
    """
    if ny is None:
        ny = nx
    n = nx * ny
    idx = np.arange(n, dtype=np.int64)
    r, c = idx // ny, idx % ny
    rows = [idx]
    cols = [idx]
    vals = [np.full(n, 4.0)]
    for (dr, dc) in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        rr, cc = r + dr, c + dc
        ok = (rr >= 0) & (rr < nx) & (cc >= 0) & (cc < ny)
        rows.append(idx[ok])
        cols.append((rr * ny + cc)[ok])
        vals.append(np.full(ok.sum(), -1.0))
    idx_dt = _index_dtype(n)
    return CooMatrix(n, n, np.concatenate(rows).astype(idx_dt),
                     np.concatenate(cols).astype(idx_dt),
                     np.concatenate(vals))


def banded_random(n: int, nnz_per_row: int, bandwidth: int,
                  seed: int = 0) -> CooMatrix:
    """Random matrix with `nnz_per_row` entries per row, columns uniform in
    a ±bandwidth window around the diagonal; duplicate (row, col) pairs are
    dropped."""
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), nnz_per_row)
    off = rng.randint(-bandwidth, bandwidth + 1, size=n * nnz_per_row)
    cols = np.clip(rows + off, 0, n - 1)
    _, keep = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.randn(len(rows))
    idx_dt = _index_dtype(n)
    return CooMatrix(n, n, rows.astype(idx_dt), cols.astype(idx_dt), vals)


def fem_mesh_2d(nx: int, ny: int | None = None, extras: int = 4,
                seed: int = 0) -> CooMatrix:
    """Unstructured-FEM-like mesh matrix in banded node order.

    Nodes sit on an nx×ny grid in row-major order. Each couples to itself,
    its 8-neighbourhood and `extras` random distance-2-ring neighbours,
    symmetrised (about 13-21 nnz/row for extras=4). Values are random, one
    per unordered pair, with a diagonal boosted to keep the matrix SPD.
    """
    if ny is None:
        ny = nx
    rng = np.random.RandomState(seed)
    n = nx * ny
    ii, jj = np.divmod(np.arange(n, dtype=np.int64), ny)

    rows_l, cols_l = [], []
    for di in (-1, 0, 1):
        for dj in (-1, 0, 1):
            ok = ((ii + di >= 0) & (ii + di < nx)
                  & (jj + dj >= 0) & (jj + dj < ny))
            rows_l.append(np.flatnonzero(ok).astype(np.int64))
            cols_l.append(rows_l[-1] + di * ny + dj)
    ring = np.array([(di, dj) for di in (-2, -1, 0, 1, 2)
                     for dj in (-2, -1, 0, 1, 2)
                     if max(abs(di), abs(dj)) == 2 and (di, dj) > (0, 0)],
                    dtype=np.int64)
    for _ in range(extras):
        pick = ring[rng.randint(0, len(ring), size=n)]
        di, dj = pick[:, 0], pick[:, 1]
        ok = ((ii + di >= 0) & (ii + di < nx)
              & (jj + dj >= 0) & (jj + dj < ny))
        r = np.flatnonzero(ok).astype(np.int64)
        c = r + di[ok] * ny + dj[ok]
        rows_l.append(np.concatenate([r, c]))
        cols_l.append(np.concatenate([c, r]))
    rows = np.concatenate(rows_l)
    cols = np.concatenate(cols_l)
    _, keep = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[keep], cols[keep]
    pair = np.minimum(rows, cols) * n + np.maximum(rows, cols)
    uniq, inv = np.unique(pair, return_inverse=True)
    pair_vals = rng.randn(len(uniq))
    vals = pair_vals[inv]
    diag = rows == cols
    vals[diag] = 24.0 + rng.rand(diag.sum())
    idx_dt = _index_dtype(n)
    return CooMatrix(n, n, rows.astype(idx_dt), cols.astype(idx_dt), vals)


def power_law(n: int, avg_nnz_per_row: int, alpha: float = 1.8,
              seed: int = 0, value_dtype=np.float64) -> CooMatrix:
    """Skewed matrix: row lengths ~ Zipf(alpha) capped at n, columns chosen
    by preferential attachment (hub columns), a webbase-like structure;
    duplicate (row, col) pairs are dropped."""
    rng = np.random.RandomState(seed)
    raw = rng.zipf(alpha, size=n).astype(np.int64)
    counts = np.minimum(raw, n)
    scale = counts.sum() / (avg_nnz_per_row * n)
    counts = np.maximum(1, (counts / max(scale, 1e-9)).astype(np.int64))
    counts = np.minimum(counts, n)
    rows = np.repeat(np.arange(n, dtype=np.int64), counts)
    popularity = 1.0 / np.arange(1, n + 1) ** 0.8
    popularity /= popularity.sum()
    cols = rng.choice(n, size=len(rows), p=popularity)
    _, keep = np.unique(rows * n + cols, return_index=True)
    rows, cols = rows[keep], cols[keep]
    vals = rng.randn(len(rows)).astype(value_dtype)
    idx_dt = _index_dtype(n)
    return CooMatrix(n, n, rows.astype(idx_dt), cols.astype(idx_dt), vals)
