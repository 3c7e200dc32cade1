"""Row-sharded stream SpMV: power-law matrices over ranks.

Counterpart of ``ellspmv_tpu.parallel.stream``, with its row boundaries
(rows, nonzeros or an explicit list; the nonzeros counted after the
symmetric expansion and the diagonal split), its per-device nonzeros and
its split diagonal (``y[i] += ad[i]*x[i]`` after the sums, ellgemvsd's
epilogue, ellspmv.c:1177).

The JAX package compiles one program for every device, so it forces every
device's sum plan into one layout (``build_stream_sum_uniform``) and pads
every device's product plan to common shapes. Each rank here launches its
own kernels, so each shard is the port's own stream format
(``formats/stream.stream_from_coo``) over the rank's rows: local row ids,
columns remapped into the gathered x layout (``parallel/spmv.x_layout``),
its own plan. A rank then runs the one-device pipeline on its rows (K3
per level, level 1 read as the products, the final gather) after the
allgather of x, in ``parallel/spmv.local_spmv``. The shards are built on the host, in
the calling process. The traceable form (the JAX package's
``sharded_stream_spmv_fn(ss).traceable``) is ``parallel/spmv.
sharded_spmv_fn`` on a stream shard: its pipeline reads nothing back to
the host and sizes every buffer from its plan, so a CUDA graph holds it as
it holds the one-device ``stream_spmv``.
"""

from __future__ import annotations

import numpy as np
import torch

from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.stream import compute_dtype, stream_from_coo
from ellspmv_tpu_torch.parallel.spmv import (Shard, ShardedMatrix,
                                             _block_rows,
                                             boundaries_from_counts,
                                             positions, x_layout)


def stream_boundaries(row_counts: np.ndarray, n_dev: int,
                      partition: str = "rows",
                      rows_per_device=None) -> np.ndarray:
    """The sharded stream's row boundaries: the JAX package's rule, with
    its one error text for a bad ``rows_per_device`` list."""
    if rows_per_device is not None and (
            len(rows_per_device) != n_dev
            or sum(rows_per_device) != len(row_counts)):
        raise ValueError("bad rows-per-device list")
    return boundaries_from_counts(row_counts, n_dev, partition,
                                  rows_per_device)


def shard_stream(coo: CooMatrix, n_devices: int, partition: str = "rows",
                 rows_per_device=None, value_dtype=None,
                 separate_diagonal: bool = False) -> ShardedMatrix:
    """Build one stream-format shard per rank from COO, on the host.
    `value_dtype` is a ``--precision`` name or a torch type (default: the
    COO's values' type)."""
    coo = coo.expand_symmetry()
    n, m = coo.num_rows, coo.num_columns
    nnz_total = coo.num_nonzeros
    dtype = config.value_dtype(coo.values.dtype if value_dtype is None
                               else value_dtype)
    diag = None
    if separate_diagonal:
        coo, diag = coo.split_diagonal()
    counts = np.bincount(coo.rowidx, minlength=n) if n \
        else np.zeros(0, np.int64)
    bounds = stream_boundaries(counts, n_devices, partition, rows_per_device)
    block = _block_rows(bounds)
    xb, x_block, position = x_layout(n, m, bounds, block)
    shards, nnz = [], []
    for d in range(n_devices):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        sel = (coo.rowidx >= lo) & (coo.rowidx < hi)
        local = CooMatrix(block, n_devices * x_block,
                          (coo.rowidx[sel] - lo).astype(np.int64),
                          position[coo.colidx[sel]], coo.values[sel])
        nnz.append(local.num_nonzeros)
        own = None
        if diag is not None:
            part = diag[lo:min(hi, len(diag))]
            own = torch.from_numpy(np.asarray(part, np.float64)).to(
                dtype).to(compute_dtype(dtype))
        shards.append(Shard(
            stream_from_coo(local, value_dtype=dtype, device="cpu"),
            block, x_block, own,
            int(position[lo]) if own is not None and len(own) else 0))
    return ShardedMatrix(shards, bounds, xb, block, x_block, n, m, nnz_total,
                         np.array(nnz, np.int64), compute_dtype(dtype),
                         positions(bounds, block))
