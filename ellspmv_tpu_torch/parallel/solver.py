"""Conjugate gradient over a row-sharded matrix: the CG of
``models/solvers.cg_eager`` on every rank's blocks.

Counterpart of the JAX package's generic sharded CG (``models.solvers.cg``
over ``parallel.spmv.sharded_spmv_fn``, the solve of ``cgsolve
--devices=N``). Each rank holds its block of every vector in the shard's
layout (``parallel/spmv.py``: a square matrix's x and y share it), the
matvec is `sharded_spmv` (the allgather of x, then the rank's kernels),
and a dot product is the rank's local dot (K6 for fp64, ``ops/dot_cuda``;
its plain version on the CPU) followed by an ``all_reduce`` of the sum.
The convergence test reads the all-reduced value, so every rank stops at
the same iteration.

The JAX package's ``cg_dd_sharded`` carries fp64 as f32 pairs because the
TPU has no fp64; native fp64 CG computes the same thing, so it has no
counterpart.
"""

from __future__ import annotations

import time

import torch

from ellspmv_tpu_torch.models.solvers import CgResult, cg_eager
from ellspmv_tpu_torch.parallel.launch import Rank, RankPool, kernel_launches
from ellspmv_tpu_torch.parallel.spmv import Shard, ShardedMatrix, sharded_spmv


def sharded_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Σ a·b over every rank's blocks: the local dot (K6 in fp64 on a
    card), then an all_reduce of the partial sums."""
    import torch.distributed as dist

    from ellspmv_tpu_torch.ops import dot_cuda
    part = dot_cuda.vdot(a, b) if a.dtype == torch.float64 else \
        torch.dot(a, b)
    dist.all_reduce(part.view(1))
    return part


def cg_sharded(shard: Shard, b: torch.Tensor, tol: float = 1e-8,
               maxiter: int = 1000) -> CgResult:
    """In a rank: CG for the square SPD matrix of `shard` with this rank's
    block of b; returns this rank's block of x. The loop is `cg_eager`'s,
    launched eagerly: its matvec's allgather and its dots' all_reduce are
    collectives between the ranks' processes, which a CUDA graph cannot
    hold over gloo (NCCL's capture is later work, ROADMAP)."""
    if shard.x_block != shard.block:
        raise ValueError("CG needs a square (SPD) matrix")
    return cg_eager(lambda v: sharded_spmv(shard, v), b, tol=tol,
                    maxiter=maxiter, vdot=sharded_vdot)


def cg_task(rank: Rank, shard: Shard, b_block: torch.Tensor, tol: float,
            maxiter: int) -> dict:
    """A task: `cg_sharded` on this rank's device. Its block of x (fp64
    NumPy), the iterations, the residual norm, the seconds from the start
    of CG until x is on the host (the most of any rank) and the kernels'
    launches."""
    from ellspmv_tpu_torch.parallel.spmv import max_over_ranks, placed
    shard = placed(rank, shard)
    b = b_block.to(rank.device)
    before = kernel_launches()
    t0 = time.perf_counter()
    res = cg_sharded(shard, b, tol, maxiter)
    x = res.x.double().cpu().numpy()
    seconds = max_over_ranks([time.perf_counter() - t0])[0]
    after = kernel_launches()
    return {"x": x, "iterations": res.iterations,
            "residual_norm": res.residual_norm, "seconds": seconds,
            "launches": {k: after[k] - before[k] for k in after}}


def solve_sharded(pool: RankPool, sm: ShardedMatrix, b: torch.Tensor,
                  tol: float = 1e-8, maxiter: int = 1000) -> dict:
    """Solve A x = b over the pool's ranks: `cg_task` in every rank. Returns
    x (logical, fp64 NumPy), the iterations, the residual norm, the
    seconds, and each rank's kernel launches."""
    bs = sm.split_y(b)
    outs = pool.run(cg_task, [(sm.shards[r], bs[r], tol, maxiter)
                              for r in range(sm.world)])
    return {"x": sm.join_y([o["x"] for o in outs]).double().numpy(),
            "iterations": outs[0]["iterations"],
            "residual_norm": outs[0]["residual_norm"],
            "seconds": outs[0]["seconds"],
            "launches": [o["launches"] for o in outs]}
