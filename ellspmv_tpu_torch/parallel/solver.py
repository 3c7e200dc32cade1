"""Conjugate gradient over a row-sharded matrix: the CG of
``models/solvers`` on every rank's blocks.

Counterpart of the JAX package's generic sharded CG (``models.solvers.cg``
over ``parallel.spmv.sharded_spmv_fn``, the solve of ``cgsolve
--devices=N``, one ``lax.while_loop`` with the collectives inside). Each
rank holds its block of every vector in the shard's layout
(``parallel/spmv.py``: a square matrix's x and y share it), the matvec is
`sharded_spmv` (the allgather of x, then the rank's kernels), and a dot
product is the rank's local dot (K6 for fp64, ``ops/dot_cuda``; its plain
version on the CPU) followed by an ``all_reduce`` of the sum.

On NCCL ranks, a card each, the loop is ``models.solvers.cg``: one masked
step through ``sharded_spmv_fn``, captured in a CUDA graph that holds the
allgather and the all_reduces, replayed, its iteration count read a step
behind; on CPU ranks the same step runs eagerly. Gloo ranks that share a card
cannot be captured (``parallel.mesh.traceable_loops``) and run
``cg_eager``, which reads the convergence test on the host every
iteration. Either way every rank reads the same all-reduced r·r, so every
rank runs the same iterations and the same steps, and their collectives
pair up.

The JAX package's ``cg_dd_sharded`` carries fp64 as f32 pairs because the
TPU has no fp64; native fp64 CG computes the same thing, so it has no
counterpart.
"""

from __future__ import annotations

import time

import torch

from ellspmv_tpu_torch.models.solvers import CgResult, cg, cg_eager
from ellspmv_tpu_torch.parallel.launch import Rank, RankPool, kernel_launches
from ellspmv_tpu_torch.parallel.spmv import (Shard, ShardedMatrix,
                                             sharded_spmv, sharded_spmv_fn)


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
               maxiter: int = 1000, eager: bool = False) -> CgResult:
    """In a rank: CG for the square SPD matrix of `shard` with this rank's
    block of b; returns this rank's block of x. `cg` over
    `sharded_spmv_fn` with `sharded_vdot` where
    ``parallel.mesh.traceable_loops`` holds (captured on a card), else, or
    given `eager`, `cg_eager` over `sharded_spmv`. Every rank must call it
    alike."""
    from ellspmv_tpu_torch.parallel.mesh import traceable_loops
    if shard.x_block != shard.block:
        raise ValueError("CG needs a square (SPD) matrix")
    if traceable_loops(b.device) and not eager:
        operand, fn = sharded_spmv_fn(shard)
        return cg(fn, b, tol=tol, maxiter=maxiter, operand=operand,
                  vdot=sharded_vdot)
    return cg_eager(lambda v: sharded_spmv(shard, v), b, tol=tol,
                    maxiter=maxiter, vdot=sharded_vdot)


def cg_task(rank: Rank, shard: Shard, b_block: torch.Tensor, tol: float,
            maxiter: int, eager: bool = False,
            trace_dir: str | None = None) -> dict:
    """A task: `cg_sharded` on this rank's device. Its block of x (fp64
    NumPy), the iterations, the steps (masked ones included), the residual
    norm, the seconds from the start of CG until x is on the host (the
    most of any rank) and the kernels' launches; `trace_dir` makes the
    rank write its trace of the solve there (``utils/trace.py``)."""
    from ellspmv_tpu_torch.parallel.spmv import max_over_ranks, placed
    from ellspmv_tpu_torch.utils.trace import device_trace
    shard = placed(rank, shard)
    b = b_block.to(rank.device)
    before = kernel_launches()
    with device_trace(trace_dir):
        t0 = time.perf_counter()
        res = cg_sharded(shard, b, tol, maxiter, eager)
        x = res.x.double().cpu().numpy()
        seconds = time.perf_counter() - t0
    seconds = max_over_ranks([seconds])[0]
    after = kernel_launches()
    return {"x": x, "iterations": res.iterations, "steps": res.steps,
            "residual_norm": res.residual_norm, "seconds": seconds,
            "launches": {k: after[k] - before[k] for k in after}}


def masked_steps_task(rank: Rank, shard: Shard, b_block: torch.Tensor,
                      tol: float, extra: int, maxiter: int = 1000) -> dict:
    """A task, the check that masked steps change nothing once CG has
    converged: ``models.solvers.masked_step`` through `sharded_spmv_fn`
    and `sharded_vdot` until the all-reduced flag falls, then `extra` more
    steps. Returns whether x, r, r·r and the count kept their bits on this
    rank through every extra step (the flag down, p finite), and the
    iterations."""
    from ellspmv_tpu_torch.models.solvers import cg_start, masked_step
    from ellspmv_tpu_torch.parallel.spmv import placed
    operand, fn = sharded_spmv_fn(placed(rank, shard))

    def mv(v):
        return fn(operand, v)

    s = cg_start(mv, sharded_vdot, b_block.to(rank.device), None, tol)
    for _ in range(maxiter):
        if not bool(s.active):
            break
        masked_step(s, mv, sharded_vdot)
    kept = [t.clone() for t in (s.x, s.r, s.rs, s.k)]
    unchanged = not bool(s.active)
    for _ in range(extra):
        masked_step(s, mv, sharded_vdot)
        unchanged = (unchanged and not bool(s.active)
                     and bool(torch.isfinite(s.p).all())
                     and all(torch.equal(t, k) for t, k in
                             zip((s.x, s.r, s.rs, s.k), kept)))
    return {"unchanged": unchanged, "iterations": int(s.k)}


def solve_sharded(pool: RankPool, sm: ShardedMatrix, b: torch.Tensor,
                  tol: float = 1e-8, maxiter: int = 1000,
                  eager: bool = False,
                  trace_dir: str | None = None) -> dict:
    """Solve A x = b over the pool's ranks: `cg_task` in every rank.
    Returns x (logical, fp64 NumPy), the iterations, the steps, the
    residual norm, the seconds, each rank's (iterations, steps) and each
    rank's kernel launches."""
    bs = sm.split_y(b)
    outs = pool.run(cg_task, [(sm.shards[r], bs[r], tol, maxiter, eager,
                               trace_dir) for r in range(sm.world)])
    return {"x": sm.join_y([o["x"] for o in outs]).double().numpy(),
            "iterations": outs[0]["iterations"], "steps": outs[0]["steps"],
            "residual_norm": outs[0]["residual_norm"],
            "seconds": outs[0]["seconds"],
            "rank_steps": [(o["iterations"], o["steps"]) for o in outs],
            "launches": [o["launches"] for o in outs]}
