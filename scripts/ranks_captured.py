#!/usr/bin/env python3
"""The loops over ranks through the sharded traceable form, one rank a
card over NCCL, against one device.

    python3 scripts/ranks_captured.py [N] [--nx NX] [--device=cuda|cpu]

On fem_mesh_2d(NX) (default 1440: 2,073,600 rows) as a sorted-row fp64
ELL, row-sharded over N ranks (default 4) placed as the programs place
them (rank r on card r over NCCL; ``--device=cpu``: N gloo ranks on the
CPU, a rehearsal at a small NX):

- y of 2*64 + 5 chained iterations, captured (``run_chained``) and
  launched eagerly, each bit-equal to the same recurrence on one device
  (card 0, captured);
- the chained slope over the ranks (``benchmark_sharded``, repeat 10,
  warmup 2), captured and eager, each y bit-equal to the one-device
  recurrence of its length, beside one device's captured slope; the
  per_iter call over the ranks beside one device's;
- CG (b = ones, tol 1e-8, maxiter 1000) captured and eager over the
  ranks: the iterations and each rank's steps (which must agree), whether
  the two x are bit-equal, the true residual, one device's iterations;
- the CG step captured and eager (the slope of solves of 20 and 220
  steps that never converge, best of 2).

Every call to the ranks has a deadline, so a rank stuck in a collective
fails the run instead of hanging it. Prints the cards' names and power
limits, then one JSON line per measurement; exits 1 if a check fails.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

#: Seconds any one call to the ranks may take.
DEADLINE = 300.0
CG_TOL, CG_MAXITER = 1e-8, 1000
CG_SLOPE_STEPS = (20, 220)


class _Deadline:
    """A rank pool whose every `run` has `DEADLINE` unless given one."""

    def __init__(self, pool):
        self._pool = pool

    def run(self, fn, args, timeout=None):
        return self._pool.run(fn, args, timeout or DEADLINE)

    def __getattr__(self, name):
        return getattr(self._pool, name)


def emit(**line) -> None:
    print(json.dumps(line), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("ranks", nargs="?", type=int, default=4)
    ap.add_argument("--nx", type=int, default=1440)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args()

    import torch

    from ellspmv_tpu_torch.bench.harness import (CHAINED_BLOCK, _block_loop,
                                                 benchmark_sharded,
                                                 benchmark_spmv, run_chained,
                                                 shard_bench_task)
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d
    from ellspmv_tpu_torch.models.solvers import cg
    from ellspmv_tpu_torch.ops.dispatch import traceable_spmv
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    from ellspmv_tpu_torch.parallel.launch import RankPool
    from ellspmv_tpu_torch.parallel.mesh import describe, placement
    from ellspmv_tpu_torch.parallel.solver import solve_sharded
    from ellspmv_tpu_torch.parallel.spmv import shard_matrix

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("ranks_captured: no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=120)
        print(smi.stdout.strip(), flush=True)
    devices = placement(args.ranks, args.device)
    one_dev = torch.device("cuda:0" if args.device == "cuda" else "cpu")
    failed = []

    def check(ok, what):
        if not ok:
            failed.append(what)
            print(f"ranks_captured: FAIL: {what}", file=sys.stderr,
                  flush=True)

    t0 = time.perf_counter()
    coo = fem_mesh_2d(args.nx)
    n = coo.num_rows
    ell = ell_from_coo(coo, sort_rows=True, value_dtype="float64")
    sm = shard_matrix(ell, args.ranks)
    x = torch.from_numpy(np.random.RandomState(41).rand(n))
    ones = torch.ones(n, dtype=torch.float64)
    card = ell.to(one_dev)
    operand, fn = traceable_spmv(card)
    emit(what="set-up", matrix=f"fem_mesh_2d({args.nx})", rows=n,
         nonzeros=coo.num_nonzeros, ranks=describe(devices),
         seconds=time.perf_counter() - t0)

    def one_chained(iters):
        xc = x.to(one_dev)
        with _block_loop(fn, operand, xc, torch.zeros_like(xc)) as (start,
                                                                     run):
            start()
            return run(iters).cpu()

    one_slope = benchmark_spmv(None, card, x.to(one_dev), repeat=10,
                               warmup=2, protocol="chained")
    one_call = benchmark_spmv(None, card, x.to(one_dev), repeat=10,
                              warmup=2)
    one_cg = cg(lambda op, v: fn(op, v), ones.to(one_dev), tol=CG_TOL,
                maxiter=CG_MAXITER, operand=operand)

    with RankPool(devices) as raw:
        pool = _Deadline(raw)
        iters = 2 * CHAINED_BLOCK + 5
        want = one_chained(iters)
        equal = {}
        for name in ("captured", "eager"):
            got = run_chained(pool, sm, x, iters, eager=name == "eager")
            equal[name] = bool(torch.equal(got, want))
            check(equal[name], f"chained y ({iters} iterations, {name}) "
                  "differs from one device's")
        emit(what="chained y", iterations=iters, bit_equal=equal)

        captured = benchmark_sharded(pool, sm, x, repeat=10, warmup=2,
                                     protocol="chained", matrix=ell)
        xs = sm.split_x(x)
        eager = pool.run(shard_bench_task,
                         [(sm.shards[r], xs[r], None, 10, 2, "chained",
                           "auto", False, None, True)
                          for r in range(sm.world)])
        eager_y = sm.join_y([o["y"] for o in eager])
        for name, y, span in (("captured", captured.y, captured.span_iters),
                              ("eager", eager_y, eager[0]["span"])):
            check(torch.equal(y, one_chained(2 + span)),
                  f"chained slope's y ({name}) differs from one device's")
        per_iter = benchmark_sharded(pool, sm, x, repeat=10, warmup=2,
                                     matrix=ell)
        emit(what="chained slope ms", captured=captured.best * 1e3,
             eager=eager[0]["times"][0] * 1e3,
             one_device=one_slope.best * 1e3,
             spans=[captured.span_iters, eager[0]["span"],
                    one_slope.span_iters],
             per_iter=per_iter.best * 1e3,
             per_iter_one_device=one_call.best * 1e3,
             k1_launches=[c["ell_spmv"] for c in captured.rank_launches])

        sols = {name: solve_sharded(pool, sm, ones, tol=CG_TOL,
                                    maxiter=CG_MAXITER,
                                    eager=name == "eager")
                for name in ("captured", "eager")}
        for name, sol in sols.items():
            check(len(set(sol["rank_steps"])) == 1,
                  f"CG {name}: the ranks disagree: {sol['rank_steps']}")
            r = np.ones(n) - coo_spmv_numpy(coo, sol["x"])
            rel = float(np.linalg.norm(r) / np.sqrt(n))
            check(rel <= 10 * CG_TOL, f"CG {name}: true residual {rel:.3e}")
            check(abs(sol["iterations"] - one_cg.iterations) <= 1,
                  f"CG {name}: {sol['iterations']} iterations against "
                  f"{one_cg.iterations} on one device")
        emit(what="CG", iterations={k: v["iterations"]
                                    for k, v in sols.items()},
             rank_steps={k: v["rank_steps"] for k, v in sols.items()},
             one_device_iterations=one_cg.iterations,
             x_bit_equal=bool(np.array_equal(sols["captured"]["x"],
                                             sols["eager"]["x"])),
             x_max_diff=float(np.max(np.abs(sols["captured"]["x"]
                                            - one_cg.x.cpu().numpy()))))
        lo, hi = CG_SLOPE_STEPS
        step = {}
        for name in ("captured", "eager"):
            spans = [min(solve_sharded(pool, sm, ones, tol=0.0, maxiter=m,
                                       eager=name == "eager")["seconds"]
                         for _ in range(2)) for m in (lo, hi)]
            step[name] = (spans[1] - spans[0]) / (hi - lo) * 1e3
        emit(what="CG step ms", **step)
    emit(what="done", failed=failed, seconds=time.perf_counter() - t0)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
