"""A whole pass over the multi-device path on small shapes, the counterpart
of ``__graft_entry__.dryrun_multichip``:

    python -m ellspmv_tpu_torch.parallel.dryrun [N] [--device=cuda|cpu]

On `n_devices` ranks (the programs' placement: rank r on card r, or, with
``--device=cpu``, N ranks on the CPU; the smoke run passes four ranks
sharing one card). Like the programs, it runs on the cards unless asked for
the CPU, and exits 1 without a card or with fewer cards than ranks. the row-sharded ELL SpMV with the
allgather of x against the oracle at rtol 1e-12, on the kernels and on the
``xla`` backend's plain versions; a chained benchmark step; CG over the
sharded operator with its dots all-reduced; and the sharded stream format
on ``power_law(1024, 5, seed=1)``. The JAX dryrun's double-double CG has
no counterpart (fp64 is native here). Prints one summary line; any failed
check raises.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     placement: list[str] | None = None) -> str:
    """Run the checks on `n_devices` ranks (on `placement` when given) and
    return the summary line, which is also printed."""
    from ellspmv_tpu_torch.bench.harness import benchmark_sharded
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.generators import poisson2d, power_law
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    from ellspmv_tpu_torch.parallel import mesh
    from ellspmv_tpu_torch.parallel.launch import RankPool
    from ellspmv_tpu_torch.parallel.solver import solve_sharded
    from ellspmv_tpu_torch.parallel.spmv import run_spmv, shard_matrix
    from ellspmv_tpu_torch.parallel.stream import shard_stream

    devices = placement or mesh.placement(n_devices, device)
    coo = poisson2d(8)                 # 64 rows, 5-point stencil
    ell = ell_from_coo(coo, value_dtype="float64", sort_rows=True)
    sm = shard_matrix(ell, len(devices))
    want1 = coo_spmv_numpy(coo, np.ones(64))
    ones = torch.ones(64, dtype=torch.float64)
    with RankPool(devices) as pool:
        # one SpMV step (the allgather of x, then K1 on each rank)
        launches = []
        y = run_spmv(pool, sm, ones, launches=launches)
        np.testing.assert_allclose(y.numpy(), want1, rtol=1e-12)
        k1 = sum(c["ell_spmv"] for c in launches)
        # the xla backend: the plain version on each rank's device
        y_xla = run_spmv(pool, sm, ones, backend="xla")
        np.testing.assert_allclose(y_xla.numpy(), want1, rtol=1e-12)
        # a chained benchmark step over the ranks
        bres = benchmark_sharded(pool, sm, ones, repeat=2, warmup=1,
                                 protocol="chained", matrix=ell)
        if not (bres.best > 0 and torch.isfinite(bres.y).all()):
            raise AssertionError("the chained step gave no time or a y "
                                 "that is not finite")
        # CG over the sharded operator (dots all-reduced)
        sol = solve_sharded(pool, sm, ones, tol=1e-10, maxiter=200)
        np.testing.assert_allclose(coo_spmv_numpy(coo, sol["x"]),
                                   np.ones(64), rtol=1e-8, atol=1e-8)
        # the sharded stream format (each rank's own plan) on a power law
        pcoo = power_law(1024, 5, seed=1)
        ss = shard_stream(pcoo, len(devices), value_dtype="float64")
        xs = np.linspace(0.5, 1.5, pcoo.num_columns)
        ys = run_spmv(pool, ss, torch.from_numpy(xs)).numpy()
        want = coo_spmv_numpy(pcoo, xs)
        scale = max(float(np.max(np.abs(want))), 1.0)
        np.testing.assert_allclose(ys, want, rtol=1e-12,
                                   atol=1e-12 * scale)
    line = (f"dryrun_multichip({len(devices)}): SpMV [K1 on every rank, "
            f"{k1} launches] rtol=1e-12 PASS + xla backend rtol=1e-12 PASS"
            " + sharded-STREAM rtol=1e-12 PASS + chained-bench + CG OK "
            f"(cg iters={sol['iterations']}, "
            f"residual={sol['residual_norm']:.2e}; "
            f"{mesh.describe(devices)})")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    from ellspmv_tpu_torch.cli.common import card_missing
    from ellspmv_tpu_torch.parallel import mesh

    argv = sys.argv[1:] if argv is None else argv
    n, device = 8, "cuda"
    for arg in argv:
        if arg.startswith("--device="):
            device = arg.split("=", 1)[1]
        else:
            n = int(arg)
    if card_missing("dryrun", device):
        return 1
    try:
        devices = mesh.placement(n, device)
    except ValueError as e:
        sys.stderr.write(f"dryrun: {e}\n")
        return 1
    dryrun_multichip(n, placement=devices)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
