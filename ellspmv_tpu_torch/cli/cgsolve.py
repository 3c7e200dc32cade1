"""`cgsolve` on PyTorch: conjugate-gradient solve of A x = b over the SpMV
kernels, the counterpart of ``ellspmv_tpu.cli.cgsolve``.

    cgsolve [OPTION..] A [b]

Options as in the JAX program: -z (gzip), -q, -v, --tol, --maxiter,
--precision=float64|float32, --devices and --reorder=none|rcm, plus
--device=cuda|cpu (default cuda; without a card the program exits 1 and
never moves to the CPU by itself). b defaults to ones. Prints x as a Matrix
Market vector; exits 2 when the residual norm is above 10·tol·‖b‖.
--devices=N above 1 solves over N ranks (``parallel/solver.cg_sharded``:
the rows sharded, x allgathered for each matvec, the dots all-reduced) in
native fp64 or f32, placed as ``ellspmv --devices=N`` places them.

Run as ``python -m ellspmv_tpu_torch.cli.cgsolve``.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from ellspmv_tpu_torch.cli.common import CliError, _split_eq, card_missing


def solve(coo, b: np.ndarray, tol: float = 1e-8, maxiter: int = 1000,
          precision: str = "float64", reorder: str = "none",
          device="cuda", devices: list[str] | None = None):
    """Solve A x = b for the square COO `coo` on `device`: optional RCM
    reordering of A and b, sorted-row ELL, CG through `ops.dispatch.spmv`;
    or, given `devices` (``parallel.mesh.placement``), the ELL built on the
    host, row-sharded and solved over one rank per entry.

    Returns x in the original order (float64 NumPy), the `CgResult` and
    the seconds from the start of CG until x is on the host."""
    import torch

    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.solvers import cg
    from ellspmv_tpu_torch.ops.dispatch import spmv

    b = b.astype(precision)
    rm = None
    if reorder == "rcm":
        from ellspmv_tpu_torch.models.reorder import reorder_rcm
        rm = reorder_rcm(coo)
        coo = rm.coo
        b = rm.permute_x(b)
    if devices:
        x, res, seconds = _solve_over_ranks(coo, b, tol, maxiter, precision,
                                            devices)
    else:
        ell = ell_from_coo(coo, sort_rows=True, value_dtype=precision,
                           device=device)
        bt = torch.from_numpy(b).to(device).to(value_dtype(precision))
        t0 = time.perf_counter()
        res = cg(lambda v: spmv(ell, v), bt, tol=tol, maxiter=maxiter)
        x = res.x.double().cpu().numpy()
        seconds = time.perf_counter() - t0
    if rm is not None:
        x = rm.unpermute_y(x)
    return x, res, seconds


def _solve_over_ranks(coo, b, tol, maxiter, precision, devices):
    """The sharded solve: the sorted-row ELL on the host, cut into row
    shards, `parallel.solver.solve_sharded` over a pool of ranks. The
    seconds are the ranks' (the most of any), from the start of CG until x
    is on the host."""
    import torch

    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.solvers import CgResult
    from ellspmv_tpu_torch.parallel.launch import RankPool
    from ellspmv_tpu_torch.parallel.solver import solve_sharded
    from ellspmv_tpu_torch.parallel.spmv import shard_matrix

    ell = ell_from_coo(coo, sort_rows=True, value_dtype=precision)
    sm = shard_matrix(ell, len(devices))
    with RankPool(devices) as pool:
        out = solve_sharded(pool, sm,
                            torch.from_numpy(b).to(value_dtype(precision)),
                            tol=tol, maxiter=maxiter)
    res = CgResult(torch.from_numpy(out["x"]), out["iterations"],
                   out["residual_norm"])
    return out["x"], res, out["seconds"]


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    program = "cgsolve"
    gzip_flag = False
    tol = 1e-8
    maxiter = 1000
    precision = "float64"
    devices = 1
    reorder = "none"
    device = "cuda"
    verbose = 0
    quiet = False
    positional = []
    i = 0
    try:
        while i < len(argv):
            arg = argv[i]
            if not arg.startswith("-"):
                positional.append(arg)
            elif arg in ("-z", "--gzip", "--gunzip", "--ungzip"):
                gzip_flag = True
            elif arg in ("-q", "--quiet"):
                quiet = True
            elif arg in ("-v", "--verbose"):
                verbose += 1
            elif (v := _split_eq(arg, "--tol")) is not False:
                tol = float(v if v is not None else argv[(i := i + 1)])
            elif (v := _split_eq(arg, "--maxiter")) is not False:
                maxiter = int(v if v is not None else argv[(i := i + 1)])
            elif (v := _split_eq(arg, "--precision")) is not False:
                precision = v if v is not None else argv[(i := i + 1)]
                if precision not in ("float64", "float32"):
                    raise CliError("--precision must be float64 or float32")
            elif (v := _split_eq(arg, "--devices")) is not False:
                devices = int(v if v is not None else argv[(i := i + 1)])
            elif (v := _split_eq(arg, "--reorder")) is not False:
                reorder = v if v is not None else argv[(i := i + 1)]
                if reorder not in ("none", "rcm"):
                    raise CliError("--reorder must be none or rcm")
            elif (v := _split_eq(arg, "--device")) is not False:
                device = v if v is not None else argv[(i := i + 1)]
                if device not in ("cuda", "cpu"):
                    raise CliError("--device must be cuda or cpu")
            elif arg in ("-h", "--help"):
                sys.stdout.write(__doc__)
                return 0
            else:
                raise CliError(f"unrecognized option '{arg}'")
            i += 1
        if not positional:
            sys.stderr.write(f"Usage: {program} [OPTION..] A [b]\n")
            return 1
    except (CliError, ValueError, IndexError) as e:
        sys.stderr.write(f"{program}: {e}\n")
        return 1
    if card_missing(program, device):
        return 1
    ranks = None
    if devices > 1:
        from ellspmv_tpu_torch.parallel.mesh import describe, placement
        try:
            ranks = placement(devices, device)
        except ValueError as e:
            sys.stderr.write(f"{program}: {e}\n")
            return 1
        if verbose:
            sys.stderr.write(f"devices: {describe(ranks)}\n")

    import torch

    from ellspmv_tpu_torch.io.mtx import read_matrix, read_vector, write_vector

    try:
        coo = read_matrix(positional[0], gzipped=gzip_flag or None)
    except Exception as e:
        sys.stderr.write(f"{program}: {positional[0]}: {e}\n")
        return 1
    if coo.num_rows != coo.num_columns:
        sys.stderr.write(f"{program}: CG needs a square (SPD) matrix\n")
        return 1
    n = coo.num_rows
    if len(positional) > 1:
        try:
            b = read_vector(positional[1], gzipped=gzip_flag or None)
        except Exception as e:
            sys.stderr.write(f"{program}: {positional[1]}: {e}\n")
            return 1
        if len(b) != n:
            sys.stderr.write(f"{program}: b has length {len(b)}, "
                             f"expected {n}\n")
            return 1
    else:
        b = np.ones(n)

    x, res, seconds = solve(coo, b, tol=tol, maxiter=maxiter,
                            precision=precision, reorder=reorder,
                            device=torch.device(device), devices=ranks)
    if verbose:
        sys.stderr.write(
            f"cg: {res.iterations} iterations, residual "
            f"{res.residual_norm:.3e}, {seconds:.3f} seconds\n")
    if not quiet:
        write_vector(sys.stdout, x)
    bnorm = np.linalg.norm(b.astype(precision))
    return 0 if res.residual_norm <= tol * bnorm * 10 else 2


if __name__ == "__main__":
    raise SystemExit(main())
