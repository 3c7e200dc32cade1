"""Headline benchmark of the port: fp64 SpMV effective bandwidth on one
card, the counterpart of the repository's ``bench.py``.

    python -m ellspmv_tpu_torch.bench.headline [--device=cuda|cpu]

Prints ONE JSON line on stdout:

    {"metric": "spmv_fp64_effective_bandwidth", "value": N, "unit": "GB/s",
     "vs_baseline": N}

and one config line on stderr. The configuration is ``bench.py``'s:
``fem_mesh_2d(1440)`` (2,073,600 rows, about 32.3M nonzeros), a
jittered-mesh FEM matrix in banded order, the stand-in for the reference's
Lynx68_reordered.mtx, in fp64, through the format chooser (``auto_from_coo``,
which takes DIA here: the mesh lives on 25 diagonals), timed with the
chained protocol (repeat 10, warmup 2). ``BENCH_FORMAT=ell`` pins ELLPACK;
``BENCH_GEN=banded`` takes a random banded matrix (16 nonzeros per row,
band ``BENCH_BAND``, default 512) instead; ``BENCH_ROWS`` sets the rows.

The value is the effective bandwidth on the reference's ELLPACK min-bytes
model (ellspmv.c:1858: padded ellsize * (value + index) + x + y), so that it
compares with the reference's 148 GB/s whatever format was chosen. A format
that moves fewer bytes than ELLPACK's minimum (DIA stores no column indices)
can read above the card's peak; the config line therefore also gives the
physical share, the kernel's own bytes (bench/traffic.py) over the time
against the card's peak, which stays at or below 100%.

One clean multiply is held against the exact oracle on 1000 sampled rows
(relative error at most 1e-11, else exit 1). With ``--device=cuda`` (the
default) and no card, the program exits 1.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REFERENCE_GBPS = 148.0    # README:135-144, best-iteration effective GB/s
NNZ_PER_ROW = 16          # banded configuration only


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    device_name = "cuda"
    for arg in argv:
        if arg.startswith("--device="):
            device_name = arg.split("=", 1)[1]
        else:
            print(f"headline: unrecognized argument {arg!r}", file=sys.stderr)
            return 1
    if device_name not in ("cuda", "cpu"):
        print("headline: --device must be cuda or cpu", file=sys.stderr)
        return 1

    import torch

    from ellspmv_tpu_torch.cli.common import card_missing
    if card_missing("headline", device_name):
        return 1
    device = torch.device(device_name)

    from ellspmv_tpu_torch.bench.harness import SpmvMetrics, benchmark_spmv
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.generators import banded_random, fem_mesh_2d
    from ellspmv_tpu_torch.ops.dispatch import spmv
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy

    n_rows = int(os.environ.get("BENCH_ROWS", 2_073_600))
    gen = os.environ.get("BENCH_GEN", "mesh")
    if gen == "mesh":
        coo = fem_mesh_2d(int(round(n_rows ** 0.5)))
    else:
        coo = banded_random(n_rows, NNZ_PER_ROW,
                            int(os.environ.get("BENCH_BAND", 512)), seed=0)
    n = coo.num_rows
    if os.environ.get("BENCH_FORMAT", "auto") == "ell":
        mat = ell_from_coo(coo, sort_rows=True, value_dtype="float64",
                           device=device)
        chosen = "ell"
    else:
        mat = auto_from_coo(coo, sort_rows=True, value_dtype="float64",
                            device=device)
        chosen = mat._auto_choice
    x = np.random.RandomState(1).rand(n)
    xt = torch.from_numpy(x).to(device)

    # effective bandwidth on the reference's ELLPACK min-bytes basis
    rowsize = int(np.bincount(coo.rowidx, minlength=n).max())
    ellsize = n * rowsize
    metrics = SpmvMetrics(
        num_nonzeros=coo.num_nonzeros, num_flops=2 * ellsize,
        min_bytes=n * 8 + coo.num_columns * 8 + ellsize * (8 + 4),
        max_bytes=n * 8 + ellsize * (8 + 4 + 8))
    res = benchmark_spmv(None, mat, xt, repeat=10, warmup=2,
                         protocol="chained", metrics=metrics)

    # correctness spot check: the chained y accumulates many iterations, so
    # one clean multiply is held against the oracle on the sampled rows
    idx = np.random.RandomState(2).choice(n, 1000, replace=False)
    sel = np.isin(coo.rowidx, idx)
    want = coo_spmv_numpy(CooMatrix(n, coo.num_columns, coo.rowidx[sel],
                                    coo.colidx[sel], coo.values[sel]),
                          x)[idx]
    got = spmv(mat, xt)[torch.from_numpy(idx).to(device)].double().cpu()
    rel = float(np.max(np.abs(got.numpy() - want)
                       / np.maximum(np.abs(want), 1e-300)))
    if not rel <= 1e-11:
        print(f"CORRECTNESS FAILURE: max rel err {rel}", file=sys.stderr)
        return 1

    gbps = res.min_gb_per_s()
    print(json.dumps({
        "metric": "spmv_fp64_effective_bandwidth",
        "value": round(gbps, 2),
        "unit": "GB/s",
        "vs_baseline": round(gbps / REFERENCE_GBPS, 3),
    }))
    if res.hbm_peak is None:
        shares = f"no device-memory peak known for {res.device}"
    else:
        shares = (f"effective {100 * res.roofline_fraction():.1f}% of the "
                  f"card's {res.hbm_peak / 1e12:.2f} TB/s peak by the "
                  f"reference's ELLPACK min-bytes model; physical "
                  f"{res.actual_gb_per_s():.1f} GB/s = "
                  f"{100 * res.physical_roofline():.1f}% of that peak "
                  f"({res.actual_bytes / 1e6:.0f} MB moved per multiply)")
    print(f"  config: {gen}, {n} rows, {coo.num_nonzeros} nnz "
          f"(rowsize {rowsize}), fp64, format={chosen}, on {res.device}, "
          f"{res.best * 1e3:.3f} ms/iter (chained slope over "
          f"{res.span_iters} iterations), {res.gnz_per_s():.2f} Gnz/s, "
          f"{res.gflop_per_s():.2f} Gflop/s, {shares} "
          f"(max rel err {rel:.2e})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
