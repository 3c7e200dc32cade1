"""Benchmark suite over the BASELINE.json configs, the counterpart of
``ellspmv_tpu.bench.suite``.

Run: ``python -m ellspmv_tpu_torch.bench.suite [--quick] [--json]
[--device=cuda|cpu]``

The JAX suite's rows, names and fields:

- ``hbm_peak``: the measured triad (``bench/stream.py``) against the card's
  data-sheet peak (on a card only: the CPU has no device memory);
- config0: the golden check (ELL and CSR on the reference's test.mtx);
- config1: the 2-D 5-point Poisson stencil on ELL, on DIA and with 64-bit
  indices;
- the headline: the FEM mesh through the chooser, on the reference's
  ELLPACK min-bytes basis;
- config2: the banded FEM stand-in on ELL and on CSR;
- config3: power_law(1,000,000, 8) on the stream format, its host plan
  time, its oracle error, and the hub-column hybrid;
- config3-10x (not with ``--quick``): power_law(10,000,000, 7) on the
  stream format, its column chunks, its oracle error;
- config-dense-rows: a few long random rows over a local bulk, through the
  chooser, with its oracle error;
- config4, the sharded row, prints that multi-device is not yet ported;
- the peak's self-consistency: no kernel row may read above the triad.

Each timed row runs the chained protocol (``bench/harness.py``). With the
default ``--device=cuda`` and no card the program exits 1; ``--device=cpu``
runs the plain versions on the host.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# The configurations' sizes at full scale (the JAX suite's); `--quick`
# divides the row counts by 8 and the Poisson grid's side by 2, as there.
SIZES = {"poisson": 1024, "mesh_rows": 2_073_600, "banded": 2_000_000,
         "power_law": 1_000_000, "power_law_10x": 10_000_000,
         "dense_rows": 1_000_000}


def _bench(matrix, x, repeat, protocol="chained", metrics=None):
    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    return benchmark_spmv(None, matrix, x, repeat=repeat, warmup=2,
                          protocol=protocol, metrics=metrics)


def normwise_error(got, want) -> float:
    """max |got - want| / max |want|, the suite's oracle figure."""
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-300))


def run_suite(quick: bool = False, as_json: bool = False,
              stream=sys.stderr, device="cuda", check=None) -> list[dict]:
    """Run every row on `device`; return the rows (and print them as JSON
    on stdout with `as_json`). `check(name, coo, matrix, x)`, when given,
    is called with each timed row's COO, built matrix and x (float64 numpy)
    after it is timed: a caller's hook to hold the row's y against an
    oracle."""
    from ellspmv_tpu_torch.bench.harness import SpmvMetrics
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.formats.csr import csr_from_coo
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.formats.hybrid import hybrid_from_coo
    from ellspmv_tpu_torch.formats.stream import stream_from_coo
    from ellspmv_tpu_torch.models.generators import (banded_random,
                                                     dense_rows, fem_mesh_2d,
                                                     poisson2d, power_law)
    from ellspmv_tpu_torch.ops.dispatch import spmv
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy

    device = torch.device(device)
    scale = 8 if quick else 1
    results = []

    def put(x):
        return torch.from_numpy(x).to(device)

    def spmv_host(matrix, x):       # every row is fp64
        return spmv(matrix, put(x)).double().cpu().numpy()

    def record(name, res, note="", checked=None):
        act = res.actual_gb_per_s()
        row = {
            "config": name,
            "best_s": res.best,
            "gnz_per_s": res.gnz_per_s(),
            "gflop_per_s": res.gflop_per_s(),
            "min_gb_per_s": res.min_gb_per_s(),
            "max_gb_per_s": res.max_gb_per_s(),
            "roofline_effective": res.roofline_fraction(),
            # physical columns (bench/traffic.py): the effective roofline
            # is the reference's min-bytes model and can exceed 1.0 for
            # formats that store less than ELLPACK; this one cannot
            "actual_bytes": res.actual_bytes,
            "actual_gb_per_s": act,
            "roofline_physical": res.physical_roofline(),
            "note": note,
        }
        results.append(row)
        eff = ("  --  " if res.roofline_fraction() is None else
               f"{100 * res.roofline_fraction():5.1f}%")
        phys = ("    --     " if act is None or res.hbm_peak is None else
                f"{act:6.1f} GB/s ({100 * res.physical_roofline():5.1f}%)")
        stream.write(
            f"{name:34s} {res.best * 1e3:9.3f} ms  "
            f"{res.gnz_per_s():7.2f} Gnz/s  eff {res.min_gb_per_s():7.1f} "
            f"GB/s ({eff})  phys {phys}  {note}\n")
        if check is not None and checked is not None:
            check(name, *checked)

    # --- measured against nominal device-memory peak ----------------------
    peak_row = None
    if device.type == "cuda":
        from ellspmv_tpu_torch.bench.stream import measure_peak_bandwidth
        from ellspmv_tpu_torch.config import hbm_peak_bytes_per_s
        measured = measure_peak_bandwidth(log=stream, device=device)
        nominal = hbm_peak_bytes_per_s(device)
        share = ("" if nominal is None else
                 f" ({100 * measured / nominal:.1f}%)")
        stream.write(f"{'hbm peak measured/nominal':34s} "
                     f"{measured / 1e9:7.1f} / "
                     f"{'--' if nominal is None else f'{nominal / 1e9:.1f}'}"
                     f" GB/s{share}\n")
        peak_row = {"config": "hbm_peak",
                    "measured_gb_per_s": measured / 1e9,
                    "triad_gb_per_s": measured / 1e9,
                    "source": "triad",
                    "nominal_gb_per_s": (None if nominal is None
                                         else nominal / 1e9)}
        results.append(peak_row)

    # --- config 0: golden correctness -------------------------------------
    rows = np.array([0, 0, 1, 2, 3, 3, 3, 3, 3], np.int32)
    cols = np.array([0, 3, 1, 2, 0, 1, 2, 3, 4], np.int32)
    vals = np.array([1.5, 1.5, 1.0, 3.0, 2.0, 1.0, 1.0, 1.0, 1.0])
    coo0 = CooMatrix(4, 5, rows, cols, vals)
    x0 = np.ones(5)
    ye = spmv_host(ell_from_coo(coo0, device=device), x0)
    yc = spmv_host(csr_from_coo(coo0, device=device), x0)
    ok = (np.allclose(ye, [3, 1, 3, 6], rtol=1e-13)
          and np.allclose(yc, [3, 1, 3, 6], rtol=1e-13))
    stream.write(f"{'config0 golden test.mtx':34s} "
                 f"{'PASS' if ok else 'FAIL'}  y={ye.tolist()}\n")
    results.append({"config": "config0 golden", "pass": bool(ok)})

    # --- config 1: Poisson stencil ---------------------------------------
    nx = SIZES["poisson"] // (2 if quick else 1)
    coo = poisson2d(nx)
    x = np.random.RandomState(0).rand(coo.num_rows)
    ell = ell_from_coo(coo, sort_rows=True, value_dtype="float64",
                       device=device)
    record(f"config1 poisson {nx}x{nx} ELL f64", _bench(ell, put(x), 128),
           checked=(coo, ell, x))
    dia = dia_from_coo(coo, value_dtype="float64", device=device)
    # DIA is so fast the slope needs many iterations to resolve
    record(f"config1 poisson {nx}x{nx} DIA f64", _bench(dia, put(x), 256),
           note="gather-free", checked=(coo, dia, x))
    # the IDXTYPEWIDTH=64 analogue (ellspmv.c:112-130, README:25-30); K1
    # reads 2-byte block-local columns at either width where they fit
    ell64 = ell_from_coo(coo, sort_rows=True, value_dtype="float64",
                         index_dtype="int64", device=device)
    record(f"config1 poisson {nx}x{nx} ELL f64 idx64",
           _bench(ell64, put(x), 128), note="--index-width=64",
           checked=(coo, ell64, x))
    del ell, dia, ell64

    # --- headline: FEM mesh, the chooser's format --------------------------
    # bench.py's configuration, metrics on the reference's ELLPACK
    # min-bytes model (ellspmv.c:1858), comparable to its 148 GB/s
    nmesh = int(round((SIZES["mesh_rows"] // scale) ** 0.5))
    coo = fem_mesh_2d(nmesh)
    x = np.random.RandomState(1).rand(coo.num_rows)
    rowsize = int(np.bincount(np.asarray(coo.rowidx)).max())
    ellsize = coo.num_rows * rowsize
    mmetrics = SpmvMetrics(
        num_nonzeros=coo.num_nonzeros, num_flops=2 * ellsize,
        min_bytes=coo.num_rows * 8 + coo.num_columns * 8
        + ellsize * (8 + 4),
        max_bytes=coo.num_rows * 8 + ellsize * (8 + 4 + 8))
    mat = auto_from_coo(coo, sort_rows=True, value_dtype="float64",
                        device=device)
    record(f"headline fem-mesh {nmesh}^2 auto f64",
           _bench(mat, put(x), 64, metrics=mmetrics),
           note=f"auto={mat._auto_choice} (ELLPACK min-bytes basis)",
           checked=(coo, mat, x))
    del mat

    # --- config 2: banded FEM stand-in -----------------------------------
    n = SIZES["banded"] // scale
    coo = banded_random(n, 16, 512, seed=0)
    x = np.random.RandomState(1).rand(n)
    ell = ell_from_coo(coo, sort_rows=True, value_dtype="float64",
                       device=device)
    record("config2 banded 16/row ELL f64", _bench(ell, put(x), 32),
           checked=(coo, ell, x))
    del ell
    csr = csr_from_coo(coo, sort_rows=True, value_dtype="float64",
                       device=device)
    record("config2 banded 16/row CSR f64", _bench(csr, put(x), 32),
           note="SELL repack on K1", checked=(coo, csr, x))
    del csr

    # --- config 3: power-law ---------------------------------------------
    n = SIZES["power_law"] // scale
    coo = power_law(n, 8, seed=0)
    x = np.random.RandomState(2).rand(n)
    # the padded ELL's size, computed: materialising rows x longest row is
    # the blowup this configuration exists to avoid
    ellsize_pad = n * int(np.bincount(coo.rowidx, minlength=n).max())
    t0 = time.perf_counter()
    strm = stream_from_coo(coo, value_dtype="float64", device=device)
    t_conv = time.perf_counter() - t0
    stream.write(f"{'config3 stream_from_coo':34s} {t_conv:9.3f} s host "
                 f"plan build ({coo.num_nonzeros:,} nnz)\n")
    results.append({"config": "config3 stream_from_coo",
                    "convert_s": t_conv, "nnz": int(coo.num_nonzeros)})
    note = (f"{strm.worksize:,} entries (padding-free) vs padded ELL "
            f"{ellsize_pad:,} slots, {len(strm.ddsum.levels)} sum levels")
    record("config3 power-law stream f64", _bench(strm, put(x), 3),
           note=note, checked=(coo, strm, x))
    # spot check against the exact host oracle
    normerr = normwise_error(spmv_host(strm, x), coo_spmv_numpy(coo, x))
    stream.write(f"{'config3 stream oracle':34s} normwise err "
                 f"{normerr:.2e}\n")
    results.append({"config": "config3 stream oracle",
                    "normwise_err": normerr})
    del strm
    hyb = hybrid_from_coo(coo, value_dtype="float64", device=device)
    record("config3 power-law hub-hybrid f64", _bench(hyb, put(x), 3),
           note=f"hub {100 * hyb.hub_nnz_fraction:.0f}%",
           checked=(coo, hyb, x))
    del hyb

    # --- config3 at 10x scale: column-chunked streams ---------------------
    if not quick:
        n10 = SIZES["power_law_10x"]
        coo10 = power_law(n10, 7, seed=0)
        x10 = np.random.RandomState(4).rand(n10)
        t0 = time.perf_counter()
        strm10 = stream_from_coo(coo10, value_dtype="float64", device=device)
        t_conv10 = time.perf_counter() - t0
        nch = max(len(strm10.ddsum.chunk_bases) - 1, 1)
        stream.write(f"{'config3-10x stream_from_coo':34s} "
                     f"{t_conv10:9.3f} s host plan build "
                     f"({coo10.num_nonzeros:,} nnz, {nch} column "
                     "chunks)\n")
        results.append({"config": "config3-10x stream_from_coo",
                        "convert_s": t_conv10,
                        "nnz": int(coo10.num_nonzeros),
                        "column_chunks": nch})
        record("config3-10x power-law stream f64",
               _bench(strm10, put(x10), 2),
               note=f"{nch} column chunks, "
                    f"{len(strm10.ddsum.levels)} sum levels",
               checked=(coo10, strm10, x10))
        err10 = normwise_error(spmv_host(strm10, x10),
                               coo_spmv_numpy(coo10, x10))
        stream.write(f"{'config3-10x stream oracle':34s} normwise err "
                     f"{err10:.2e}\n")
        results.append({"config": "config3-10x stream oracle",
                        "normwise_err": err10})
        del strm10, coo10

    # --- dense-rows class: few long random rows over a local bulk --------
    # (constraint and boundary rows); the chooser takes the format the card
    # runs faster by its price (ROADMAP F8)
    n = SIZES["dense_rows"] // scale
    coo = dense_rows(n, 8, num_dense=16, dense_nnz=n // 8, seed=0)
    x = np.random.RandomState(3).rand(n)
    mat = auto_from_coo(coo, sort_rows=True, value_dtype="float64",
                        device=device)
    record("config-dense-rows auto f64", _bench(mat, put(x), 8),
           note=f"auto={mat._auto_choice}", checked=(coo, mat, x))
    derr = normwise_error(spmv_host(mat, x), coo_spmv_numpy(coo, x))
    stream.write(f"{'config-dense-rows oracle':34s} normwise err "
                 f"{derr:.2e}\n")
    results.append({"config": "config-dense-rows oracle",
                    "normwise_err": derr})
    del mat

    # --- config 4: sharded SpMV + CG -------------------------------------
    stream.write("config4 skipped: multi-device is not yet ported (see "
                 "ROADMAP.md)\n")

    # --- the peak's self-consistency ---------------------------------------
    # A kernel cannot move bytes faster than the card: where the best
    # row's physical rate beats the triad, the triad is retried once; a
    # kernel-derived floor that still beats it is reported beside the
    # triad, flagged, never in its place.
    if peak_row is not None:
        best_act = max((r.get("actual_gb_per_s") or 0.0 for r in results),
                       default=0.0)
        if best_act > peak_row["measured_gb_per_s"]:
            retry = measure_peak_bandwidth(log=stream, device=device) / 1e9
            triad = max(peak_row["triad_gb_per_s"], retry)
            peak_row["triad_gb_per_s"] = triad
            peak_row["measured_gb_per_s"] = triad
            if best_act > triad:
                peak_row["kernel_derived_gb_per_s"] = best_act
                peak_row["source"] = "triad-degraded; kernel floor flagged"
                stream.write(
                    f"{'hbm peak (kernel-derived)':34s} {best_act:7.1f} "
                    f"GB/s (triad read {triad:.1f} GB/s below the best "
                    "kernel row; kernel-derived floor reported beside "
                    "the triad, not in place of it)\n")
            else:
                peak_row["source"] = "triad-retry"
                stream.write(f"{'hbm peak (triad retry)':34s} "
                             f"{triad:7.1f} GB/s\n")

    if as_json:
        print(json.dumps(results, indent=1))
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="suite")
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    from ellspmv_tpu_torch.cli.common import card_missing
    if card_missing("suite", args.device):
        return 1
    run_suite(quick=args.quick, as_json=args.json, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
