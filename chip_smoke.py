#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ellspmv_tpu_torch``) on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles ``ellspmv_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. each kernel against its plain PyTorch version on the card: the ELL
   kernel for {fp64, f32, bf16} x {int32, int64} x {diag, no diag} x
   {y, no y} on poisson2d(64) and banded_random(20000, 9, 64), the error
   taken per row relative to sum |a*x| (+ |d*x| + |y|): fp64 1e-13, f32
   1e-5, bf16 1e-2; the FMA probe on its (8, 128) inputs, exactly;
4. the ``ellspmv`` program: exact stdout on examples/test.mtx, then
   ``-v --sort-rows`` on a fem_mesh_2d(512) file (262,144 rows), its y held
   against the NumPy oracle;
5. the library's main path at full size: fem_mesh_2d(1440) (2,073,600 rows,
   about 32.3M nonzeros, the class of the reference's Lynx68 matrix) through
   ell_from_coo, the card and benchmark_spmv (repeat 10, warmup 2) in fp64
   and f32, 1000 sampled rows held against the oracle, the kernels' launch
   counts read around that run; then each kernel timed beside its plain
   version at the main path's shape, the ELL kernel held against
   ``ell_spmv_torch`` on every row.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside the repository,
the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOLERANCE = {"float64": 1e-13, "float32": 1e-5, "bfloat16": 1e-2}
KERNEL_SOURCE = "ellspmv_tpu_torch/csrc/ell_spmv.cu"
REPLACES = "ellspmv_tpu/ops/ell_pallas.py:178"
PROBE_SOURCE = "ellspmv_tpu_torch/csrc/fma_probe.cu"
PROBE_REPLACES = "ellspmv_tpu/ops/ell_pallas.py:159"
REPEAT, WARMUP = 10, 2
EXPECTED_TEST_MTX = ("%%MatrixMarket vector array real general\n"
                     "4\n3\n1\n3\n6\n")


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str):
    if not cond:
        raise SmokeFailure(what)


def log(msg: str):
    print(msg, flush=True)


def phase_device():
    import torch
    check(torch.cuda.is_available(),
          "torch.cuda.is_available() is false: this run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=120)
    check(smi.returncode == 0 and smi.stdout.strip() != "",
          f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s), "
        f"device 0 = {torch.cuda.get_device_name(0)}")
    return card


def phase_build():
    from ellspmv_tpu_torch.ops import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.load()
    log(f"build: {path.name} for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    report = path.with_suffix(".log")
    if report.exists():
        # "ptxas info    : Used 32 registers, ..." and
        # "    0 bytes stack frame, 0 bytes spill stores, ..."
        usage = [line.rsplit(" : ", 1)[-1].strip()
                 for line in report.read_text().splitlines()
                 if "registers" in line or "spill stores" in line]
        for line in sorted(set(usage)):
            log(f"  ptxas, every instance: {line}")


def row_errors(ell, x, y, got, want):
    """Max over rows of |got - want| relative to sum |a*x| + |d*x| + |y|
    (in fp64)."""
    import torch

    from ellspmv_tpu_torch.formats.ell import EllMatrix
    from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv_torch
    absm = EllMatrix(ell.colidx, ell.values.double().abs(),
                     None if ell.diag is None else ell.diag.double().abs(),
                     ell.num_rows, ell.num_columns, ell.num_nonzeros)
    scale = ell_spmv_torch(absm, x.double().abs(),
                           None if y is None else y.double().abs())
    diff = (got.double() - want.double()).abs()
    rel = diff / torch.where(scale > 0, scale, torch.ones_like(scale))
    return float(rel.max())


def phase_kernel_vs_plain(device="cuda"):
    import torch

    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.generators import banded_random, poisson2d
    from ellspmv_tpu_torch.ops import ell_cuda

    matrices = [("poisson2d(64)", poisson2d(64)),
                ("banded_random(20000,9,64)", banded_random(20000, 9, 64))]
    before = ell_cuda.launches
    cases = 0
    for mname, coo in matrices:
        rng = np.random.RandomState(3)
        x64 = rng.rand(coo.num_columns)
        y64 = rng.randn(coo.num_rows)
        for prec in ("float64", "float32", "bfloat16"):
            dt = value_dtype(prec)
            for idx in ("int32", "int64"):
                for sep_diag in (False, True):
                    ell = ell_from_coo(coo, separate_diagonal=sep_diag,
                                       value_dtype=prec, index_dtype=idx,
                                       device=device)
                    x = torch.from_numpy(x64).to(device).to(dt)
                    for with_y in (False, True):
                        y = (torch.from_numpy(y64).to(device).to(dt)
                             if with_y else None)
                        got = ell_cuda.ell_spmv(ell, x, y)
                        want = ell_cuda.ell_spmv_torch(ell, x, y)
                        if device == "cuda":
                            torch.cuda.synchronize()
                        check(got.shape == want.shape
                              and got.dtype == want.dtype,
                              f"{mname} {prec}: shape/dtype mismatch")
                        rel = row_errors(ell, x, y, got, want)
                        ok = rel <= TOLERANCE[prec]
                        log(f"  {mname:26s} {prec:8s} {idx} "
                            f"diag={int(sep_diag)} y={int(with_y)}: "
                            f"max err {rel:.3e} of sum|a*x| "
                            f"(tol {TOLERANCE[prec]:g}) "
                            f"{'ok' if ok else 'FAIL'}")
                        check(ok, f"kernel disagrees with ell_spmv_torch: "
                                  f"{mname} {prec} {idx} diag={sep_diag} "
                                  f"y={with_y}: {rel:.3e}")
                        cases += 1
    launched = ell_cuda.launches - before
    log(f"kernel vs plain: {cases} cases agree; {launched} kernel launches")
    if device == "cuda":
        check(launched >= cases, "the kernel's launch count did not move")


def phase_probe_vs_plain():
    """The FMA probe kernel against its plain version on the card: the
    residuals must be equal, bit for bit."""
    import torch

    from ellspmv_tpu_torch.ops import ell_cuda
    a, b = ell_cuda.probe_inputs("cuda")
    before = ell_cuda.probe_launches
    got = ell_cuda.fma_probe(a, b)
    want = ell_cuda.fma_probe_torch(a, b)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    log(f"fma probe vs plain: max |kernel - plain| {err:.3e} over "
        f"{a.numel()} products (tol 0), "
        f"{int((want != 0).sum())} nonzero residuals")
    check(got.shape == want.shape and torch.equal(got, want),
          f"fma_probe disagrees with fma_probe_torch: {err:.3e}")
    check(ell_cuda.probe_launches == before + 1,
          "the probe's launch count did not move")


def phase_cli(mesh_n: int = 512, device: str = "cuda"):
    import io

    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.io.mtx import read_vector, write_matrix
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    cmd = [sys.executable, "-m", "ellspmv_tpu_torch.cli.ellspmv",
           f"--device={device}"]
    proc = subprocess.run(cmd + ["examples/test.mtx"], cwd=REPO,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"ellspmv examples/test.mtx failed: "
                                f"{proc.stderr}")
    check(proc.stdout == EXPECTED_TEST_MTX,
          f"ellspmv examples/test.mtx printed {proc.stdout!r}")
    log("cli: examples/test.mtx -> y = [3, 1, 3, 6], stdout exact")

    coo = fem_mesh_2d(mesh_n)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"fem_mesh_2d_{mesh_n}.mtx")
        t0 = time.perf_counter()
        write_matrix(path, coo)
        log(f"cli: wrote {path} ({coo.num_rows:,} rows, "
            f"{coo.num_nonzeros:,} nonzeros) in "
            f"{time.perf_counter() - t0:.1f} s")
        proc = subprocess.run(cmd + ["-v", "--sort-rows", path], cwd=REPO,
                              capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0, f"ellspmv -v --sort-rows failed: "
                                f"{proc.stderr}")
    for line in proc.stderr.splitlines():
        log(f"  {line}")
    y = read_vector(io.BytesIO(proc.stdout.encode()))
    want = coo_spmv_numpy(coo, np.ones(coo.num_columns))
    scale = coo_spmv_numpy(
        CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                  np.abs(coo.values)), np.ones(coo.num_columns))
    # stdout carries 15 significant digits (ellspmv.c:1907)
    err = float(np.max(np.abs(y - want) / np.maximum(scale, 1e-300)))
    log(f"cli: y of {len(y):,} rows, max err {err:.3e} of sum|a*x| "
        f"against the oracle (printed with %.15g)")
    check(len(y) == coo.num_rows and err <= TOLERANCE["float64"],
          f"ellspmv y disagrees with the oracle: {err:.3e}")


def time_ms(fn, iters: int = 20) -> float:
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_full_size(nx: int = 1440, device: str = "cuda"):
    import torch

    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d
    from ellspmv_tpu_torch.ops import ell_cuda
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy

    t0 = time.perf_counter()
    coo = fem_mesh_2d(nx)
    n = coo.num_rows
    log(f"full size: fem_mesh_2d({nx}): {n:,} rows, {coo.num_nonzeros:,} "
        f"nonzeros, generated in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(1)
    x64 = rng.rand(n)
    sample = np.sort(rng.choice(n, 1000, replace=False))
    sel = np.isin(coo.rowidx, sample)
    sub = CooMatrix(n, n, coo.rowidx[sel], coo.colidx[sel], coo.values[sel])
    want = coo_spmv_numpy(sub, x64)[sample]
    scale = coo_spmv_numpy(
        CooMatrix(n, n, sub.rowidx, sub.colidx, np.abs(sub.values)),
        x64)[sample]
    iters = WARMUP + REPEAT      # calls that accumulate into y

    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    # Count only the main path from here, and let its first fp64 call probe
    # the card as a fresh process would.
    ell_cuda.FMA_PROBE_RESULTS.clear()
    ell_cuda.launches = ell_cuda.probe_launches = 0
    runs = {}
    for prec in ("float64", "float32"):
        t0 = time.perf_counter()
        ell = ell_from_coo(coo, sort_rows=True, value_dtype=prec,
                           device=device)
        x = torch.from_numpy(x64).to(device).to(value_dtype(prec))
        if device == "cuda":
            torch.cuda.synchronize()
        log(f"  {prec}: ell_from_coo to {device} in "
            f"{time.perf_counter() - t0:.1f} s, rowsize {ell.rowsize}")
        before = ell_cuda.launches
        res = benchmark_spmv(None, ell, x, None, repeat=REPEAT,
                             warmup=WARMUP)
        grew = ell_cuda.launches - before
        for line in res.iteration_lines():
            log(f"  {prec} gemv: {line}")
        log(f"  {prec} best: {res.best:.6f} s, {res.gnz_per_s():.3f} "
            f"Gnz/s, {res.min_gb_per_s():.1f} GB/s (min bytes), "
            f"{res.max_gb_per_s():.1f} GB/s (max bytes) on {res.device}")
        if device == "cuda":
            check(grew >= iters + 2, f"{prec}: the kernel's launch count "
                                     f"grew by {grew} < {iters + 2}")
        got = res.y[torch.from_numpy(sample).to(device)].double().cpu()
        got = got.numpy()
        err = float(np.max(np.abs(got - iters * want)
                           / np.maximum(iters * scale, 1e-300)))
        tol = TOLERANCE[prec]
        log(f"  {prec}: y finite={bool(np.isfinite(got).all())}, 1000 "
            f"sampled rows vs oracle: max err {err:.3e} of sum|a*x| "
            f"(tol {tol:g})")
        check(res.y.shape == (n,) and bool(torch.isfinite(res.y).all()),
              f"{prec}: y is not a finite vector of {n} rows")
        check(err <= tol, f"{prec}: sampled rows disagree with the oracle")
        runs[prec] = (ell, x, res)
    launches = {"ell_spmv": ell_cuda.launches,
                "fma_probe": ell_cuda.probe_launches}
    log(f"main path: {launches['ell_spmv']} ELL kernel launches, "
        f"{launches['fma_probe']} FMA probe launches")
    if device == "cuda":
        check(launches["fma_probe"] >= 1,
              "the fp64 main path did not launch the FMA probe")
        log(f"max_memory_allocated: {torch.cuda.max_memory_allocated():,} "
            "bytes")
    return runs, launches


def phase_timing(runs):
    """Each kernel beside its plain version at the main path's shapes, in
    turns (plain, kernel, kernel, plain), on the card; the ELL kernel is
    also held against ell_spmv_torch on every row at full size."""
    from ellspmv_tpu_torch.ops import ell_cuda
    out = {}
    for prec, (ell, x, _) in runs.items():
        def kernel():
            return ell_cuda.ell_spmv(ell, x)

        def plain():
            return ell_cuda.ell_spmv_torch(ell, x)
        p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                          time_ms(plain))
        k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
        got, want = kernel(), plain()
        err = float((got.double() - want.double()).abs().max())
        rel = row_errors(ell, x, None, got, want)
        log(f"  {prec} timing: kernel {k1:.4f} / {k2:.4f} ms, "
            f"ell_spmv_torch {p1:.4f} / {p2:.4f} ms; kernel {k_ms:.4f} ms "
            f"vs plain {p_ms:.4f} ms; max |kernel - plain| {err:.3e}, "
            f"{rel:.3e} of sum|a*x| over all {ell.num_rows:,} rows "
            f"(tol {TOLERANCE[prec]:g})")
        check(rel <= TOLERANCE[prec], f"{prec}: the kernel disagrees with "
                                      f"ell_spmv_torch at full size: "
                                      f"{rel:.3e}")
        out[prec] = (k_ms, p_ms, err)
    a, b = ell_cuda.probe_inputs("cuda")
    p1, k1, k2, p2 = (time_ms(lambda: ell_cuda.fma_probe_torch(a, b)),
                      time_ms(lambda: ell_cuda.fma_probe(a, b)),
                      time_ms(lambda: ell_cuda.fma_probe(a, b)),
                      time_ms(lambda: ell_cuda.fma_probe_torch(a, b)))
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    err = float((ell_cuda.fma_probe(a, b)
                 - ell_cuda.fma_probe_torch(a, b)).abs().max())
    log(f"  fma probe timing: kernel {k1:.4f} / {k2:.4f} ms, "
        f"fma_probe_torch {p1:.4f} / {p2:.4f} ms; max |kernel - plain| "
        f"{err:.3e}")
    out["fma_probe"] = (k_ms, p_ms, err)
    return out


def main() -> int:
    import torch
    phase_device()
    phase_build()
    log("phase 3: kernels against their plain versions")
    phase_kernel_vs_plain()
    phase_probe_vs_plain()
    log("phase 4: the ellspmv program")
    phase_cli()
    log("phase 5: full size")
    runs, launches = phase_full_size()
    timing = phase_timing(runs)
    check(all(n > 0 for n in launches.values()),
          f"a kernel of the main path was not launched: {launches}")
    kernels = []
    for name, source, replaces, key in (
            ("ell_spmv", KERNEL_SOURCE, REPLACES, "float64"),
            ("fma_probe", PROBE_SOURCE, PROBE_REPLACES, "fma_probe")):
        k_ms, p_ms, err = timing[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
