#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ellspmv_tpu_torch``) on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles ``ellspmv_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   one nvcc per source, all started together;
3. each kernel against its plain PyTorch version on the card, the error
   taken per row relative to sum |a*x| (+ |d*x| + |y|): fp64 1e-13, f32
   1e-5, bf16 1e-2. The ELL kernel for {fp64, f32, bf16} x {int32, int64}
   x {diag, no diag} x {y, no y} on poisson2d(64) and
   banded_random(20000, 9, 64); the DIA kernel for {fp64, f32, bf16} x
   {y, no y} on poisson2d(64), a 700-row matrix with offsets beyond 128
   and a rectangular DIA matrix; the FMA probe on its (8, 128) inputs,
   exactly;
4. the ``ellspmv`` program: exact stdout on examples/test.mtx, then on a
   fem_mesh_2d(512) file (262,144 rows) ``-v --sort-rows``,
   ``--format=dia`` and ``--format=auto -v`` (which must choose DIA), their
   y held against the NumPy oracle, and ``--format=auto --protocol=chained
   -v``, its y held against the same recurrence run with the plain DIA
   version on the card;
5. full size, fem_mesh_2d(1440) (2,073,600 rows, about 32.3M nonzeros, the
   class of the reference's Lynx68 matrix): the ELL main path (ell_from_coo,
   benchmark_spmv per_iter, repeat 10, warmup 2) and the headline path
   (auto_from_coo, which must choose DIA, benchmark_spmv chained), each in
   fp64 and f32, with the kernels' launch counts set to 0 before each path
   and read after it, 1000 sampled rows held against the oracle; then the
   headline program (``python -m ellspmv_tpu_torch.bench.headline``) once,
   its JSON line echoed;
6. timing: each kernel beside its plain version at the main paths' shapes,
   in turns (plain, kernel, kernel, plain), and beside one cuSPARSE call
   (``torch.sparse_csr_tensor(...) @ x``) on the same matrix as a
   yardstick; the ELL and DIA kernels held against their plain versions on
   every row at full size.

The line before the last is a JSON summary of the kernels (time, plain
time, bound, cuSPARSE time, launches on the main paths); the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside the
repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TOLERANCE = {"float64": 1e-13, "float32": 1e-5, "bfloat16": 1e-2}
# The chained CLI run against the same recurrence computed with the plain
# version: each of its ~4000 steps may round y differently by an ulp.
CHAINED_TOLERANCE = 1e-11
KERNELS = {   # name -> (source, the TPU kernel it replaces)
    "ell_spmv": ("ellspmv_tpu_torch/csrc/ell_spmv.cu",
                 "ellspmv_tpu/ops/ell_pallas.py:178"),
    "fma_probe": ("ellspmv_tpu_torch/csrc/fma_probe.cu",
                  "ellspmv_tpu/ops/ell_pallas.py:159"),
    "dia_spmv": ("ellspmv_tpu_torch/csrc/dia_spmv.cu",
                 "ellspmv_tpu/ops/dia_pallas.py:41"),
}
# NVIDIA H100 SXM data sheet, dense, outside the tensor cores: the
# operations bound of the kernels (their bytes bound is far larger).
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
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
    log(f"build: {path.name} for sm_90a from "
        f"{', '.join(p.name for p in _build.sources())} in "
        f"{time.perf_counter() - t0:.1f} s")
    report = path.with_suffix(".log")
    if report.exists():
        # "ptxas info    : Used 32 registers, ..." and
        # "    0 bytes stack frame, 0 bytes spill stores, ..."
        usage = [line.rsplit(" : ", 1)[-1].strip()
                 for line in report.read_text().splitlines()
                 if "registers" in line or "spill stores" in line]
        for line in sorted(set(usage)):
            log(f"  ptxas, some instance: {line}")


def ell_row_errors(ell, x, y, got, want):
    """Max over rows of |got - want| relative to sum |a*x| + |d*x| + |y|
    (in fp64)."""
    from ellspmv_tpu_torch.formats.ell import EllMatrix
    from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv_torch
    absm = EllMatrix(ell.colidx, ell.values.double().abs(),
                     None if ell.diag is None else ell.diag.double().abs(),
                     ell.num_rows, ell.num_columns, ell.num_nonzeros)
    return _rel(got, want, ell_spmv_torch(
        absm, x.double().abs(), None if y is None else y.double().abs()))


def dia_row_errors(dia, x, y, got, want):
    """Max over rows of |got - want| relative to sum |a*x| + |y| (in
    fp64)."""
    from ellspmv_tpu_torch.formats.dia import DiaMatrix
    from ellspmv_tpu_torch.ops.dia_cuda import dia_spmv_torch
    absm = DiaMatrix(dia.data.double().abs(), dia.offsets, dia.num_rows,
                     dia.num_columns, dia.num_nonzeros)
    return _rel(got, want, dia_spmv_torch(
        absm, x.double().abs(), None if y is None else y.double().abs()))


def _rel(got, want, scale) -> float:
    import torch
    diff = (got.double() - want.double()).abs()
    return float((diff / torch.where(scale > 0, scale,
                                     torch.ones_like(scale))).max())


def _agree(label, prec, rel):
    ok = rel <= TOLERANCE[prec]
    log(f"  {label}: max err {rel:.3e} of sum|a*x| (tol "
        f"{TOLERANCE[prec]:g}) {'ok' if ok else 'FAIL'}")
    check(ok, f"kernel disagrees with its plain version: {label}: "
              f"{rel:.3e}")


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
                        _agree(f"ell {mname:26s} {prec:8s} {idx} "
                               f"diag={int(sep_diag)} y={int(with_y)}", prec,
                               ell_row_errors(ell, x, y, got, want))
                        cases += 1
    launched = ell_cuda.launches - before
    log(f"ELL kernel vs plain: {cases} cases agree; {launched} kernel "
        "launches")
    if device == "cuda":
        check(launched >= cases, "the ELL kernel's launch count did not move")


def diagonal_coo(n, m, offsets, seed):
    """An n x m matrix with the given diagonals and random values."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    rows_l, cols_l = [], []
    for o in offsets:
        r = np.arange(max(0, -o), min(n, m - o), dtype=np.int64)
        rows_l.append(r)
        cols_l.append(r + o)
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    vals = np.random.RandomState(seed).randn(len(rows))
    return CooMatrix(n, m, rows.astype(np.int32), cols.astype(np.int32),
                     vals)


def phase_dia_vs_plain(device="cuda"):
    import torch

    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.models.generators import poisson2d
    from ellspmv_tpu_torch.ops import dia_cuda

    matrices = [
        ("poisson2d(64)", poisson2d(64)),
        # the offsets of tests/test_pallas.py::test_dia_pallas_offsets_...
        ("offsets_beyond_128(700)", diagonal_coo(
            700, 700, [-300, -129, -7, 0, 5, 127, 128, 301], 4)),
        ("rectangular(3000x2600)", diagonal_coo(
            3000, 2600, [-400, -33, -1, 0, 2, 17, 900], 5)),
    ]
    before = dia_cuda.launches
    cases = 0
    for mname, coo in matrices:
        rng = np.random.RandomState(3)
        x64 = rng.rand(coo.num_columns)
        y64 = rng.randn(coo.num_rows)
        for prec in ("float64", "float32", "bfloat16"):
            dt = value_dtype(prec)
            dia = dia_from_coo(coo, value_dtype=prec, device=device)
            x = torch.from_numpy(x64).to(device).to(dt)
            for with_y in (False, True):
                y = torch.from_numpy(y64).to(device).to(dt) if with_y \
                    else None
                got = dia_cuda.dia_spmv(dia, x, y)
                want = dia_cuda.dia_spmv_torch(dia, x, y)
                if device == "cuda":
                    torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{mname} {prec}: shape/dtype mismatch")
                _agree(f"dia {mname:24s} {prec:8s} D={dia.num_diags} "
                       f"y={int(with_y)}", prec,
                       dia_row_errors(dia, x, y, got, want))
                cases += 1
    launched = dia_cuda.launches - before
    log(f"DIA kernel vs plain: {cases} cases agree; {launched} kernel "
        "launches")
    if device == "cuda":
        check(launched >= cases, "the DIA kernel's launch count did not move")


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


def _run_cli(args, label):
    cmd = [sys.executable, "-m", "ellspmv_tpu_torch.cli.ellspmv", *args]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    check(proc.returncode == 0, f"ellspmv {label} failed: {proc.stderr}")
    log(f"cli: ellspmv {label}: exit 0 in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in proc.stderr.splitlines():
        log(f"  {line}")
    return proc


def phase_cli(mesh_n: int = 512, device: str = "cuda"):
    import io

    import torch

    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.io.mtx import read_vector, write_matrix
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d
    from ellspmv_tpu_torch.ops.dia_cuda import dia_spmv_torch
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    dev = f"--device={device}"
    proc = _run_cli([dev, "examples/test.mtx"], "examples/test.mtx")
    check(proc.stdout == EXPECTED_TEST_MTX,
          f"ellspmv examples/test.mtx printed {proc.stdout!r}")
    log("cli: examples/test.mtx -> y = [3, 1, 3, 6], stdout exact")

    coo = fem_mesh_2d(mesh_n)
    want = coo_spmv_numpy(coo, np.ones(coo.num_columns))
    scale = coo_spmv_numpy(
        CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                  np.abs(coo.values)), np.ones(coo.num_columns))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"fem_mesh_2d_{mesh_n}.mtx")
        t0 = time.perf_counter()
        write_matrix(path, coo)
        log(f"cli: wrote {path} ({coo.num_rows:,} rows, "
            f"{coo.num_nonzeros:,} nonzeros) in "
            f"{time.perf_counter() - t0:.1f} s")
        for flags in (["-v", "--sort-rows"], ["--format=dia"],
                      ["--format=auto", "-v"]):
            proc = _run_cli([dev, *flags, path], " ".join(flags))
            y = read_vector(io.BytesIO(proc.stdout.encode()))
            # stdout carries 15 significant digits (ellspmv.c:1907)
            err = float(np.max(np.abs(y - want) / np.maximum(scale, 1e-300)))
            log(f"cli: {' '.join(flags)}: y of {len(y):,} rows, max err "
                f"{err:.3e} of sum|a*x| against the oracle (printed with "
                f"%.15g)")
            check(len(y) == coo.num_rows and err <= TOLERANCE["float64"],
                  f"ellspmv {' '.join(flags)}: y disagrees with the oracle: "
                  f"{err:.3e}")
            if "--format=auto" in flags:
                check("auto_from_coo [dia]" in proc.stderr,
                      "--format=auto did not choose DIA on fem_mesh_2d")
        flags = ["--format=auto", "--protocol=chained", "-v"]
        proc = _run_cli([dev, *flags, path], " ".join(flags))
    span = re.search(r"over a (\d+)-iteration chained span", proc.stderr)
    check(span is not None and "auto_from_coo [dia]" in proc.stderr,
          "the chained run printed no slope line or did not choose DIA")
    y = read_vector(io.BytesIO(proc.stdout.encode()))
    check(len(y) == coo.num_rows and bool(np.isfinite(y).all()),
          "the chained y is not a finite vector of the matrix's rows")
    # the same recurrence with the plain version: loops of 2 + span
    # iterations, x <- 1e-6*y after each (bench/harness.py)
    dia = dia_from_coo(coo, device=device)
    xk = torch.ones(coo.num_columns, dtype=torch.float64, device=device)
    yk = torch.zeros(coo.num_rows, dtype=torch.float64, device=device)
    for _ in range(2 + int(span.group(1))):
        yk = dia_spmv_torch(dia, xk, yk)
        xk = 1e-6 * yk
    yk = yk.cpu().numpy()
    err = float(np.max(np.abs(y - yk) / np.maximum(np.abs(yk), 1e-300)))
    log(f"cli: chained y vs the plain recurrence of "
        f"{2 + int(span.group(1))} iterations: max rel err {err:.3e} "
        f"(tol {CHAINED_TOLERANCE:g})")
    check(err <= CHAINED_TOLERANCE, "the chained y disagrees with the plain "
                                    f"recurrence: {err:.3e}")


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


def sampled_oracle(coo, x64, sample):
    """The oracle's y and sum |a*x| on the sampled rows."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    n = coo.num_rows
    sel = np.isin(coo.rowidx, sample)
    sub = CooMatrix(n, coo.num_columns, coo.rowidx[sel], coo.colidx[sel],
                    coo.values[sel])
    want = coo_spmv_numpy(sub, x64)[sample]
    scale = coo_spmv_numpy(
        CooMatrix(n, coo.num_columns, sub.rowidx, sub.colidx,
                  np.abs(sub.values)), x64)[sample]
    return want, scale


def _reset_counts():
    """Counts to 0, and a first fp64 call that probes the card again, as
    in a fresh process."""
    from ellspmv_tpu_torch.ops import dia_cuda, ell_cuda
    ell_cuda.FMA_PROBE_RESULTS.clear()
    ell_cuda.launches = ell_cuda.probe_launches = dia_cuda.launches = 0


def _counts():
    from ellspmv_tpu_torch.ops import dia_cuda, ell_cuda
    return {"ell_spmv": ell_cuda.launches, "dia_spmv": dia_cuda.launches,
            "fma_probe": ell_cuda.probe_launches}


def phase_ell_path(coo, x64, sample, device="cuda"):
    """The ELL main path (`ellspmv --sort-rows`'s): per_iter, fp64 and
    f32."""
    import torch

    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.ell import ell_from_coo

    n = coo.num_rows
    want, scale = sampled_oracle(coo, x64, sample)
    iters = WARMUP + REPEAT      # calls that accumulate into y
    _reset_counts()
    runs = {}
    for prec in ("float64", "float32"):
        t0 = time.perf_counter()
        ell = ell_from_coo(coo, sort_rows=True, value_dtype=prec,
                           device=device)
        x = torch.from_numpy(x64).to(device).to(value_dtype(prec))
        if device == "cuda":
            torch.cuda.synchronize()
        log(f"  ELL {prec}: ell_from_coo to {device} in "
            f"{time.perf_counter() - t0:.1f} s, rowsize {ell.rowsize}")
        before = _counts()["ell_spmv"]
        res = benchmark_spmv(None, ell, x, None, repeat=REPEAT,
                             warmup=WARMUP)
        grew = _counts()["ell_spmv"] - before
        for line in res.iteration_lines():
            log(f"  ELL {prec} gemv: {line}")
        log(f"  ELL {prec} best: {res.best:.6f} s, {res.gnz_per_s():.3f} "
            f"Gnz/s, {res.min_gb_per_s():.1f} GB/s (min bytes), "
            f"{res.max_gb_per_s():.1f} GB/s (max bytes) on {res.device}")
        if device == "cuda":
            check(grew >= iters + 2, f"ELL {prec}: the kernel's launch "
                                     f"count grew by {grew} < {iters + 2}")
        got = res.y[torch.from_numpy(sample).to(device)].double().cpu()
        got = got.numpy()
        err = float(np.max(np.abs(got - iters * want)
                           / np.maximum(iters * scale, 1e-300)))
        _sampled_check(f"ELL {prec}", res.y, n, got, err, TOLERANCE[prec])
        runs[prec] = (ell, x)
    counts = _counts()
    log(f"ELL main path: launches {counts}")
    if device == "cuda":
        check(counts["ell_spmv"] > 0 and counts["fma_probe"] > 0,
              f"the ELL path did not launch K1 and K7: {counts}")
    return runs, counts


def _sampled_check(label, y, n, got, err, tol):
    import torch
    log(f"  {label}: y finite={bool(np.isfinite(got).all())}, 1000 sampled "
        f"rows vs oracle: max err {err:.3e} of sum|a*x| (tol {tol:g})")
    check(y.shape == (n,) and bool(torch.isfinite(y).all()),
          f"{label}: y is not a finite vector of {n} rows")
    check(err <= tol, f"{label}: sampled rows disagree with the oracle")


def phase_headline_path(coo, x64, sample, device="cuda"):
    """The headline path (`bench.py`'s and `ellspmv --format=auto
    --protocol=chained`'s): auto_from_coo must choose DIA, chained, fp64 and
    f32."""
    import torch

    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.ops.dispatch import spmv

    n = coo.num_rows
    want, scale = sampled_oracle(coo, x64, sample)
    _reset_counts()
    runs = {}
    for prec in ("float64", "float32"):
        t0 = time.perf_counter()
        mat = auto_from_coo(coo, sort_rows=True, value_dtype=prec,
                            device=device)
        x = torch.from_numpy(x64).to(device).to(value_dtype(prec))
        if device == "cuda":
            torch.cuda.synchronize()
        log(f"  DIA {prec}: auto_from_coo [{mat._auto_choice}] to {device} "
            f"in {time.perf_counter() - t0:.1f} s: {mat._auto_reason}")
        check(mat._auto_choice == "dia",
              f"auto_from_coo chose {mat._auto_choice} for fem_mesh_2d")
        before = _counts()["dia_spmv"]
        res = benchmark_spmv(None, mat, x, None, repeat=REPEAT,
                             warmup=WARMUP, protocol="chained")
        grew = _counts()["dia_spmv"] - before
        for line in res.iteration_lines():
            log(f"  DIA {prec} gemv_dia: {line}")
        log(f"  DIA {prec}: {grew} kernel launches in the chained run; "
            f"physical {res.actual_gb_per_s():.1f} GB/s "
            f"({res.actual_bytes:,} bytes per multiply)")
        if device == "cuda":
            check(grew >= 4 * (2 + res.span_iters),
                  f"DIA {prec}: the kernel's launch count grew by {grew}")
        check(res.y.shape == (n,) and bool(torch.isfinite(res.y).all()),
              f"DIA {prec}: the chained y is not a finite vector")
        # the chained y accumulates thousands of iterations: one clean
        # multiply is held against the oracle, as bench.py does
        got = spmv(mat, x)[torch.from_numpy(sample).to(device)]
        got = got.double().cpu().numpy()
        err = float(np.max(np.abs(got - want) / np.maximum(scale, 1e-300)))
        _sampled_check(f"DIA {prec}", res.y, n, got, err, TOLERANCE[prec])
        runs[prec] = (mat, x)
    counts = _counts()
    log(f"headline path: launches {counts}")
    if device == "cuda":
        check(counts["dia_spmv"] > 0 and counts["fma_probe"] > 0,
              f"the headline path did not launch K2 and K7: {counts}")
    return runs, counts


def phase_headline_program(device="cuda", rows=None):
    env = dict(os.environ)
    if rows is not None:
        env["BENCH_ROWS"] = str(rows)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ellspmv_tpu_torch.bench.headline",
         f"--device={device}"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=900)
    check(proc.returncode == 0, f"the headline program failed: "
                                f"{proc.stderr}")
    lines = proc.stdout.strip().splitlines()
    check(len(lines) == 1, f"the headline program printed {lines!r}")
    got = json.loads(lines[0])
    check(sorted(got) == ["metric", "unit", "value", "vs_baseline"]
          and got["value"] > 0, f"the headline line is {lines[0]}")
    log(f"headline program: exit 0 in {time.perf_counter() - t0:.1f} s")
    log(f"  headline: {lines[0]}")
    for line in proc.stderr.splitlines():
        log(f"  {line.strip()}")


def cusparse_of(coo, dtype, device="cuda"):
    """The matrix as a PyTorch CSR tensor (its product with a vector runs
    cuSPARSE): a yardstick that the port never calls."""
    import torch
    n = coo.num_rows
    order = np.lexsort((coo.colidx, coo.rowidx))
    crow = np.zeros(n + 1, np.int64)
    crow[1:] = np.cumsum(np.bincount(coo.rowidx, minlength=n))
    with warnings.catch_warnings():   # "beta state", "invariant checks"
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(crow.astype(np.int32)).to(device),
            torch.from_numpy(coo.colidx[order].astype(np.int32)).to(device),
            torch.from_numpy(coo.values[order]).to(device).to(dtype),
            size=(n, coo.num_columns), check_invariants=False)


def _bound(nbytes: int, flops: int, prec: str, peak_bw: float):
    t_bytes = nbytes / peak_bw * 1e3
    t_ops = flops / PEAK_FLOPS[prec] * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _turns(label, kernel, plain, library=None):
    """Kernel and plain version in turns (plain, kernel, kernel, plain), the
    library call once beside them."""
    p1, k1, k2, p2 = (time_ms(plain), time_ms(kernel), time_ms(kernel),
                      time_ms(plain))
    lib = time_ms(library) if library is not None else None
    log(f"  {label} timing: kernel {k1:.4f} / {k2:.4f} ms, plain "
        f"{p1:.4f} / {p2:.4f} ms"
        + ("" if lib is None else f", cuSPARSE {lib:.4f} ms"))
    return (k1 + k2) / 2, (p1 + p2) / 2, lib


def phase_timing(coo, ell_runs, dia_runs, peak_bw):
    """Each kernel beside its plain version and cuSPARSE at the main paths'
    shapes; the ELL and DIA kernels held against their plain versions on
    every row at full size."""
    import torch

    from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
    from ellspmv_tpu_torch.ops import dia_cuda, ell_cuda
    out = {}
    csr = {prec: cusparse_of(coo, x.dtype) for prec, (_, x) in
           ell_runs.items()}
    for name, runs in (("ell_spmv", ell_runs), ("dia_spmv", dia_runs)):
        wrapper, plain_fn, errors = (
            (ell_cuda.ell_spmv, ell_cuda.ell_spmv_torch, ell_row_errors)
            if name == "ell_spmv" else
            (dia_cuda.dia_spmv, dia_cuda.dia_spmv_torch, dia_row_errors))
        for prec, (mat, x) in runs.items():
            def kernel():
                return wrapper(mat, x)

            def plain():
                return plain_fn(mat, x)

            def library():
                return csr[prec] @ x
            flops = 2 * (mat.ellsize if name == "ell_spmv" else mat.diasize)
            k_ms, p_ms, lib_ms = _turns(f"{name} {prec}", kernel, plain,
                                        library)
            got, want = kernel(), plain()
            err = float((got.double() - want.double()).abs().max())
            rel = errors(mat, x, None, got, want)
            lib_err = float((library() - want).double().abs().max())
            nbytes = estimate_actual_bytes(mat, with_y=False)
            bound_ms, bound_by = _bound(nbytes, flops, prec, peak_bw)
            log(f"  {name} {prec}: kernel {k_ms:.4f} ms vs plain "
                f"{p_ms:.4f} ms vs cuSPARSE {lib_ms:.4f} ms; bound "
                f"{bound_ms:.4f} ms ({nbytes:,} bytes, {bound_by}), "
                f"{100 * bound_ms / k_ms:.1f}% of it; max |kernel - plain| "
                f"{err:.3e}, {rel:.3e} of sum|a*x| over all "
                f"{mat.num_rows:,} rows (tol {TOLERANCE[prec]:g}); "
                f"max |cuSPARSE - plain| {lib_err:.3e}")
            check(rel <= TOLERANCE[prec], f"{name} {prec}: the kernel "
                                          f"disagrees with its plain version "
                                          f"at full size: {rel:.3e}")
            out[name, prec] = dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                                   max_abs_err=err, bound_ms=bound_ms,
                                   bound_by=bound_by)
    a, b = ell_cuda.probe_inputs("cuda")
    k_ms, p_ms, _ = _turns("fma probe", lambda: ell_cuda.fma_probe(a, b),
                           lambda: ell_cuda.fma_probe_torch(a, b))
    err = float((ell_cuda.fma_probe(a, b)
                 - ell_cuda.fma_probe_torch(a, b)).abs().max())
    # a and b read, the residual written; a product and an fma each
    bound_ms, bound_by = _bound(3 * a.numel() * 4, 3 * a.numel(), "float32",
                                peak_bw)
    log(f"  fma probe: max |kernel - plain| {err:.3e}; bound {bound_ms:.2e} "
        f"ms ({bound_by}; launch latency dominates)")
    out["fma_probe", "float32"] = dict(ms=k_ms, plain_ms=p_ms,
                                       library_ms=None, max_abs_err=err,
                                       bound_ms=bound_ms, bound_by=bound_by)
    torch.cuda.synchronize()
    return out


def main() -> int:
    import torch

    from ellspmv_tpu_torch.config import hbm_peak_bytes_per_s
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d
    t_start = time.perf_counter()
    phase_device()
    peak_bw = hbm_peak_bytes_per_s("cuda")
    check(peak_bw is not None, f"no data-sheet memory peak for "
                               f"{torch.cuda.get_device_name(0)} in "
                               "ellspmv_tpu_torch/config.py (set "
                               "HBM_PEAK_GBPS)")
    phase_build()
    log("phase 3: kernels against their plain versions")
    phase_kernel_vs_plain()
    phase_dia_vs_plain()
    phase_probe_vs_plain()
    log("phase 4: the ellspmv program")
    phase_cli()
    log("phase 5: full size")
    t0 = time.perf_counter()
    coo = fem_mesh_2d(1440)
    n = coo.num_rows
    log(f"full size: fem_mesh_2d(1440): {n:,} rows, {coo.num_nonzeros:,} "
        f"nonzeros, generated in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(1)
    x64 = rng.rand(n)
    sample = np.sort(rng.choice(n, 1000, replace=False))
    torch.cuda.reset_peak_memory_stats()
    ell_runs, ell_counts = phase_ell_path(coo, x64, sample)
    dia_runs, dia_counts = phase_headline_path(coo, x64, sample)
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated():,} "
        "bytes")
    phase_headline_program()
    log("phase 6: timing")
    timing = phase_timing(coo, ell_runs, dia_runs, peak_bw)
    launches = {"ell_spmv": ell_counts["ell_spmv"],
                "dia_spmv": dia_counts["dia_spmv"],
                "fma_probe": ell_counts["fma_probe"]
                + dia_counts["fma_probe"]}
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main paths was not launched: {launches}")
    kernels = []
    for name, key in (("ell_spmv", "float64"), ("fma_probe", "float32"),
                      ("dia_spmv", "float64")):
        source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **timing[name, key]})
    log(f"smoke run: {time.perf_counter() - t_start:.1f} s")
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
