#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ellspmv_tpu_torch``) on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles ``ellspmv_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   one nvcc per source, all started together;
3. the ``cuda`` tests by name (``python -m pytest --noconftest -m cuda
   tests/test_torch_card.py tests/test_torch_imports.py``, each test's
   name and outcome printed; any failure, or none run, fails the script);
   each kernel against its plain PyTorch version on the card, the error
   taken per row relative to sum |a*x| (+ |d*x| + |y|): fp64 1e-13, f32
   1e-5, bf16 1e-2. The ELL kernel for {fp64, f32, bf16} x {int32, int64}
   x {diag, no diag} x {y, no y} on poisson2d(64),
   banded_random(20000, 9, 64) and banded_random(20000, 9, 10000) (narrow
   columns; each also forced to its wide columns) and on a 3000 x 200,000
   matrix whose blocks span more than 65,536 columns (wide columns); the
   DIA kernel for {fp64, f32, bf16} x
   {y, no y} on poisson2d(64), a 700-row matrix with offsets beyond 128
   and a rectangular DIA matrix; the FMA probe on its (8, 128) inputs,
   exactly; the fp64 dot kernel at n in {1, 1023, 1024, 1025, 5000,
   262,144, 2,073,600}, within 1e-14 of sum |x*y| of `math.fsum` and
   2e-14 of its plain version, and bit-equal from launch to launch; the
   stream format's segmented-sum kernel (K3, both its entry points: the
   stream read in place, and read through a map) and gather (K4/K5),
   bit-equal to their plain versions in fp64 and f32, on sum plans with one
   level, several levels, folded buckets, column chunks, empty rows and
   subtiles of 300 runs (every level's sums in place and through its map,
   the gather by level 1's map and by the final one, and the whole plan
   against its plain version); ``sell_spmv`` and ``csr_spmv`` against the
   same calls on CPU copies on every reassembly branch (a CSR tail, the
   long-row split, the length sort with and without it, a symmetric and a
   rectangular matrix, the one-bucket CSR repack with and without its split
   diagonal), with y and without, one K1 launch per bucket; ``hybrid_spmv``
   likewise on every branch of the hybrid (a hub over split rows, a hub of
   short rows, no hub for uniform degrees or a hub as wide as the matrix,
   an empty matrix) in fp64, f32 and bf16, one gather and one K1 launch per
   bucket; K1's round latency on short launches (ROADMAP F8: the slope of
   its time over its rounds of loads, the chooser's constant) and F8's two
   small cases timed both ways beside the chooser's pick, which at the
   blowup gate must be the faster;
4. the programs, their ``main`` run in this process (but for one
   ``python -m`` run each of ``ellspmv`` and ``csrspmv``, in their own
   processes): ``ellspmv``: exact stdout on examples/test.mtx, then on a
   fem_mesh_2d(256) file (65,536 rows) ``-v --sort-rows``,
   ``--format=dia``, ``--format=auto -v`` (which must choose DIA) and
   ``--reorder=rcm -v``, their y held against the NumPy oracle, and
   ``--format=auto --protocol=chained -v``, its y held against the same
   recurrence run with the plain DIA version on the card; then the
   ``cgsolve`` program on the same file (``-v``, ``--reorder=rcm -v``, each
   x held by its true residual ||b - A*x|| <= 10*tol*||b|| from the oracle,
   and ``--tol=1e-14 --maxiter=2 -q``, which must exit 2); then
   ``ellspmv --format=stream -v`` and ``--format=auto -v`` (which must
   choose the stream format) on a power_law(100,000, 8) file, their y held
   against the oracle; the ``csrspmv`` program on examples/test.mtx
   (exact stdout), then ``csrspmv -v``, ``--separate-diagonal`` and
   ``--partition-nonzeros`` and ``ellspmv --format=sell|auto -v`` (auto
   must choose the stream format) on a dense_rows(100,000, 8, 16, 12,500)
   file, their y held against the oracle and their labels checked;
   ``ellspmv --format=hybrid`` with ``--papi-event-file``,
   ``--papi-event-summary`` and ``--trace=DIR``, the same with
   ``--backend=xla`` and the CSV reports, and ``csrspmv --backend=xla``, on
   a power_law(20,000, 8) file: y against the oracle, the reports' lines,
   a trace written;
5. full size, fem_mesh_2d(1440) (2,073,600 rows, about 32.3M nonzeros, the
   class of the reference's Lynx68 matrix): the ELL main path (ell_from_coo,
   benchmark_spmv per_iter, repeat 10, warmup 2), the headline path
   (auto_from_coo, which must choose DIA, benchmark_spmv chained), each in
   fp64 and f32, 1000 sampled rows held against the oracle, and the solver
   path (``cgsolve.solve``, b = ones: fp64 at tol 1e-8, f32 at tol 1e-4,
   x held by its true residual over all rows; the fp64 solve again with the
   plain versions on the card, whose iterations and x it must match, and
   once under ``torch.profiler``, whose device times split an iteration
   into K1, the dot kernel and the rest against the host clock), with the
   kernels' launch counts set to 0 before each path and read after it;
   then the headline program once (its ``main``, as ``python -m
   ellspmv_tpu_torch.bench.headline`` runs it), its JSON line echoed; then the stream path at config3's full width,
   power_law(1,000,000, 8) (7,049,701 nonzeros, the webbase-1M class):
   ``stream_from_coo``'s host seconds and plan, ``benchmark_spmv`` per_iter
   and chained in fp64 and f32, every row held against the oracle, and the
   launch counts of K1, K3 (in place on level 1, through its map on each
   deeper level), the gather and the probe: one SpMV launches K1, K3 once
   per level and one gather; `csrspmv`'s path at fem_mesh_2d(1440)
   (``csr_from_coo``, its SELL repack, ``benchmark_spmv`` per_iter in fp64
   and f32, every row held against the oracle, one K1 launch per bucket
   per call); and the SELL path at the suite's config-dense-rows,
   dense_rows(1,000,000, 8, 16, 125,000): ``sell_from_coo`` (``ellspmv
   --format=sell``'s) and ``auto_from_coo`` (``--format=auto``'s, its
   choice and both prices), their host seconds and buckets, each run
   per_iter in fp64 and f32 with every row held against the oracle; and
   the hybrid path at config3 (``hybrid_from_coo``, per_iter in fp64 and
   f32, every row against the oracle, the launches of each call);
6. timing: each kernel beside its plain version at the main paths' shapes,
   in turns (plain, kernel, kernel, plain), and beside one library call as
   a yardstick (cuSPARSE, ``torch.sparse_csr_tensor(...) @ x``, for the
   SpMV kernels; ``torch.dot`` for the dot kernel), with the first
   versions' times of K1 and K3 beside the new ones; K1 also on narrow and
   on wide columns in turns, in a CUDA graph, at fem_mesh_2d(1440) and on
   the config3 products, and a line saying why the x window in shared
   memory was not kept (with its times from PERF.md); the ELL and DIA
   kernels held against their plain versions on every row at full size;
   the dot kernel also per eager call, its launch path included; at
   config3's shapes K3 per level, in place on level 1 and through its map
   on the deeper ones (yardstick: ``index_add_`` by a precomputed
   input -> output map), the final gather (yardstick:
   ``torch.index_select`` on a zero-prepended payload), K1 at the product
   shape (in a CUDA graph: eagerly its launch path outlasts it), and the
   whole ``stream_spmv`` eagerly and in a CUDA graph (yardstick: cuSPARSE
   on the same matrix), each held against its plain version on every
   output, with the times of the design that laid the products out in
   column order and gathered every level (PERF.md) beside them; the
   launches of one ``stream_spmv``; one ``stream_spmv`` split by
   ``torch.profiler`` into its kernels against the host clock; K3 per
   level in f32 against fp64 in turns; ``csr_spmv`` at fem_mesh_2d(1440)
   against K1 on the 21-wide ELL in turns (CUDA graph), eagerly beside
   cuSPARSE, and against its bytes bound; ``sell_spmv`` at
   config-dense-rows in a CUDA graph against the stream path on the same
   matrix, eagerly beside cuSPARSE, its launches per call, K1's share of
   its device time under the profiler, and its bound; K1 on every bucket of
   both held against its plain version on every row, and each SELL bucket
   alone beside its price; the chooser's pick at config-dense-rows, which
   must be the format the card runs faster there in both types (F8);
   ``hybrid_spmv`` at config3 in a CUDA graph beside the stream path,
   eagerly beside cuSPARSE, split by the profiler into K1, the gather and
   the reassembly, against its bound; and the FMA probe against an empty
   kernel launched the same way, in turns, in a CUDA graph: the floor of
   one launch;
7. multi-device (``ellspmv_tpu_torch/parallel/``): fem_mesh_2d(1440) fp64
   ELL over NCCL at world size 1, its y bit-equal to the one-device
   ``ell_spmv`` and both timed; four ranks sharing the card over gloo: the
   fem ELL in fp64 and f32 (y bit-equal to the one-device port), the
   config2 CSR with the nonzeros partition and config3's stream format
   under the rows and the nonzeros partitions (every row against the
   oracle), CG (true residual, iterations within 1 of one device), each
   with its workload table, each rank's kernels alone and the allgather's
   time, and K1 (K3 and the gather for the stream, K6 for CG) launched on
   every rank; ``dryrun_multichip(4)`` on the card; ``ellspmv
   --devices=2`` on cuda (exit 1), and ``ellspmv`` and ``cgsolve
   --device=cpu --devices=4 -v`` on a fem_mesh_2d(256) file against the
   oracle (the ``cuda`` tests over 1, 2 and 4 ranks run in phase 3);
8. the benchmark suite (``python -m ellspmv_tpu_torch.bench.suite --json``,
   run in this process): every row at full scale, each timed row's y held
   against the oracle on every row (fp64, 1e-13 of sum |a*x|), the triad
   beside the data sheet, config3-10x's normwise error beside the JAX
   package's; config4 skips on one card.

Each phase's seconds are printed after it, and all of them before the
summary.

The line before the last is a JSON summary of the kernels (time, plain
time, bound, library time, launches on the main paths); the last line is
``{"ok": true, "device": {...}}``. Without a card, or outside the
repository, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import itertools
import json
import math
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
    "dot": ("ellspmv_tpu_torch/csrc/dot.cu",
            "ellspmv_tpu/ops/dd_reduce.py:30"),
    "stream_sum": ("ellspmv_tpu_torch/csrc/stream_sum.cu",
                   "ellspmv_tpu/ops/stream_sum.py:65"),
    # K3 reading through a map: the sums of K3 and the deliveries of K4
    "stream_sum_src": ("ellspmv_tpu_torch/csrc/stream_sum.cu",
                       "ellspmv_tpu/ops/stream_sum.py:65"),
    "permute": ("ellspmv_tpu_torch/csrc/permute.cu",
                "ellspmv_tpu/ops/permute.py:531"),
}
# config3 of the suite (ellspmv_tpu/bench/suite.py), BASELINE.json
# configs[3]: the stream path's full width.
CONFIG3 = (1_000_000, 8)
# The suite's config-dense-rows (ellspmv_tpu/bench/suite.py:246-249) at
# full width: a few long random rows over a local bulk, the SELL path's
# matrix; and a tenth of it for the programs of phase 4.
DENSE_ROWS = dict(n=1_000_000, base_nnz=8, num_dense=16, dense_nnz=125_000,
                  seed=0)
DENSE_ROWS_CLI = dict(n=100_000, base_nnz=8, num_dense=16, dense_nnz=12_500,
                      seed=0)
# The dot kernel against math.fsum, of sum |x*y|: its tree of fp64 sums
# errs by about log2(n) ulps of that sum at most; twice that against the
# plain version, which errs as much again.
DOT_TOLERANCE = 1e-14
DOT_SIZES = (1, 1023, 1024, 1025, 5000, 262_144, 2_073_600)
# CG at full size: (tol, maxiter) per precision.
CG_SETTINGS = {"float64": (1e-8, 1000), "float32": (1e-4, 1000)}
# x of the fp64 solve with the kernels against the one with the plain
# versions, relative to max |x|.
CG_X_TOLERANCE = 1e-10
# NVIDIA H100 SXM data sheet, dense, outside the tensor cores: the
# operations bound of the kernels (their bytes bound is far larger).
PEAK_FLOPS = {"float64": 34e12, "float32": 67e12}
REPEAT, WARMUP = 10, 2
# The first versions' times of K1 and the stream path on the same shapes
# (one thread per row with 4-byte columns; K3 one block per subtile; PERF.md,
# NVIDIA H100 80GB HBM3 at 700 W), printed beside this run's; K1's by CUDA
# events around 20 eager calls, stream_spmv's in a CUDA graph.
FIRST_MS = {("ell_spmv", "float64"): 0.1951, ("ell_spmv", "float32"): 0.1245,
          ("products", "float64"): 0.0596, ("products", "float32"): 0.0437,
          ("stream_spmv", "float64"): 0.2700,
          ("stream_spmv", "float32"): 0.2718}
# The stream path's times when its products lay in column order and a gather
# delivered every level (four gathers and a concatenation per SpMV; PERF.md,
# NVIDIA H100 80GB HBM3 at 700 W), per SpMV on the device (CUDA graph) but
# for the eager call; printed beside this run's.
COLUMN_ORDER_MS = {("stream_spmv", "float64"): 0.1911,
                   ("stream_spmv", "float32"): 0.1382,
                   ("stream_spmv eager", "float64"): 0.3922,
                   ("products", "float64"): 0.0492,
                   ("products", "float32"): 0.0302,
                   ("K3", "float64"): 0.0315, ("K3", "float32"): 0.0241,
                   ("K4", "float64"): 0.1015, ("K4", "float32"): 0.0765}
# The x window in shared memory (a K1 variant staged by a TMA bulk copy, the
# counterpart of the TPU kernel's VMEM window), measured against the gather
# in turns by this script before it was taken out (PERF.md; NVIDIA H100
# 80GB HBM3 at 700 W): (window ms, gather ms).
X_WINDOW_MS = {"fem_mesh_2d(1440) fp64": (0.2020, 0.1644),
               "fem_mesh_2d(1440) f32": (0.1076, 0.0951),
               "config3 products fp64": (0.0916, 0.0535),
               "config3 products f32": (0.0755, 0.0338)}
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
    CARD[0] = card
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


def spread_coo(n, m, per_row, seed):
    """n rows of `per_row` random columns in [0, m): with m far above
    65,536 every block of 256 rows spans more, so its ELL keeps wide
    columns."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    rng = np.random.RandomState(seed)
    rows = np.repeat(np.arange(n), per_row)
    cols = rng.randint(0, m, len(rows))
    return CooMatrix(n, m, rows.astype(np.int32), cols.astype(np.int32),
                     rng.randn(len(rows)))


def phase_kernel_vs_plain(device="cuda"):
    """K1 against its plain version on matrices in the narrow layout
    (poisson2d, banded_random with bands of 64 and of 10,000) and on one
    whose blocks span more than 65,536 columns (wide columns); each narrow
    matrix also forced to its wide columns."""
    import dataclasses

    import torch

    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.generators import banded_random, poisson2d
    from ellspmv_tpu_torch.ops import ell_cuda

    matrices = [("poisson2d(64)", poisson2d(64)),
                ("banded_random(20000,9,64)", banded_random(20000, 9, 64)),
                ("banded_random(20000,9,10000)",
                 banded_random(20000, 9, 10000)),
                ("spread(3000x200000,8)", spread_coo(3000, 200_000, 8, 6))]
    before = ell_cuda.launches
    cases = 0
    layouts = set()
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
                    runs = [("wide", ell_cuda.ell_spmv, ell)]
                    if ell.lcol is not None:
                        check(torch.equal(ell.columns(), ell.colidx),
                              f"{mname}: the narrow columns do not decode "
                              "to colidx")
                        runs = [("narrow", ell_cuda.ell_spmv, ell),
                                ("wide", ell_cuda.ell_spmv,
                                 dataclasses.replace(ell, lbase=None,
                                                     lcol=None))]
                    x = torch.from_numpy(x64).to(device).to(dt)
                    for with_y in (False, True):
                        y = (torch.from_numpy(y64).to(device).to(dt)
                             if with_y else None)
                        for layout, fn, mat in runs:
                            got = fn(mat, x, y)
                            want = ell_cuda.ell_spmv_torch(mat, x, y)
                            _sync(device)
                            check(got.shape == want.shape
                                  and got.dtype == want.dtype,
                                  f"{mname} {prec}: shape/dtype mismatch")
                            _agree(f"ell {mname:29s} {layout:7s} {prec:8s} "
                                   f"{idx} diag={int(sep_diag)} "
                                   f"y={int(with_y)}", prec,
                                   ell_row_errors(mat, x, y, got, want))
                            layouts.add(layout)
                            cases += 1
    launched = ell_cuda.launches - before
    log(f"ELL kernel vs plain: {cases} cases agree (layouts "
        f"{sorted(layouts)}); {launched} kernel launches")
    check(layouts == {"narrow", "wide"},
          f"the ELL cases missed a layout: {sorted(layouts)}")
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


def phase_dot_vs_plain():
    """The dot kernel against math.fsum and its plain version on the card,
    on x.y and x.x; two launches on the same inputs must be bit-equal."""
    import torch

    from ellspmv_tpu_torch.ops import dot_cuda
    before = dot_cuda.launches
    cases = 0
    for n in DOT_SIZES:
        rng = np.random.RandomState(n)
        x64, y64 = rng.randn(n), rng.randn(n)
        x, y = torch.from_numpy(x64).cuda(), torch.from_numpy(y64).cuda()
        for label, a, b, a64, b64 in (("x.y", x, y, x64, y64),
                                      ("x.x", x, x, x64, x64)):
            got, again = dot_cuda.vdot(a, b), dot_cuda.vdot(a, b)
            plain = dot_cuda.vdot_torch(a, b)
            torch.cuda.synchronize()
            prods = a64 * b64
            scale = float(np.sum(np.abs(prods)))
            err = abs(float(got) - math.fsum(prods)) / scale
            err_plain = abs(float(got) - float(plain)) / scale
            log(f"  dot n={n:<9,} {label}: |kernel - fsum| {err:.3e}, "
                f"|kernel - plain| {err_plain:.3e} of sum|x*y| (tol "
                f"{DOT_TOLERANCE:g}, {2 * DOT_TOLERANCE:g}); repeat "
                f"{'bit-equal' if torch.equal(got, again) else 'DIFFERS'}")
            check(got.shape == () and got.dtype == torch.float64,
                  f"dot n={n}: the result is not a 0-d fp64 tensor")
            check(torch.equal(got, again),
                  f"dot n={n} {label}: two launches differ")
            check(err <= DOT_TOLERANCE and err_plain <= 2 * DOT_TOLERANCE,
                  f"dot n={n} {label}: the kernel disagrees: {err:.3e} of "
                  f"fsum, {err_plain:.3e} of the plain version")
            cases += 1
    launched = dot_cuda.launches - before
    log(f"dot kernel vs fsum and plain: {cases} cases agree; {launched} "
        "kernel launches")
    check(launched == 2 * cases, "the dot kernel's launch count did not "
                                 "move by two per case")


def _run_cli(args, label, program="ellspmv", expect=0, process=False):
    """Run a program of the port on `args`: its ``main`` in this process
    with stdout and stderr captured (the programs' ``python -m`` entry
    calls the same ``main``; it spares each run the ~8 s a new process
    takes to reach the card), or, with `process`, as ``python -m`` in a
    process of its own. Returns (returncode, stdout, stderr) as
    ``subprocess.CompletedProcess``."""
    import contextlib
    import importlib
    import io
    module = f"ellspmv_tpu_torch.cli.{program}"
    t0 = time.perf_counter()
    if process:
        proc = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO,
                              capture_output=True, text=True, timeout=900)
    else:
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = importlib.import_module(module).main(list(args))
            except SystemExit as e:
                rc = e.code
        proc = subprocess.CompletedProcess(args, rc, out.getvalue(),
                                           err.getvalue())
    check(proc.returncode == expect,
          f"{program} {label} exited {proc.returncode}, not {expect}: "
          f"{proc.stderr}")
    log(f"cli: {program} {label}: exit {expect} in "
        f"{time.perf_counter() - t0:.1f} s"
        f"{' (its own process)' if process else ''}")
    for line in proc.stderr.splitlines():
        log(f"  {line}")
    return proc


def phase_cli(mesh_n: int = 256, device: str = "cuda"):
    import io

    import torch

    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.io.mtx import read_vector, write_matrix
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d
    from ellspmv_tpu_torch.ops.dia_cuda import dia_spmv_torch
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    dev = f"--device={device}"
    proc = _run_cli([dev, "examples/test.mtx"], "examples/test.mtx",
                    process=True)
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
                      ["--format=auto", "-v"], ["--reorder=rcm", "-v"]):
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
            if "--reorder=rcm" in flags:
                check("reorder_rcm:" in proc.stderr,
                      "--reorder=rcm -v printed no reorder_rcm line")
        phase_cgsolve_program(path, coo, dev)
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


def true_residual(coo, x, b) -> float:
    """||b - A*x|| / ||b|| with A*x from the NumPy oracle."""
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    return float(np.linalg.norm(b - coo_spmv_numpy(coo, x))
                 / np.linalg.norm(b))


def phase_cgsolve_program(path, coo, dev):
    """`cgsolve` on the fem_mesh_2d file: x held by its true residual, and
    the exit code 2 of a solve that cannot converge."""
    import io

    from ellspmv_tpu_torch.io.mtx import read_vector
    b = np.ones(coo.num_rows)
    tol = 1e-8
    for flags in (["-v"], ["--reorder=rcm", "-v"]):
        proc = _run_cli([dev, *flags, path], " ".join(flags), "cgsolve")
        check(re.search(r"^cg: \d+ iterations, residual \S+, \S+ seconds$",
                        proc.stderr, re.M) is not None,
              f"cgsolve {' '.join(flags)} printed no cg: line")
        x = read_vector(io.BytesIO(proc.stdout.encode()))
        rel = true_residual(coo, x, b)
        log(f"cli: cgsolve {' '.join(flags)}: x of {len(x):,} rows, true "
            f"residual {rel:.3e} of ||b|| (tol {10 * tol:g})")
        check(len(x) == coo.num_rows and rel <= 10 * tol,
              f"cgsolve {' '.join(flags)}: true residual {rel:.3e}")
    flags = ["--tol=1e-14", "--maxiter=2", "-q"]
    proc = _run_cli([dev, *flags, path], " ".join(flags), "cgsolve",
                    expect=2)
    check(proc.stdout == "", "cgsolve -q printed x")


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
    from ellspmv_tpu_torch.ops import (dia_cuda, dot_cuda, ell_cuda, permute,
                                       stream_sum)
    ell_cuda.FMA_PROBE_RESULTS.clear()
    ell_cuda.launches = ell_cuda.probe_launches = dia_cuda.launches = 0
    dot_cuda.launches = permute.launches = stream_sum.launches = 0
    stream_sum.src_launches = 0


def _counts():
    from ellspmv_tpu_torch.ops import (dia_cuda, dot_cuda, ell_cuda, permute,
                                       stream_sum)
    return {"ell_spmv": ell_cuda.launches, "dia_spmv": dia_cuda.launches,
            "fma_probe": ell_cuda.probe_launches, "dot": dot_cuda.launches,
            "permute": permute.launches, "stream_sum": stream_sum.launches,
            "stream_sum_src": stream_sum.src_launches}


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


def phase_cg_path(coo, peak_bw, device="cuda"):
    """The solver path (`cgsolve`'s body, `cli.cgsolve.solve`) at full size,
    b = ones, fp64 and f32, each x held by its true residual over all rows;
    then the fp64 solve with the plain versions on the card, which must
    take the same iterations (within 1) to the same x."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ellspmv_tpu_torch.cli.cgsolve import solve
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.solvers import cg
    from ellspmv_tpu_torch.ops.dispatch import spmv
    from ellspmv_tpu_torch.ops.dot_cuda import vdot_torch
    from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv_torch

    n = coo.num_rows
    b = np.ones(n)
    counts = {}
    for prec, (tol, maxiter) in CG_SETTINGS.items():
        _reset_counts()
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        x, res, seconds = solve(coo, b, tol=tol, maxiter=maxiter,
                                precision=prec, device=device)
        wall = time.perf_counter() - t0
        grew = _counts()
        rel = true_residual(coo, x, b)
        per_iter = seconds / max(res.iterations, 1)
        log(f"  CG {prec}: {res.iterations} iterations, residual_norm "
            f"{res.residual_norm:.3e}, true residual {rel:.3e} of ||b|| "
            f"(tol {10 * tol:g}); {seconds:.6f} s in CG, "
            f"{per_iter * 1e3:.4f} ms per iteration; solve() {wall:.1f} s "
            f"with set-up; peak device memory "
            f"{torch.cuda.max_memory_allocated():,} bytes ({held:,} held "
            f"before); launches {grew}")
        check(rel <= 10 * tol and bool(np.isfinite(x).all()),
              f"CG {prec}: true residual {rel:.3e} above {10 * tol:g}")
        check(res.residual_norm <= 10 * tol * np.linalg.norm(b),
              f"CG {prec}: cgsolve would exit 2 (residual_norm "
              f"{res.residual_norm:.3e})")
        k = res.iterations
        if prec == "float64":
            check(grew["dot"] == 2 + 2 * k and grew["ell_spmv"] == 1 + k
                  and grew["fma_probe"] == 1,
                  f"CG fp64: launches {grew}, expected {2 + 2 * k} dot, "
                  f"{1 + k} ell_spmv and 1 fma_probe")
        else:
            check(grew["dot"] == 0 and grew["ell_spmv"] == 1 + k,
                  f"CG f32: launches {grew}")
        if prec == "float64":
            x64, k64 = x, k
        counts[prec] = grew
    # the fp64 solve again on one ELL: with the kernels, timed alone and
    # then under the profiler, and with the plain versions
    tol, maxiter = CG_SETTINGS["float64"]
    ell = ell_from_coo(coo, sort_rows=True, value_dtype="float64",
                       device=device)
    bt = torch.ones(n, dtype=torch.float64, device=device)

    def timed(matvec, vdot=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = cg(matvec, bt, tol=tol, maxiter=maxiter, vdot=vdot)
        return res, time.perf_counter() - t0    # cg ends in a host read

    mine, seconds = timed(lambda v: spmv(ell, v))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled, _ = timed(lambda v: spmv(ell, v))
    before = _counts()
    plain, plain_seconds = timed(lambda v: ell_spmv_torch(ell, v),
                                 vdot_torch)
    check(_counts() == before, "the plain solve launched a kernel")
    x_plain = plain.x.cpu().numpy()
    dx = float(np.max(np.abs(x64 - x_plain)) / np.max(np.abs(x_plain)))
    k = mine.iterations
    log(f"  CG float64 on one ELL: {k} iterations with the kernels in "
        f"{seconds:.6f} s ({seconds / k * 1e3:.4f} ms per iteration), "
        f"{profiled.iterations} under the profiler; {plain.iterations} with "
        f"the plain versions in {plain_seconds:.6f} s "
        f"({plain_seconds / plain.iterations * 1e3:.4f} ms per iteration); "
        f"max |x - x_plain| {dx:.3e} of max |x| (tol {CG_X_TOLERANCE:g})")
    check(abs(plain.iterations - k) <= 1 and profiled.iterations == k
          and k == k64,
          "CG: the iterations of the kernels' and the plain versions' "
          "solves differ by more than 1")
    check(dx <= CG_X_TOLERANCE, f"CG: x differs from the plain solve's by "
                                f"{dx:.3e}")
    cg_iteration_breakdown(prof, ell, k, seconds, peak_bw)
    return counts


def device_times_us(prof) -> dict:
    """Device time (us) and count of each kernel or copy the profiler saw
    on the card."""
    from torch.autograd import DeviceType
    out = {}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        out[ev.key] = (ev.count, float(us))
    return out


def cg_iteration_breakdown(prof, ell, iterations, seconds, peak_bw):
    """One fp64 CG iteration at full size: the host clock's seconds per
    iteration against the device time the profiler saw, split into K1, K6
    and the rest (vector updates, scalar ops, the copy of the convergence
    test), and against the bytes bound. Both include the set-up before the
    loop (one K1, two K6), spread over the iterations."""
    from ellspmv_tpu_torch.bench.traffic import cg_iteration_bytes
    times = device_times_us(prof)
    groups = {"K1": 0.0, "K6": 0.0, "rest": 0.0}
    for key, (_, us) in times.items():
        group = ("K1" if "ell_spmv_kernel" in key else
                 "K6" if "dot_partial_kernel" in key
                 or "dot_final_kernel" in key else "rest")
        groups[group] += us
    per_iter_ms = seconds / iterations * 1e3
    nbytes = cg_iteration_bytes(ell)
    bound_ms = nbytes / peak_bw * 1e3
    device_ms = sum(groups.values()) / iterations / 1e3
    if device_ms == 0:
        log("  CG float64 iteration: the profiler saw no device time; the "
            "kernels' share is not measured")
        return
    split = {g: us / iterations / 1e3 for g, us in groups.items()}
    k6_calls = sum(c for key, (c, _) in times.items()
                   if "dot_partial_kernel" in key)
    log(f"  CG float64 iteration: {per_iter_ms:.4f} ms on the host clock; "
        f"device {device_ms:.4f} ms ({100 * device_ms / per_iter_ms:.1f}%: "
        f"K1 {split['K1']:.4f}, K6 {split['K6']:.4f} "
        f"({groups['K6'] / max(k6_calls, 1):.2f} us per dot), the rest "
        f"{split['rest']:.4f}); host and idle {per_iter_ms - device_ms:.4f} "
        f"ms ({100 * (1 - device_ms / per_iter_ms):.1f}%); bytes bound "
        f"{bound_ms:.4f} ms ({nbytes:,} bytes), "
        f"{100 * bound_ms / per_iter_ms:.1f}% of the iteration")
    for key, (count, us) in sorted(times.items(), key=lambda t: -t[1][1]):
        log(f"    device: {us / count:9.2f} us x {count:4d}  {key[:90]}")


def phase_headline_program(device="cuda", rows=None):
    """The headline program's ``main`` in this process (its stdout and
    stderr captured), as ``python -m ellspmv_tpu_torch.bench.headline``
    runs it; `rows` sets ``BENCH_ROWS`` for the run."""
    import contextlib
    import io

    from ellspmv_tpu_torch.bench import headline
    t0 = time.perf_counter()
    out, err = io.StringIO(), io.StringIO()
    saved = os.environ.get("BENCH_ROWS")
    if rows is not None:
        os.environ["BENCH_ROWS"] = str(rows)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = headline.main([f"--device={device}"])
    finally:
        if rows is not None:
            os.environ.pop("BENCH_ROWS")
            if saved is not None:
                os.environ["BENCH_ROWS"] = saved
    proc = subprocess.CompletedProcess([], rc, out.getvalue(), err.getvalue())
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


def _first(name, prec) -> str:
    ms = FIRST_MS.get((name, prec))
    return "" if ms is None else f" (first version: {ms:.4f} ms)"


def k1_forms(label, ell, x):
    """K1 on `ell` in the narrow layout and on its wide columns, in turns
    (narrow, wide, wide, narrow), each in a CUDA graph: (narrow ms, wide
    ms)."""
    import dataclasses

    import torch

    from ellspmv_tpu_torch.ops import ell_cuda
    wide = dataclasses.replace(ell, lbase=None, lcol=None)
    fns = {"narrow": lambda: ell_cuda.ell_spmv(ell, x),
           "wide": lambda: ell_cuda.ell_spmv(wide, x)}
    ms = {k: [] for k in fns}
    for k in ("narrow", "wide", "wide", "narrow"):
        ms[k].append(graph_ms(fns[k]))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    check(torch.equal(fns["wide"](), fns["narrow"]()),
          f"{label}: K1 on wide columns disagrees with the narrow layout")
    log(f"  {label} K1 forms (CUDA graph): narrow columns "
        f"{mean['narrow']:.4f} ms, wide {ell.colidx.element_size()}-byte "
        f"columns {mean['wide']:.4f} ms (bit-equal)")
    return mean["narrow"], mean["wide"]


def _turns(label, kernel, plain, library=None, library_name="cuSPARSE",
           timer=None):
    """Kernel and plain version in turns (plain, kernel, kernel, plain), the
    library call once beside them, each timed by `timer` (`time_ms`)."""
    timer = timer or time_ms
    p1, k1, k2, p2 = (timer(plain), timer(kernel), timer(kernel),
                      timer(plain))
    lib = timer(library) if library is not None else None
    log(f"  {label} timing: kernel {k1:.4f} / {k2:.4f} ms, plain "
        f"{p1:.4f} / {p2:.4f} ms"
        + ("" if lib is None else f", {library_name} {lib:.4f} ms"))
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
            if name == "ell_spmv":
                k1_forms(f"fem_mesh_2d {prec}", mat, x)
            got, want = kernel(), plain()
            err = float((got.double() - want.double()).abs().max())
            rel = errors(mat, x, None, got, want)
            lib_err = float((library() - want).double().abs().max())
            nbytes = estimate_actual_bytes(mat, with_y=False)
            bound_ms, bound_by = _bound(nbytes, flops, prec, peak_bw)
            log(f"  {name} {prec}: kernel {k_ms:.4f} ms{_first(name, prec)} "
                f"vs plain {p_ms:.4f} ms vs cuSPARSE {lib_ms:.4f} ms; bound "
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
    out["dot", "float64"] = time_dot(coo.num_rows, peak_bw)
    torch.cuda.synchronize()
    return out


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call of `fn`, with the host's launch path taken out:
    `iters` calls captured in one CUDA graph, replayed between CUDA
    events."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    return time_ms(graph.replay, 5) / iters


L2_BYTES = 50 * 2 ** 20      # the H100's L2


def _rotating(tensors, nbytes: int):
    """Copies of `tensors` (one call's inputs, `nbytes` with its output)
    enough that their bytes together are at least twice the L2."""
    count = max(2, -(-2 * L2_BYTES // max(nbytes, 1)))
    return [tuple(t.clone() for t in tensors) for _ in range(count)]


def _cycling(fn, copies):
    """`fn` on the next of `copies` at each call."""
    turn = itertools.count()
    return lambda: fn(*copies[next(turn) % len(copies)])


def time_dot(n, peak_bw):
    """The dot kernel at the CG path's length beside its plain version and
    torch.dot, each call on the next of four input pairs (133 MB together,
    so that no call finds its inputs in the 50 MB L2, as in CG), per call
    on the device (a CUDA graph) and, for the kernel, also eagerly."""
    import torch

    from ellspmv_tpu_torch.bench.traffic import dot_bytes
    from ellspmv_tpu_torch.ops import dot_cuda
    rng = np.random.RandomState(5)
    pairs = [(torch.from_numpy(rng.randn(n)).cuda(),
              torch.from_numpy(rng.randn(n)).cuda()) for _ in range(4)]

    def cycling(fn):
        turn = itertools.count()
        return lambda: fn(*pairs[next(turn) % len(pairs)])

    eager_ms = time_ms(cycling(dot_cuda.vdot))
    k_ms, p_ms, lib_ms = _turns(
        f"dot n={n:,} (CUDA graph, per call)", cycling(dot_cuda.vdot),
        cycling(dot_cuda.vdot_torch), cycling(torch.dot), "torch.dot",
        timer=graph_ms)
    x, y = pairs[0]
    got, want = dot_cuda.vdot(x, y), dot_cuda.vdot_torch(x, y)
    err = float((got - want).abs())
    lib_err = float((torch.dot(x, y) - want).abs())
    nbytes = dot_bytes(n)
    bound_ms, bound_by = _bound(nbytes, 2 * n, "float64", peak_bw)
    log(f"  dot: kernel {k_ms:.4f} ms on the device ({eager_ms:.4f} ms per "
        f"eager call, launch path included) vs plain {p_ms:.4f} ms vs "
        f"torch.dot {lib_ms:.4f} ms; bound {bound_ms:.4f} ms ({nbytes:,} "
        f"bytes, {bound_by}), {100 * bound_ms / k_ms:.1f}% of it; "
        f"|kernel - plain| {err:.3e}, |torch.dot - plain| {lib_err:.3e}")
    return dict(ms=k_ms, plain_ms=p_ms, library_ms=lib_ms, max_abs_err=err,
                bound_ms=bound_ms, bound_by=bound_by)

# ---------------------------------------------------------------------------
# The stream path: K1 over the products, the gather (K4/K5) and K3
# ---------------------------------------------------------------------------

def _stream_test_plans():
    """Sum plans of every shape phase 3 holds the stream kernels on: name
    -> (dest, rows, cap, chunk_starts)."""
    rng = np.random.RandomState(22)
    pad = lambda d: np.pad(d, (0, -len(d) % 1024), constant_values=-1)
    one = rng.randint(0, 3000, 20000).astype(np.int64)
    one[rng.rand(20000) < 0.05] = -1
    hubs = rng.permutation(np.concatenate(
        [np.full(20000, 7), np.full(1500, 200),
         rng.randint(0, 5000, 30000)]).astype(np.int64))
    folded = rng.permutation(np.concatenate(
        [np.arange(40000), np.repeat(rng.choice(40000, 30, replace=False),
                                     9)]).astype(np.int64))
    chunked = pad(rng.permutation(np.concatenate(
        [np.full(900, 7), np.full(800, 200),
         rng.randint(0, 2500, 25000)]).astype(np.int64)))
    empty = rng.randint(0, 2000, 9000).astype(np.int64) * 7
    return {
        "one level": (pad(one), 3000, 128, None),
        "several levels (rows over cap)": (pad(hubs), 5000, 128, None),
        "four levels (cap 16)": (pad(hubs), 5000, 16, None),
        "folded buckets": (pad(folded), 40000, 128, None),
        "column chunks (3)": (chunked, 2500, 128,
                              [0, 9000, 17000, len(chunked)]),
        "empty rows": (pad(empty), 14000, 128, None),
        # subtiles of 300 runs: K3 stages its run table 128 at a time
        "cap 300 (runs over a table chunk)": (pad(hubs), 5000, 300, None),
    }


def phase_stream_vs_plain(device="cuda"):
    """K3 and the gather against their plain versions on the card, bit for
    bit, in fp64 and f32, on sum plans with one level, several levels,
    folded buckets, column chunks, empty rows and subtiles of more runs than
    K3 stages at once: every level's sums with the stream read in place and
    read through a map (level 1's over its entries, a deeper level's into
    the output buffer), K3 through a map also against the gather kernel and
    K3 in place, the gather by level 1's map and by the final one, and the
    whole plan (`apply_stream_sum`) against its plain version."""
    import torch

    from ellspmv_tpu_torch.ops import permute, stream_sum
    before = (permute.launches, stream_sum.launches, stream_sum.src_launches)
    sums = src_sums = gathers = plans = deeper = 0
    for name, (dest, n, cap, starts) in _stream_test_plans().items():
        plan = stream_sum.build_stream_sum(dest, n, cap=cap,
                                           chunk_starts=starts).to(device)
        rng = np.random.RandomState(23)
        first = torch.from_numpy(stream_sum.position_map(
            plan.levels[0])).to(device)

        def gather(src, v, label):
            nonlocal gathers
            got = permute.apply_permute(src, v)
            want = permute.apply_permute_torch(src, v)
            _sync(device)
            check(torch.equal(got, want), f"gather {name} {label} "
                                          f"{v.dtype}: kernel != plain")
            gathers += 1
            return got

        for dtype in (torch.float64, torch.float32):
            buffer = torch.from_numpy(rng.randn(plan.buffer_len)).to(
                device, dtype)
            entries = torch.from_numpy(rng.randn(plan.levels[0].in_len)).to(
                device, dtype)
            gather(plan.final_src, buffer, "final")
            for i, lv in enumerate(plan.levels):
                label = f"stream_sum {name} level {i + 1} {dtype}"
                s = torch.from_numpy(rng.randn(lv.in_rows * 128)).to(
                    device, dtype)
                got = stream_sum.stream_sum(lv.table, s)
                want = stream_sum.stream_sum_torch(lv.table, s)
                _sync(device)
                check(got.shape == (lv.out_len,) and torch.equal(got, want),
                      f"{label}: kernel != plain")
                sums += 1
                src, v = ((first, entries) if lv.src is None
                          else (lv.src, buffer))
                got = stream_sum.stream_sum(lv.table, v, src)
                want = stream_sum.stream_sum_torch(lv.table, v, src)
                gathered = stream_sum.stream_sum(
                    lv.table, gather(src, v, f"level {i + 1}"))
                sums += 1
                _sync(device)
                check(got.shape == (lv.out_len,) and torch.equal(got, want)
                      and torch.equal(got, gathered),
                      f"{label} through its map: kernel != plain")
                src_sums += 1
            v = permute.apply_permute_torch(first, entries)
            got = stream_sum.apply_stream_sum(plan, v)
            want = apply_stream_sum_plain(plan, v)
            _sync(device)
            check(torch.equal(got, want), f"apply_stream_sum {name} {dtype}:"
                                          " kernels != plain")
            plans += 1
            deeper += len(plan.levels) - 1
        log(f"  stream plan {name:31s}: {len(plan.levels)} levels, "
            f"buckets {[len(lv.buckets) for lv in plan.levels]}, folded "
            f"{sum(b.sub > 1 for lv in plan.levels for b in lv.buckets)}, "
            f"chunks {max(len(plan.chunk_bases) - 1, 0)}, subtiles "
            f"{[lv.table.num_subtiles for lv in plan.levels]}, buffer "
            f"{plan.buffer_len:,}: gathers, sums in place and through maps, "
            "and the whole plan bit-equal to plain (fp64, f32)")
    grew = (permute.launches - before[0], stream_sum.launches - before[1],
            stream_sum.src_launches - before[2])
    log(f"stream kernels vs plain: {gathers} gathers, {sums} level sums in "
        f"place, {src_sums} through a map and {plans} plans bit-equal; "
        f"{grew[0]} gather, {grew[1]} stream_sum and {grew[2]} "
        "stream_sum_src launches")
    if device == "cuda":
        check(grew == (gathers + plans, sums + plans, src_sums + deeper),
              "the stream kernels' launch counts did not move by one per "
              "case")


def phase_stream_cli(device="cuda"):
    """`ellspmv --format=stream -v` and `--format=auto -v` on a
    power_law(100,000, 8) file: y against the oracle, and auto must choose
    the stream format."""
    import io

    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.io.mtx import read_vector, write_matrix
    from ellspmv_tpu_torch.models.generators import power_law
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    coo = power_law(100_000, 8)
    ones = np.ones(coo.num_columns)
    want = coo_spmv_numpy(coo, ones)
    scale = coo_spmv_numpy(CooMatrix(coo.num_rows, coo.num_columns,
                                     coo.rowidx, coo.colidx,
                                     np.abs(coo.values)), ones)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "power_law_100000.mtx")
        write_matrix(path, coo)
        log(f"cli: wrote {path} ({coo.num_rows:,} rows, "
            f"{coo.num_nonzeros:,} nonzeros)")
        for flags in (["--format=stream", "-v"], ["--format=auto", "-v"]):
            proc = _run_cli([f"--device={device}", *flags, path],
                            " ".join(flags))
            y = read_vector(io.BytesIO(proc.stdout.encode()))
            err = float(np.max(np.abs(y - want) / np.maximum(scale, 1e-300)))
            log(f"cli: {' '.join(flags)} on power_law(100000, 8): y of "
                f"{len(y):,} rows, max err {err:.3e} of sum|a*x| against the "
                "oracle (printed with %.15g)")
            check(len(y) == coo.num_rows and err <= TOLERANCE["float64"],
                  f"ellspmv {' '.join(flags)}: y disagrees with the oracle: "
                  f"{err:.3e}")
            check("gemv_stream:" in proc.stderr,
                  f"ellspmv {' '.join(flags)} did not run the stream format")
            if "--format=auto" in flags:
                check("auto_from_coo [stream]" in proc.stderr,
                      "--format=auto did not choose the stream format on "
                      "power_law")


def stream_plan_lines(sm):
    """The sum plan of `sm`, one line per level (the table of ROADMAP's
    item 8)."""
    plan = sm.ddsum
    lines = []
    for i, lv in enumerate(plan.levels):
        t = lv.table
        lines.append(
            f"    level {i + 1}: {lv.in_len:,} inputs, "
            f"{lv.in_rows * 128:,} positions, {lv.out_len:,} outputs "
            f"({lv.multi_len:,} to the next level), {len(lv.buckets)} "
            f"buckets, {sum(b.T for b in lv.buckets)} grid steps, max S "
            f"{max(b.S for b in lv.buckets)}, {t.num_subtiles:,} subtiles, "
            f"{int(t.run_start.shape[0]):,} runs (at most {t.max_slots} per "
            f"subtile), {int(t.run_count.sum()):,} live elements")
    lines.append(f"    final gather: {plan.num_rows:,} rows; chunks "
                 f"{max(len(plan.chunk_bases) - 1, 0)}")
    return lines


def phase_stream_path(coo, x64, want, scale, device="cuda"):
    """The stream path at config3's full width: stream_from_coo, then
    benchmark_spmv per_iter and chained, fp64 and f32, every row held
    against the oracle, with the launch counts of the path."""
    import torch

    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.stream import stream_from_coo
    from ellspmv_tpu_torch.ops.dispatch import spmv
    n = coo.num_rows
    runs, counts = {}, {}
    for prec in ("float64", "float32"):
        _reset_counts()
        t0 = time.perf_counter()
        sm = stream_from_coo(coo, value_dtype=prec, device=device)
        _sync(device)
        host_s = time.perf_counter() - t0
        x = torch.from_numpy(x64).to(device).to(value_dtype(prec))
        log(f"  stream {prec}: stream_from_coo to {device} in {host_s:.2f} s "
            f"(host build and copy), prod_len {sm.prod_len:,}, "
            f"{len(sm.ddsum.levels)} sum levels")
        for line in stream_plan_lines(sm):
            log(line)
        per_call = stream_launches_per_call(sm)
        calls = 2 + WARMUP + REPEAT
        res = benchmark_spmv(None, sm, x, None, repeat=REPEAT, warmup=WARMUP)
        grew = _counts()
        for line in res.iteration_lines():
            log(f"  stream {prec} gemv_stream: {line}")
        log(f"  stream {prec} best: {res.best:.6f} s, {res.gnz_per_s():.3f} "
            f"Gnz/s, physical {res.actual_gb_per_s():.1f} GB/s "
            f"({res.actual_bytes:,} bytes per multiply); launches {grew}")
        for k, c in per_call.items():
            check(device != "cuda" or grew[k] == c * calls,
                  f"stream {prec}: {grew[k]} {k} launches, expected "
                  f"{c * calls}")
        log(f"  stream {prec}: {sum(per_call.values())} launches per "
            f"stream_spmv ({per_call})")
        iters = WARMUP + REPEAT          # calls that accumulate into y
        got = res.y.double().cpu().numpy()
        err = float(np.max(np.abs(got - iters * want)
                           / np.maximum(iters * scale, 1e-300)))
        _all_rows_check(f"stream {prec} per_iter", res.y, n, got, err,
                        TOLERANCE[prec])
        res = benchmark_spmv(None, sm, x, None, repeat=REPEAT, warmup=WARMUP,
                             protocol="chained")
        for line in res.iteration_lines():
            log(f"  stream {prec} gemv_stream (chained): {line}")
        check(res.y.shape == (n,) and bool(torch.isfinite(res.y).all()),
              f"stream {prec}: the chained y is not a finite vector")
        got = spmv(sm, x).double().cpu().numpy()
        err = float(np.max(np.abs(got - want) / np.maximum(scale, 1e-300)))
        _all_rows_check(f"stream {prec} one multiply after the chained run",
                        res.y, n, got, err, TOLERANCE[prec])
        counts[prec] = _counts()
        log(f"  stream {prec}: launches on the path {counts[prec]}")
        check(device != "cuda" or all(counts[prec][k] > 0 for k in per_call
                                      if per_call[k]),
              f"the stream path did not launch K1, K3 and the gather: "
              f"{counts[prec]}")
        if prec == "float64" and device == "cuda":
            check(counts[prec]["fma_probe"] == 1,
                  f"the fp64 stream path probed {counts[prec]['fma_probe']} "
                  "times, not once")
        runs[prec] = (sm, x)
    return runs, counts


def _sync(device):
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _all_rows_check(label, y, n, got, err, tol):
    import torch
    log(f"  {label}: y finite={bool(np.isfinite(got).all())}, all {n:,} rows "
        f"vs oracle: max err {err:.3e} of sum|a*x| (tol {tol:g})")
    check(y.shape == (n,) and bool(torch.isfinite(y).all()),
          f"{label}: y is not a finite vector of {n} rows")
    check(err <= tol, f"{label}: rows disagree with the oracle: {err:.3e}")


def stream_launches_per_call(sm):
    """The kernel launches of one `stream_spmv` on `sm`: K1, K3 in place on
    level 1 and through its map on each deeper level, and one gather."""
    levels = len(sm.ddsum.levels)
    return {"ell_spmv": 1, "stream_sum": 1, "stream_sum_src": levels - 1,
            "permute": 1}


def apply_stream_sum_plain(plan, v):
    """`apply_stream_sum` with every kernel replaced by its plain version."""
    import torch

    from ellspmv_tpu_torch.ops.permute import apply_permute_torch
    from ellspmv_tpu_torch.ops.stream_sum import stream_sum_torch
    buffer = torch.empty(plan.buffer_len, dtype=v.dtype, device=v.device)
    for lv in plan.levels:
        buffer[lv.out_offset:lv.out_offset + lv.out_len] = (
            stream_sum_torch(lv.table, v) if lv.src is None
            else stream_sum_torch(lv.table, buffer, lv.src))
    return apply_permute_torch(plan.final_src, buffer)


def stream_spmv_plain(sm, x):
    """`stream_spmv` with every kernel replaced by its plain version."""
    from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv_torch
    return apply_stream_sum_plain(sm.ddsum, ell_spmv_torch(sm.prod, x))


def _sum_output_map(table, n_inputs, src=None, first=0):
    """Each input's output under `table` (the input -> output map of the
    index_add_ yardstick): input p is stream position p, or with `src` the
    input ``src[p] - first`` that position p reads; num_subtiles*1024 where
    no run reads an input."""
    import torch
    ptr = table.slot_ptr.cpu().numpy().astype(np.int64)
    start = table.run_start.cpu().numpy().astype(np.int64)
    count = table.run_count.cpu().numpy().astype(np.int64)
    subtile = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    lane = np.arange(int(count.sum())) - np.repeat(np.cumsum(count) - count,
                                                    count)
    pos = np.repeat(start, count) + lane
    if src is not None:
        pos = src.cpu().numpy().astype(np.int64)[pos] - first
    out = np.full(n_inputs, (len(ptr) - 1) * 1024, np.int64)
    out[pos] = np.repeat(subtile, count) * 1024 + lane
    return torch.from_numpy(out).to(table.slot_ptr.device)


def _beside(name, prec) -> str:
    ms = COLUMN_ORDER_MS.get((name, prec))
    return "" if ms is None else (f" (products in column order, a gather "
                                  f"per level: {ms:.4f} ms)")


def phase_stream_timing(coo, runs, peak_bw):
    """At config3's shapes: K3 per level (in place on level 1, through its
    map on the deeper ones), the final gather, K1 at the product shape and
    the whole stream_spmv, each in turns with its plain version and beside
    one PyTorch call, each held against its plain version on every output;
    the launches of one stream_spmv; then one stream_spmv split by the
    profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ellspmv_tpu_torch.bench.traffic import (estimate_actual_bytes,
                                                 gather_bytes, sum_bytes)
    from ellspmv_tpu_torch.ops import ell_cuda, permute, stream_sum
    from ellspmv_tpu_torch.ops.dispatch import spmv
    out = {}
    level_kernels = {}     # level -> precision -> K3's call on that level
    for prec, (sm, x) in runs.items():
        sv = x.element_size()
        plan = sm.ddsum
        totals = {name: dict(ms=0.0, plain_ms=0.0, library_ms=0.0,
                             max_abs_err=0.0, bound_ms=0.0, nbytes=0, flops=0)
                  for name in ("stream_sum", "stream_sum_src", "permute")}

        def add(name, k_ms, p_ms, lib_ms, nbytes, flops):
            t = totals[name]
            t["ms"] += k_ms
            t["plain_ms"] += p_ms
            t["library_ms"] += lib_ms
            t["nbytes"] += nbytes
            t["flops"] += flops

        v = ell_cuda.ell_spmv(sm.prod, x)
        buffer = torch.empty(plan.buffer_len, dtype=x.dtype, device=x.device)
        for i, lv in enumerate(plan.levels):
            table, U = lv.table, lv.table.num_subtiles
            dest = buffer[lv.out_offset:lv.out_offset + lv.out_len]
            if lv.src is None:
                name, form, inputs, first = "stream_sum", "in place", v, 0
                args = (table, v, None, dest)
            else:
                prev = plan.levels[i - 1]
                first = prev.out_offset
                name, form = "stream_sum_src", "through its map"
                inputs = buffer[first:first + prev.multi_len]
                args = (table, buffer, lv.src, dest)
            out_map = _sum_output_map(table, inputs.shape[0], args[2], first)

            def kernel(args=args):
                return stream_sum.stream_sum(*args)

            def plain(args=args):
                return stream_sum.stream_sum_torch(*args[:3])

            def library(inputs=inputs, out_map=out_map, U=U):
                return inputs.new_zeros(U * 1024 + 1).index_add_(
                    0, out_map, inputs)
            label = f"stream_sum level {i + 1} {prec} ({form})"
            k_ms, p_ms, lib_ms = _turns(f"{label} (CUDA graph, per call)",
                                        kernel, plain, library, "index_add_",
                                        timer=graph_ms)
            eager_ms = time_ms(kernel)
            got, want = kernel(), plain()
            check(torch.equal(got, want), f"{label}: kernel != plain at "
                                          "config3")
            lib_err = float((library()[:-1] - want).abs().max())
            live = int(table.run_count.sum())
            nbytes = sum_bytes(table, sv, with_map=lv.src is not None)
            bound_ms, bound_by = _bound(nbytes, live, prec, peak_bw)
            level_kernels.setdefault(i, {})[prec] = kernel
            log(f"  {label}: kernel {k_ms:.4f} ms on the device "
                f"({eager_ms:.4f} ms per eager call) vs plain {p_ms:.4f} vs "
                f"index_add_ {lib_ms:.4f} ms; bound {bound_ms:.4f} ms "
                f"({nbytes:,} bytes, {bound_by}), "
                f"{100 * bound_ms / k_ms:.1f}% of it; {U:,} subtiles, "
                f"{live:,} live elements; bit-equal to plain; "
                f"|index_add_ - plain| {lib_err:.3e}")
            add(name, k_ms, p_ms, lib_ms, nbytes, live)
        src = plan.final_src
        # each call on the next of several copies of its inputs, more bytes
        # together than the 50 MB L2, so that no call finds them there
        # (at config3 one call's map, payload and output fit in it)
        copies = _rotating(
            (src, buffer), sum(t.numel() * t.element_size()
                               for t in (src, buffer, src)))
        padded = [(s_.long() + 1, torch.cat([b_.new_zeros(1), b_]))
                  for s_, b_ in copies]
        k_ms, p_ms, lib_ms = _turns(
            f"gather final {prec} (CUDA graph, per call, {len(copies)} "
            "rotating copies of its inputs)",
            _cycling(permute.apply_permute, copies),
            _cycling(permute.apply_permute_torch, copies),
            _cycling(lambda i, p: torch.index_select(p, 0, i), padded),
            "torch.index_select", timer=graph_ms)
        hot_ms = graph_ms(lambda: permute.apply_permute(src, buffer))
        eager_ms = time_ms(lambda: permute.apply_permute(src, buffer))
        del copies, padded
        y = permute.apply_permute(src, buffer)
        check(torch.equal(y, permute.apply_permute_torch(src, buffer)),
              f"gather final {prec}: kernel != plain at config3")
        nbytes = gather_bytes(src, sv)
        bound_ms, _ = _bound(nbytes, 0, prec, peak_bw)
        log(f"  gather final {prec}: kernel {k_ms:.4f} ms on the device, "
            f"inputs cold ({hot_ms:.4f} ms on one set of inputs, L2-"
            f"resident; {eager_ms:.4f} ms per eager call) vs plain "
            f"{p_ms:.4f} vs index_select {lib_ms:.4f} ms; bound "
            f"{bound_ms:.4f} ms ({nbytes:,} bytes), "
            f"{100 * bound_ms / k_ms:.1f}% of it; bit-equal to plain")
        add("permute", k_ms, p_ms, lib_ms, nbytes, 0)
        for name, t in totals.items():
            t["bound_ms"], t["bound_by"] = _bound(t.pop("nbytes"),
                                                  t.pop("flops"), prec,
                                                  peak_bw)
            out[name, prec] = t
        k3 = {k: out["stream_sum", prec][k] + out["stream_sum_src", prec][k]
              for k in ("ms", "plain_ms", "library_ms", "bound_ms")}
        for row, t in (("K3", k3), ("K4", out["permute", prec])):
            log(f"  {row} row {prec}, all its launches in one stream_spmv, "
                f"on the device: kernel {t['ms']:.4f} ms{_beside(row, prec)} "
                f"vs plain {t['plain_ms']:.4f} vs yardstick "
                f"{t['library_ms']:.4f} ms; bound {t['bound_ms']:.4f} ms"
                + (" (K3: level 1 in place, the deeper levels through their "
                   "maps)" if row == "K3" else
                   " (the final gather; the deeper levels' deliveries run "
                   "inside K3, level 1's in the products' layout)"))
        # K1 at the product shape, on the device: eagerly, the wrapper's
        # launch path takes about as long as the kernel
        k_ms, p_ms, _ = _turns(f"ell_spmv products {prec} (CUDA graph, per "
                               "call)",
                               lambda: ell_cuda.ell_spmv(sm.prod, x),
                               lambda: ell_cuda.ell_spmv_torch(sm.prod, x),
                               timer=graph_ms)
        eager_ms = time_ms(lambda: ell_cuda.ell_spmv(sm.prod, x))
        check(torch.equal(ell_cuda.ell_spmv(sm.prod, x),
                          ell_cuda.ell_spmv_torch(sm.prod, x)),
              f"ell_spmv products {prec}: kernel != plain")
        k1_bytes = estimate_actual_bytes(sm.prod, with_y=False)
        slots = sm.prod.padded_rows
        bound_ms, _ = _bound(k1_bytes, slots, prec, peak_bw)
        log(f"  ell_spmv products {prec} ({slots:,} rows of 1, in position "
            f"order): kernel {k_ms:.4f} ms on the device"
            f"{_beside('products', prec)} ({eager_ms:.4f} ms per eager call"
            f"{_first('products', prec)}) vs plain {p_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms ({k1_bytes:,} bytes, "
            f"{'narrow' if sm.prod.lcol is not None else 'wide'} columns), "
            f"{100 * bound_ms / k_ms:.1f}% of it; bit-equal to plain")
        if sm.prod.lcol is not None:
            k1_forms(f"config3 products {prec}", sm.prod, x)
        # the whole path beside cuSPARSE
        csr = cusparse_of(coo, x.dtype, x.device)
        k_ms, p_ms, lib_ms = _turns(f"stream_spmv {prec}",
                                    lambda: spmv(sm, x),
                                    lambda: stream_spmv_plain(sm, x),
                                    lambda: csr @ x)
        g_ms = graph_ms(lambda: spmv(sm, x))
        before = _counts()
        got = spmv(sm, x)
        after = _counts()
        want = stream_spmv_plain(sm, x)
        check(torch.equal(got, y), f"stream_spmv {prec}: the timed pieces "
                                   "disagree with the whole call")
        per_call = {k: after[k] - before[k] for k in after
                    if after[k] != before[k]}
        check(x.device.type != "cuda" or per_call == {
            k: c for k, c in stream_launches_per_call(sm).items() if c},
              f"stream_spmv {prec}: launches {per_call}")
        rel = float(((got.double() - want.double()).abs()
                     / want.double().abs().clamp(min=1e-300)).max())
        lib_err = float((csr @ x - want).double().abs().max())
        nbytes = estimate_actual_bytes(sm, with_y=False)
        bound_ms, bound_by = _bound(nbytes, 2 * sm.num_nonzeros, prec,
                                    peak_bw)
        log(f"  stream_spmv {prec}: {sum(per_call.values())} launches "
            f"{per_call}; {k_ms:.4f} ms per eager call"
            f"{_beside('stream_spmv eager', prec)}, {g_ms:.4f} ms on the "
            f"device (CUDA graph){_beside('stream_spmv', prec)}"
            f"{_first('stream_spmv', prec)} vs plain {p_ms:.4f} "
            f"ms vs cuSPARSE {lib_ms:.4f} ms; bound {bound_ms:.4f} ms "
            f"({nbytes:,} bytes, {bound_by}), {100 * bound_ms / g_ms:.1f}% "
            f"of the device time; max rel |kernels - plain| {rel:.3e}; "
            f"max |cuSPARSE - plain| {lib_err:.3e}")
        out["stream_spmv", prec] = dict(ms=k_ms, graph_ms=g_ms,
                                        plain_ms=p_ms, library_ms=lib_ms,
                                        bound_ms=bound_ms)
        _sync(x.device.type)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(10):
                spmv(sm, x)
            _sync(x.device.type)
            host_ms = (time.perf_counter() - t0) / 10 * 1e3
        stream_breakdown(prof, host_ms, 10, prec,
                         {"K1": 1, "K3": 1, "K3 src": len(plan.levels) - 1,
                          "gather": 1})
    # K3 in f32 against fp64 on the same positions, in turns
    for i, by_prec in sorted(level_kernels.items()):
        if len(by_prec) < 2:
            continue
        t = {"float64": [], "float32": []}
        for prec in ("float64", "float32", "float32", "float64"):
            t[prec].append(graph_ms(by_prec[prec]))
        m64, m32 = (sum(t[p]) / 2 for p in ("float64", "float32"))
        log(f"  stream_sum level {i + 1}, f32 against fp64 in turns: f32 "
            f"{m32:.4f} ms, fp64 {m64:.4f} ms (f32/fp64 {m32 / m64:.3f})")
    return out


def window_verdict():
    """The line on the x window in shared memory (the TPU kernel's VMEM
    window), which was to be kept only if it beat the gather on
    fem_mesh_2d(1440) and was not slower on the config3 products."""
    times = "; ".join(f"{label} {w:.4f} ms against {g:.4f}"
                      for label, (w, g) in X_WINDOW_MS.items())
    log(f"x window (TMA bulk copy into shared memory): not kept, slower "
        f"than K1's gather everywhere it was measured (PERF.md: "
        f"{times}): its slice of x comes from L2 on top of the matrix, "
        "64 KB of shared memory leave three blocks per SM, and the gather "
        "already hits in L1/L2")


def stream_breakdown(prof, host_ms, calls, prec, per_call):
    """One stream_spmv's device time by kernel (the profiler) against the
    host clock per call. `per_call` gives the launches of each kernel per
    call: a kernel's time per call is its mean launch times that (the
    profiler may drop the events of a call); the rest is spread over the
    calls."""
    times = device_times_us(prof)
    groups = {g: [0.0, 0] for g in ("K1", "K3", "K3 src", "gather", "rest")}
    for key, (count, us) in times.items():
        # K3's two forms are one template, <V, false> and <V, true>
        through_map = "true>" in key or "Lb1E" in key
        group = ("K1" if "ell_spmv_kernel" in key else
                 "gather" if "permute_kernel" in key else
                 ("K3 src" if through_map else "K3")
                 if "stream_sum_kernel" in key else "rest")
        groups[group][0] += us
        groups[group][1] += count
    split = {g: (us / max(n, 1) * per_call[g] if g in per_call
                 else us / calls) / 1e3 for g, (us, n) in groups.items()}
    device_ms = sum(split.values())
    if device_ms == 0:
        log(f"  stream_spmv {prec}: the profiler saw no device time; the "
            "split is not measured")
        return
    log(f"  stream_spmv {prec} under the profiler: {host_ms:.4f} ms per call "
        f"on the host clock; device {device_ms:.4f} ms "
        f"({100 * device_ms / host_ms:.1f}%: K1 {split['K1']:.4f}, K3 in "
        f"place {split['K3']:.4f}, K3 through maps {split['K3 src']:.4f}, "
        f"the gather {split['gather']:.4f}, the rest {split['rest']:.4f}); "
        f"host and idle {host_ms - device_ms:.4f} ms")
    for key, (count, us) in sorted(times.items(), key=lambda t: -t[1][1]):
        log(f"    device: {us / count:9.2f} us x {count:4d}  {key[:90]}")


# ---------------------------------------------------------------------------
# CSR and SELL: the sliced ELL on K1 (csrspmv, --format=sell, the chooser's
# SELL branch)
# ---------------------------------------------------------------------------

def row_oracle(coo, x64, y64=None):
    """The oracle's y and each row's sum |a*x| (+ |y|), in fp64."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    want = coo_spmv_numpy(coo, x64, y64)
    scale = coo_spmv_numpy(
        CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                  np.abs(coo.values), coo.symmetry),
        np.abs(x64), None if y64 is None else np.abs(y64))
    return want, scale


def _row_err(got, want, scale) -> float:
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / np.maximum(scale, 1e-300), initial=0.0))


def bucket_lines(sm):
    """Each bucket of `sm` as (rows, width, column layout)."""
    return [(b.padded_rows, b.rowsize, "narrow" if b.lcol is not None
             else "wide") for b in sm.buckets]


def phase_sell_vs_plain(device="cuda"):
    """`sell_spmv` and `csr_spmv` on the card against the same calls on CPU
    copies (K1's plain version and the same reassembly), per row relative
    to sum |a*x| + |y|, on the layouts of every reassembly branch: a CSR
    tail, the long-row split, the length sort with and without it, a
    symmetric file, a rectangular one, and the trivial one-bucket CSR
    repack with and without its split diagonal."""
    import torch

    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.formats.csr import csr_from_coo
    from ellspmv_tpu_torch.formats.sell import kernel_launches, sell_from_coo
    from ellspmv_tpu_torch.models.generators import (dense_rows,
                                                     fem_mesh_2d, power_law)
    from ellspmv_tpu_torch.ops import ell_cuda
    from ellspmv_tpu_torch.ops.csr import to_sell
    from ellspmv_tpu_torch.ops.dispatch import spmv
    sym = spread_coo(3000, 3000, 6, 4)
    lower = sym.rowidx >= sym.colidx
    sym = CooMatrix(3000, 3000, sym.rowidx[lower], sym.colidx[lower],
                    sym.values[lower], "symmetric")
    cases = [
        ("sell power_law(3000,8) tail", power_law(3000, 8, seed=1),
         dict(slice_rows=256, tail_cap=16, split_rows=False)),
        ("sell dense_rows(4096,4,3,2000) split", dense_rows(4096, 4, 3, 2000,
                                                            seed=2),
         dict(slice_rows=256, tail_cap=32)),
        ("sell power_law(2000,8) length sort", power_law(2000, 8, seed=6),
         dict(slice_rows=128, tail_cap=2048, length_sort=True,
              split_rows=False)),
        ("sell dense_rows(20000,8,4,2500) sort+split",
         dense_rows(20000, 8, 4, 2500), dict(length_sort=True)),
        ("sell symmetric(3000)", sym, dict(slice_rows=128)),
        ("sell spread(3000x200000,8)", spread_coo(3000, 200_000, 8, 6), {}),
        ("csr fem_mesh_2d(64)", fem_mesh_2d(64), None),
        ("csr fem_mesh_2d(64) separate diagonal", fem_mesh_2d(64), "diag"),
    ]
    before = ell_cuda.launches
    calls = 0
    for label, coo, kw in cases:
        rng = np.random.RandomState(4)
        x64 = rng.rand(coo.num_columns)
        y64 = rng.randn(coo.num_rows)
        for prec in ("float64", "float32"):
            dt = value_dtype(prec)
            if isinstance(kw, dict):
                mat = sell_from_coo(coo, value_dtype=prec, device=device,
                                    **kw)
                launches = kernel_launches(mat)
            else:
                mat = csr_from_coo(coo, separate_diagonal=kw == "diag",
                                   value_dtype=prec, device=device)
                launches = kernel_launches(to_sell(mat))
            x = torch.from_numpy(x64).to(device).to(dt)
            for y64_ in (None, y64):
                y = None if y64_ is None else torch.from_numpy(y64_).to(
                    device).to(dt)
                mark = ell_cuda.launches
                got = spmv(mat, x, y)
                grew = ell_cuda.launches - mark
                check(device != "cuda" or grew == launches,
                      f"{label} {prec}: {grew} K1 launches, expected "
                      f"{launches}")
                plain = spmv(mat.to("cpu"), x.cpu(),
                             None if y is None else y.cpu())
                want, scale = row_oracle(coo, x64, y64_)
                err = _row_err(got.double().cpu().numpy(),
                               plain.double().numpy(), scale)
                oracle_err = _row_err(got.double().cpu().numpy(), want,
                                      scale)
                _agree(f"{label:43s} {prec:8s} y={int(y is not None)} "
                       f"against plain (oracle {oracle_err:.1e})", prec,
                       max(err, oracle_err))
                calls += 1
    log(f"SELL and CSR against plain: {calls} calls agree; "
        f"{ell_cuda.launches - before} K1 launches")


def phase_sell_csr_cli(device="cuda"):
    """The `csrspmv` program (plain, --separate-diagonal,
    --partition-nonzeros) and `ellspmv --format=sell|auto`: exact stdout on
    examples/test.mtx, then on a dense_rows(100,000, 8, 16, 12,500) file
    each y against the oracle and each label; auto must choose the stream
    format (SELL's short sub-row buckets priced by their rounds, F8)."""
    import io

    from ellspmv_tpu_torch.io.mtx import read_vector, write_matrix
    from ellspmv_tpu_torch.models.generators import dense_rows
    dev = f"--device={device}"
    proc = _run_cli([dev, "-v", "examples/test.mtx"], "-v examples/test.mtx",
                    "csrspmv", process=True)
    check(proc.stdout == EXPECTED_TEST_MTX and "csrgemv:" in proc.stderr,
          f"csrspmv examples/test.mtx printed {proc.stdout!r}")
    log("cli: csrspmv examples/test.mtx -> y = [3, 1, 3, 6], stdout exact")
    coo = dense_rows(**DENSE_ROWS_CLI)
    want, scale = row_oracle(coo, np.ones(coo.num_columns))
    runs = [("csrspmv", ["-v"], "csrgemv:"),
            ("csrspmv", ["-v", "--separate-diagonal"], "csrgemvsd:"),
            ("csrspmv", ["-v", "--partition-nonzeros"], "csrgemvnz:"),
            ("ellspmv", ["--format=sell", "-v"], "gemv_sell:"),
            ("ellspmv", ["--format=auto", "-v"], "gemv_stream:")]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dense_rows.mtx")
        write_matrix(path, coo)
        log(f"cli: wrote {path} ({coo.num_rows:,} rows, "
            f"{coo.num_nonzeros:,} nonzeros)")
        for program, flags, label in runs:
            proc = _run_cli([dev, *flags, path], " ".join(flags), program)
            y = read_vector(io.BytesIO(proc.stdout.encode()))
            err = _row_err(y, want, scale)
            log(f"cli: {program} {' '.join(flags)} on dense_rows: y of "
                f"{len(y):,} rows, max err {err:.3e} of sum|a*x| against "
                "the oracle (printed with %.15g)")
            check(len(y) == coo.num_rows and err <= TOLERANCE["float64"],
                  f"{program} {' '.join(flags)}: y disagrees with the "
                  f"oracle: {err:.3e}")
            check(label in proc.stderr,
                  f"{program} {' '.join(flags)} printed no {label} line")
            if "--format=auto" in flags:
                check("auto_from_coo [stream]" in proc.stderr,
                      "--format=auto did not choose the stream format on "
                      "dense_rows")


def phase_csr_path(coo, x64, want, scale, device="cuda"):
    """csrspmv's path at fem_mesh_2d(1440): csr_from_coo, its SELL repack,
    benchmark_spmv per_iter in fp64 and f32, every row held against the
    oracle, the launch counts of the path."""
    import torch

    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.csr import csr_from_coo
    from ellspmv_tpu_torch.formats.sell import kernel_launches
    from ellspmv_tpu_torch.ops.csr import to_sell
    n = coo.num_rows
    runs, counts = {}, {}
    for prec in ("float64", "float32"):
        _reset_counts()
        t0 = time.perf_counter()
        csr = csr_from_coo(coo, value_dtype=prec, device=device)
        _sync(device)
        t_csr = time.perf_counter() - t0
        t0 = time.perf_counter()
        sm = to_sell(csr)
        _sync(device)
        log(f"  CSR {prec}: csr_from_coo to {device} in {t_csr:.2f} s "
            f"({csr.rowsize_min} to {csr.rowsize_max} entries a row); its "
            f"SELL repack in {time.perf_counter() - t0:.2f} s: buckets "
            f"(rows, width, columns) {bucket_lines(sm)}, trivial "
            f"reassembly {sm.trivial_reassembly}, {sm.sellsize:,} slots")
        x = torch.from_numpy(x64).to(device).to(value_dtype(prec))
        res = benchmark_spmv(None, csr, x, None, repeat=REPEAT,
                             warmup=WARMUP)
        grew = _counts()
        for line in res.iteration_lines():
            log(f"  CSR {prec} csrgemv: {line}")
        per_call = kernel_launches(sm)
        calls = 2 + WARMUP + REPEAT
        log(f"  CSR {prec} best: {res.best:.6f} s, {res.gnz_per_s():.3f} "
            f"Gnz/s, physical {res.actual_gb_per_s():.1f} GB/s "
            f"({res.actual_bytes:,} bytes per multiply); {per_call} K1 "
            f"launch(es) per call; launches {grew}")
        check(device != "cuda" or grew["ell_spmv"] == per_call * calls,
              f"CSR {prec}: {grew['ell_spmv']} K1 launches, expected "
              f"{per_call * calls}")
        iters = WARMUP + REPEAT
        got = res.y.double().cpu().numpy()
        _all_rows_check(f"CSR {prec} per_iter", res.y, n, got,
                        _row_err(got, iters * want, iters * scale),
                        TOLERANCE[prec])
        counts[prec] = _counts()
        check(device != "cuda" or counts[prec]["ell_spmv"] > 0,
              f"the CSR path did not launch K1: {counts[prec]}")
        runs[prec] = (csr, x)
    return runs, counts


def phase_sell_path(coo, x64, want, scale, device="cuda"):
    """The SELL path at dense_rows(1,000,000, 8, 16, 125,000): `ellspmv
    --format=sell`'s build (sell_from_coo with sorted rows and the length
    sort) and `--format=auto`'s (the chooser, which takes the stream format
    there since K1's short launches are priced by their rounds; its choice
    and both prices),
    each timed on the host and run per_iter in fp64 and f32, every row
    held against the oracle, with the launch counts of the path."""
    import torch

    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.formats.sell import (SellMatrix, kernel_launches,
                                                sell_from_coo)
    n = coo.num_rows
    runs, counts, chosen = {}, {}, {}
    iters = WARMUP + REPEAT
    calls = 2 + iters
    for prec in ("float64", "float32"):
        _reset_counts()
        x = torch.from_numpy(x64).to(device).to(value_dtype(prec))
        t0 = time.perf_counter()
        sm = sell_from_coo(coo, sort_rows=True, length_sort=True,
                           value_dtype=prec, device=device)
        _sync(device)
        t_sell = time.perf_counter() - t0
        extra = 0 if sm.extra_rows is None else int(sm.extra_rows.shape[0])
        log(f"  SELL {prec}: sell_from_coo to {device} in {t_sell:.2f} s: "
            f"buckets (rows, width, columns) {bucket_lines(sm)}, "
            f"{sm.sellsize:,} slots, {sm.num_sub_rows or n:,} sub-rows "
            f"({extra:,} extra), tail {sm.tailsize}, trivial reassembly "
            f"{sm.trivial_reassembly}")
        t0 = time.perf_counter()
        am = auto_from_coo(coo, sort_rows=True, value_dtype=prec,
                           device=device)
        _sync(device)
        t_auto = time.perf_counter() - t0
        log(f"  SELL {prec}: auto_from_coo [{am._auto_choice}] to {device} "
            f"in {t_auto:.2f} s: {am._auto_reason}")
        chosen[prec] = am._auto_choice
        for label, mat in (("--format=sell", sm), ("--format=auto", am)):
            mark = _counts()
            res = benchmark_spmv(None, mat, x, None, repeat=REPEAT,
                                 warmup=WARMUP)
            grew = {k: v - mark[k] for k, v in _counts().items()}
            for line in res.iteration_lines()[:2]:
                log(f"  SELL {prec} {label} gemv: {line}")
            log(f"  SELL {prec} {label} best: {res.best:.6f} s, "
                f"{res.gnz_per_s():.3f} Gnz/s, physical "
                f"{res.actual_gb_per_s():.1f} GB/s ({res.actual_bytes:,} "
                f"bytes per multiply); launches {grew}")
            if isinstance(mat, SellMatrix):
                check(device != "cuda" or grew["ell_spmv"]
                      == kernel_launches(mat) * calls,
                      f"SELL {prec} {label}: {grew['ell_spmv']} K1 "
                      f"launches, expected {kernel_launches(mat) * calls}")
            got = res.y.double().cpu().numpy()
            _all_rows_check(f"SELL {prec} {label} per_iter", res.y, n, got,
                            _row_err(got, iters * want, iters * scale),
                            TOLERANCE[prec])
        counts[prec] = _counts()
        check(device != "cuda" or counts[prec]["ell_spmv"] > 0,
              f"the SELL path did not launch K1: {counts[prec]}")
        runs[prec] = (sm, x)
    return runs, counts, chosen


def _versus(label, fns, timer):
    """`fns` (name -> call) timed by `timer` in turns, first to last and
    back: the mean of each name's two times."""
    names = list(fns)
    ms = {k: [] for k in names}
    for k in names + names[::-1]:
        ms[k].append(timer(fns[k]))
    mean = {k: sum(v) / len(v) for k, v in ms.items()}
    log(f"  {label}: " + ", ".join(f"{k} {'/'.join(f'{t:.4f}' for t in ms[k])}"
                                   f" ms" for k in names))
    return mean


def _buckets_vs_plain(label, sm, x, prec):
    """K1 on every bucket of `sm` against its plain version, every row."""
    from ellspmv_tpu_torch.ops import ell_cuda
    worst = 0.0
    for b in sm.buckets:
        got, want = ell_cuda.ell_spmv(b, x), ell_cuda.ell_spmv_torch(b, x)
        worst = max(worst, ell_row_errors(b, x, None, got, want))
    _agree(f"{label}: K1 on its {len(sm.buckets)} bucket(s), every row, "
           "against plain", prec, worst)


def k1_split(label, fn, sm, device, calls: int = 10):
    """Device time per call of `fn` (one SpMV on the SELL matrix `sm`, or
    on a CSR through it) under the profiler, split into K1 and the rest
    (the plain reassembly passes), each kernel listed: (K1 ms, rest ms).
    The profiler may drop a call's events, so each kernel's time per call
    is its mean launch times its launches per call: K1 on narrow columns
    once per narrow bucket, on wide ones once per wide bucket, every other
    kernel once."""
    from torch.profiler import ProfilerActivity, profile
    _sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        _sync(device)
    times = device_times_us(prof)
    narrow = sum(b.lcol is not None for b in sm.buckets)
    k1 = rest = 0.0
    for key, (count, us) in times.items():
        if "ell_spmv_kernel" in key:
            per_call = narrow if "unsigned short" in key else \
                len(sm.buckets) - narrow
            k1 += us / count * per_call / 1e3
        else:
            rest += us / count / 1e3
    log(f"  {label} under the profiler: K1 {k1:.4f} ms, the rest "
        f"{rest:.4f} ms per call")
    for key, (count, us) in sorted(times.items(), key=lambda t: -t[1][1]):
        log(f"    device: {us / count:9.2f} us x {count:4d}  {key[:90]}")
    return k1, rest


def phase_csr_timing(coo, csr_runs, ell_runs, peak_bw):
    """At fem_mesh_2d(1440): csr_spmv (its one bucket of width 32 on K1)
    in a CUDA graph against K1 on the 21-wide ELL, in turns, eagerly, and
    beside cuSPARSE, against its bytes bound."""
    from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
    from ellspmv_tpu_torch.ops import ell_cuda
    from ellspmv_tpu_torch.ops.csr import to_sell
    from ellspmv_tpu_torch.ops.dispatch import spmv
    for prec, (csr, x) in csr_runs.items():
        ell, xe = ell_runs[prec]
        sm = to_sell(csr)
        lib = cusparse_of(coo, x.dtype, x.device)
        graph = _versus(f"csr_spmv {prec} against K1 on the {ell.rowsize}-"
                        "wide ELL (CUDA graph, per call)",
                        {"csr_spmv": lambda: spmv(csr, x),
                         "ELL": lambda: ell_cuda.ell_spmv(ell, xe)},
                        graph_ms)
        eager = _versus(f"csr_spmv {prec} against K1 on the ELL and "
                        "cuSPARSE (eager, CUDA events over 20 calls)",
                        {"csr_spmv": lambda: spmv(csr, x),
                         "ELL": lambda: ell_cuda.ell_spmv(ell, xe),
                         "cuSPARSE": lambda: lib @ x}, time_ms)
        _buckets_vs_plain(f"csr_spmv {prec}", sm, x, prec)
        k1_split(f"csr_spmv {prec}", lambda: spmv(csr, x), sm,
                 x.device.type)
        nbytes = estimate_actual_bytes(csr, with_y=False)
        bound_ms, bound_by = _bound(nbytes, 2 * sm.sellsize, prec, peak_bw)
        g = graph["csr_spmv"]
        log(f"  csr_spmv {prec}: {g:.4f} ms on the device, "
            f"{eager['csr_spmv']:.4f} ms eager; K1 on the {ell.rowsize}-wide "
            f"ELL {graph['ELL']:.4f} ms on the device "
            f"(csr/ELL {g / graph['ELL']:.3f}); cuSPARSE "
            f"{eager['cuSPARSE']:.4f} ms eager (csr/cuSPARSE "
            f"{g / eager['cuSPARSE']:.3f}); bound {bound_ms:.4f} ms "
            f"({nbytes:,} bytes, {bound_by}), {100 * bound_ms / g:.1f}% of "
            f"it; {len(sm.buckets)} K1 launch(es) per call")


def phase_sell_timing(coo, sell_runs, peak_bw, chosen):
    """At dense_rows(1,000,000, 8, 16, 125,000): sell_spmv in a CUDA graph
    and eagerly, its launches per call, K1's share under the profiler and on
    each bucket beside its price, its bound, cuSPARSE's time, and the
    stream path's on the same matrix. The chooser's pick there (`chosen`,
    by precision) must be the format the card runs faster (ROADMAP F8)."""
    import torch

    from ellspmv_tpu_torch import config

    from ellspmv_tpu_torch.bench.traffic import (estimate_actual_bytes,
                                                 sell_bytes)
    from ellspmv_tpu_torch.formats.stream import stream_from_coo
    from ellspmv_tpu_torch.ops.dispatch import spmv
    for prec, (sm, x) in sell_runs.items():
        lib = cusparse_of(coo, x.dtype, x.device)
        t0 = time.perf_counter()
        st = stream_from_coo(coo, value_dtype=prec, device=x.device)
        _sync(x.device.type)
        t_stream = time.perf_counter() - t0
        graph = _versus(f"sell_spmv {prec} against the stream path on the "
                        "same matrix (CUDA graph, per call)",
                        {"sell_spmv": lambda: spmv(sm, x),
                         "stream_spmv": lambda: spmv(st, x)}, graph_ms)
        eager = _versus(f"sell_spmv {prec} and cuSPARSE (eager, CUDA events "
                        "over 20 calls)",
                        {"sell_spmv": lambda: spmv(sm, x),
                         "cuSPARSE": lambda: lib @ x}, time_ms)
        before = _counts()
        got = spmv(sm, x)
        per_call = {k: v - before[k] for k, v in _counts().items()
                    if v != before[k]}
        check(torch.allclose(got.double(), spmv(st, x).double(),
                             rtol=TOLERANCE[prec], atol=TOLERANCE[prec]
                             * float(got.double().abs().max())),
              f"sell_spmv {prec}: disagrees with the stream path")
        _buckets_vs_plain(f"sell_spmv {prec}", sm, x, prec)
        nbytes = sell_bytes(sm, with_y=False)
        bound_ms, bound_by = _bound(nbytes, 2 * sm.sellsize, prec, peak_bw)
        st_bytes = estimate_actual_bytes(st, with_y=False)
        k1, rest = k1_split(f"sell_spmv {prec}", lambda: spmv(sm, x), sm,
                            x.device.type)
        sell_bucket_times(f"sell_spmv {prec}", sm, x, peak_bw,
                          *config.k1_geometry(x.device))
        fast = min(("sell", "stream"), key=lambda k: graph[f"{k}_spmv"])
        log(f"  F8 config-dense-rows {prec}: the card runs {fast} faster "
            f"(SELL {graph['sell_spmv']:.4f} ms, stream "
            f"{graph['stream_spmv']:.4f} ms); the chooser took "
            f"{chosen[prec]}")
        check(chosen[prec] == fast,
              f"F8: at config-dense-rows {prec} the chooser took "
              f"{chosen[prec]}, the card runs {fast} faster")
        g = graph["sell_spmv"]
        log(f"  sell_spmv {prec}: {g:.4f} ms on the device, "
            f"{eager['sell_spmv']:.4f} ms eager; launches per call "
            f"{per_call}; under the profiler K1 {k1:.4f} ms, the "
            f"reassembly {rest:.4f} ms per call; cuSPARSE "
            f"{eager['cuSPARSE']:.4f} ms eager; the stream path "
            f"{graph['stream_spmv']:.4f} ms on the device ({st_bytes:,} "
            f"bytes; built in {t_stream:.2f} s); bound {bound_ms:.4f} ms "
            f"({nbytes:,} bytes, {bound_by}), {100 * bound_ms / g:.1f}% of "
            "it")
        del st


def probe_floor():
    """K7 against an empty kernel launched the same way (one block, the
    same arguments, ``fma_probe_empty_f32``), each 20 launches in a CUDA
    graph, in turns: the floor of one launch."""
    import torch

    from ellspmv_tpu_torch.ops import _build, ell_cuda
    a, b = ell_cuda.probe_inputs("cuda")
    out = torch.empty_like(a)
    empty, _ = _build.entry("fma_probe_empty_f32", ell_cuda._PROBE_ARGS)

    def launch_empty():
        err = empty(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
                    torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"the empty kernel's launch failed: error {err}")
    ms = _versus("K7 against an empty launch (CUDA graph, per launch)",
                 {"fma_probe": lambda: ell_cuda.fma_probe(a, b),
                  "empty": launch_empty}, graph_ms)
    ratio = ms["fma_probe"] / ms["empty"]
    log(f"  fma probe: {ms['fma_probe']:.4f} ms a launch on the device, an "
        f"empty kernel {ms['empty']:.4f} ms (probe/empty {ratio:.2f}: "
        f"{'within' if ratio <= 2 else 'beyond'} 2x the floor of one "
        "launch)")
    return ms


# ---------------------------------------------------------------------------
# F8: K1's launch geometry in the chooser's price
# ---------------------------------------------------------------------------

# Short K1 launches for the round-latency probe: row counts whose blocks of
# 512 rows stay under the card's SMs, and widths (slots a row); columns
# random over a million (wide columns, as in the SELL split's sub-row
# buckets).
K1_PROBE_ROWS = (2048, 16384, 49152)
K1_PROBE_WIDTHS = (4, 16, 32, 64, 128)
K1_PROBE_COLUMNS = 1_000_000


def _probe_ell(rows, width, prec, device):
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.ell import ell_from_row_major
    rng = np.random.RandomState(rows + width)
    cols = rng.randint(0, K1_PROBE_COLUMNS, (rows, width)).astype(np.int32)
    vals = rng.rand(rows, width)
    return ell_from_row_major(cols, vals, None, rows, K1_PROBE_COLUMNS,
                              rows * width, value_dtype(prec), device)


def probe_k1_geometry(device="cuda"):
    """K1 on short launches (fewer blocks than the card has SMs) at several
    widths, each in a CUDA graph: the time against the rounds of
    ``kSlotBatch`` slots each thread walks, and the least-squares line
    through them. Its slope is one round's latency, the ``L`` of the
    chooser's K1 price (``config.k1_round_seconds``). Returns {prec: L in
    seconds}."""
    import torch

    from ellspmv_tpu_torch.bench.traffic import k1_rounds
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.ops import ell_cuda
    sms = torch.cuda.get_device_properties(0).multi_processor_count \
        if device == "cuda" else 132
    timer = graph_ms if device == "cuda" else _host_ms
    fits = {}
    for prec in ("float64", "float32"):
        points = []
        x = torch.from_numpy(np.random.RandomState(5).rand(
            K1_PROBE_COLUMNS)).to(device).to(value_dtype(prec))
        for rows in K1_PROBE_ROWS:
            blocks = -(-rows // 512)
            check(blocks < sms, f"probe rows {rows}: {blocks} blocks fill "
                                f"the {sms} SMs")
            line = []
            for width in K1_PROBE_WIDTHS:
                ell = _probe_ell(rows, width, prec, device)
                check(ell.lcol is None, "the probe's columns must be wide")
                ms = timer(lambda: ell_cuda.ell_spmv(ell, x))
                points.append((k1_rounds(width), ms))
                line.append(f"{width}: {ms:.4f}")
            log(f"  K1 probe {prec}, {rows:,} rows ({blocks} blocks of "
                f"{sms} SMs), ms by width: {', '.join(line)}")
        r = np.array([p[0] for p in points], np.float64)
        t = np.array([p[1] for p in points], np.float64)
        slope, icept = np.polyfit(r, t, 1)
        resid = np.abs(t - (icept + slope * r)).max()
        fits[prec] = slope * 1e-3
        log(f"  K1 probe {prec}: t = {icept:.4f} ms + {slope * 1e3:.3f} us "
            f"x rounds (rounds = ceil(width / 4)); worst residual "
            f"{resid * 1e3:.2f} us over {len(points)} launches")
    return fits


def _host_ms(fn, iters: int = 3) -> float:
    """Host-clock ms per call, for rehearsals on the CPU."""
    fn()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def sell_bucket_times(label, sm, x, peak_bw, round_s, sms):
    """Each bucket of `sm` alone on K1 (CUDA graph) beside its price:
    bytes over the peak, and the rounds' latency where its blocks do not
    fill the card."""
    from ellspmv_tpu_torch.bench.traffic import k1_launch_seconds
    from ellspmv_tpu_torch.ops import ell_cuda
    timer = graph_ms if x.device.type == "cuda" else _host_ms
    total = priced = 0.0
    for b in sm.buckets:
        ms = timer(lambda: ell_cuda.ell_spmv(b, x))
        nbytes = (b.rowsize * b.padded_rows * b.values.element_size()
                  + b.index_bytes + b.num_rows * b.values.element_size())
        price = k1_launch_seconds(b.num_rows, b.rowsize, nbytes, peak_bw,
                                  round_s, sms) * 1e3
        total += ms
        priced += price
        log(f"  {label} bucket {b.num_rows:,} rows x {b.rowsize} "
            f"({'narrow' if b.lcol is not None else 'wide'}, "
            f"{-(-b.num_rows // 512)} blocks): {ms:.4f} ms on the device, "
            f"priced {price:.4f} ms (bytes alone {nbytes / peak_bw * 1e3:.4f})")
    log(f"  {label}: K1 over its {len(sm.buckets)} buckets {total:.4f} ms on "
        f"the device, priced {priced:.4f} ms")
    return total, priced


def f8_small_cases():
    """ROADMAP F8's two small cases, as the chooser's tests build them:
    name -> (COO, the two formats the chooser weighs there)."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    n = 20_000
    rng = np.random.RandomState(0)
    rows = np.concatenate([np.repeat(np.arange(n), 16), np.zeros(63 - 16)])
    cols = rng.randint(0, n, len(rows))
    near = CooMatrix(n, n, rows.astype(np.int32), cols.astype(np.int32),
                     rng.randn(len(rows)))
    rows = np.concatenate([np.arange(n), np.zeros(299, np.int64)])
    cols = np.concatenate([np.arange(n), np.arange(1, 300)])
    blowup = CooMatrix(n, n, rows.astype(np.int32), cols.astype(np.int32),
                       np.ones(len(rows)))
    return {"20,000 rows of 16 and one of 63": (near, ("ell", "stream")),
            "20,000 rows of one and one of 300": (blowup,
                                                  ("sell", "stream"))}


def _format_of(name, coo, prec, device):
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.formats.sell import sell_from_coo
    from ellspmv_tpu_torch.formats.stream import stream_from_coo
    if name == "ell":
        return ell_from_coo(coo, sort_rows=True, value_dtype=prec,
                            device=device)
    if name == "sell":
        return sell_from_coo(coo, sort_rows=True, length_sort=True,
                             value_dtype=prec, device=device)
    return stream_from_coo(coo, value_dtype=prec, device=device)


def f8_timed_both_ways(label, coo, names, device="cuda"):
    """The formats `names` of `coo` in turns in a CUDA graph, fp64 and f32,
    and the chooser's pick: {prec: (ms by name, chosen)}."""
    import torch

    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.ops.dispatch import spmv
    timer = graph_ms if device == "cuda" else _host_ms
    out = {}
    for prec in ("float64", "float32"):
        x = torch.from_numpy(np.random.RandomState(6).rand(
            coo.num_columns)).to(device).to(value_dtype(prec))
        mats = {k: _format_of(k, coo, prec, device) for k in names}
        ms = _versus(f"F8 {label} {prec} (CUDA graph, per call)",
                     {k: (lambda m=m: spmv(m, x)) for k, m in mats.items()},
                     timer)
        chosen = auto_from_coo(coo, sort_rows=True, value_dtype=prec,
                               device=device)
        fast = min(ms, key=ms.get)
        log(f"  F8 {label} {prec}: the card runs {fast} faster "
            f"({' against '.join(f'{k} {v:.4f} ms' for k, v in ms.items())}"
            f"); the chooser takes {chosen._auto_choice}: "
            f"{chosen._auto_reason}")
        out[prec] = (ms, chosen._auto_choice)
    return out


def phase_f8(device="cuda"):
    """ROADMAP F8: K1's round latency measured on short launches (the
    chooser's ``L``), printed beside the card's name and power limit and
    the constant in ``config.py``; and F8's two small cases timed both ways
    in a CUDA graph, fp64 and f32, beside the chooser's pick. At the blowup
    gate (the second case) the pick must be the faster format."""
    import torch

    from ellspmv_tpu_torch import config
    fits = probe_k1_geometry(device)
    stored, sms = config.k1_geometry(device)
    card = (torch.cuda.get_device_name(0) if device == "cuda"
            else "host CPU")
    log(f"  K1 round latency on {CARD[0] or card}: {fits['float64'] * 1e6:.3f}"
        f" us fp64, {fits['float32'] * 1e6:.3f} us f32 measured; config.py "
        f"prices {stored * 1e6:.3f} us on {sms} SMs")
    for label, (coo, names) in f8_small_cases().items():
        both = f8_timed_both_ways(label, coo, names, device)
        if "sell" in names:
            for prec, (ms, chosen) in both.items():
                check(device != "cuda" or chosen == min(ms, key=ms.get),
                      f"F8 {label} {prec}: the chooser took {chosen}, the "
                      f"card runs {min(ms, key=ms.get)} faster ({ms})")
    return fits


# ---------------------------------------------------------------------------
# The hub-column hybrid: the gather (K4's counterpart), then K1 per bucket of
# its two SELL parts
# ---------------------------------------------------------------------------

def hybrid_cases():
    """(label, COO, hybrid_from_coo keywords) on every branch of the
    hybrid: a hub over both parts' long-row split and reassembly, a hub of
    short rows, none for uniform degrees, none where the hub would hold
    every column, an empty matrix. (No CSR tail arises: the split leaves no
    row longer than the tail's cap.)"""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.models.generators import power_law
    empty = CooMatrix(300, 200, np.zeros(0, np.int32), np.zeros(0, np.int32),
                      np.zeros(0))
    return [
        ("hub, split", power_law(20_000, 8, seed=2), {}),
        ("hub, short rows", power_law(4000, 3, alpha=2.5, seed=1),
         dict(hub_width=512, slice_rows=256)),
        ("no hub (uniform)", spread_coo(2000, 2000, 4, 7),
         dict(hub_width=128)),
        ("no hub (H >= m)", spread_coo(400, 100, 5, 8), {}),
        ("empty", empty, {}),
    ]


def phase_hybrid_vs_plain(device="cuda"):
    """`hybrid_spmv` on the card against the same call on a CPU copy (the
    plain gather, K1's plain version, the same reassembly) and against the
    oracle, per row relative to sum |a*x| + |y|, on every branch, in fp64,
    f32 and bf16 (whose x the gather moves as 16-bit patterns), with y and
    without; one gather and one K1 launch per bucket of both parts."""
    import torch

    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.hybrid import (hybrid_from_coo,
                                                  hybrid_spmv,
                                                  kernel_launches)
    from ellspmv_tpu_torch.ops import ell_cuda, permute
    calls = 0
    for label, coo, kw in hybrid_cases():
        rng = np.random.RandomState(9)
        x64 = rng.rand(coo.num_columns)
        y64 = rng.randn(coo.num_rows)
        for prec in ("float64", "float32", "bfloat16"):
            dt = value_dtype(prec)
            hm = hybrid_from_coo(coo, value_dtype=prec, device=device, **kw)
            want_launches = kernel_launches(hm)
            x = torch.from_numpy(x64).to(device).to(dt)
            host = hm.to("cpu")
            for y64_ in (None, y64):
                y = None if y64_ is None else torch.from_numpy(y64_).to(
                    device).to(dt)
                mark = (ell_cuda.launches, permute.launches)
                got = hybrid_spmv(hm, x, y)
                grew = {"ell_spmv": ell_cuda.launches - mark[0],
                        "permute": permute.launches - mark[1]}
                check(device != "cuda" or grew == want_launches,
                      f"hybrid {label} {prec}: launches {grew}, expected "
                      f"{want_launches}")
                plain = hybrid_spmv(host, x.cpu(),
                                    None if y is None else y.cpu())
                want, scale = row_oracle(coo, x.double().cpu().numpy(),
                                         None if y is None else
                                         y.double().cpu().numpy())
                got64 = got.double().cpu().numpy()
                err = max(_row_err(got64, plain.double().numpy(), scale),
                          _row_err(got64, want, scale))
                _agree(f"hybrid {label:18s} {prec:8s} y={int(y is not None)}"
                       f" (hub {hm.hub_nnz_fraction:.2f}, launches "
                       f"{want_launches}) against plain and the oracle",
                       prec, err)
                calls += 1
    log(f"hybrid against plain: {calls} calls agree")


def phase_hybrid_cli(device="cuda"):
    """`ellspmv --format=hybrid` (with ``--papi-event-file`` and
    ``--papi-event-summary`` and ``--trace=DIR``), the same with
    ``--backend=xla`` (the reports in CSV), and `csrspmv --backend=xla`, on a
    power_law(20,000, 8) file: exit 0, y against the oracle, the reports'
    lines, and a trace written into DIR."""
    import io

    from ellspmv_tpu_torch.io.mtx import read_vector, write_matrix
    from ellspmv_tpu_torch.models.generators import power_law
    coo = power_law(20_000, 8, seed=0)
    want, scale = row_oracle(coo, np.ones(coo.num_columns))
    papi = ["--papi-event-file=examples/tpu_membw.metrics",
            "--papi-event-summary"]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "power_law_20000.mtx")
        write_matrix(path, coo)
        trace = os.path.join(tmp, "trace")
        runs = [("ellspmv", ["--format=hybrid", "-v", *papi,
                             f"--trace={trace}"], "gemv_hybrid:"),
                ("ellspmv", ["--format=hybrid", "--backend=xla", "-v", *papi,
                             "--papi-event-format=csv"], "gemv_hybrid:"),
                ("csrspmv", ["--backend=xla", "-v"], "csrgemv:")]
        for program, flags, label in runs:
            proc = _run_cli([f"--device={device}", *flags, path],
                            " ".join(flags), program)
            y = read_vector(io.BytesIO(proc.stdout.encode()))
            err = _row_err(y, want, scale)
            log(f"cli: {program} {' '.join(flags)} on power_law(20000, 8): "
                f"y of {len(y):,} rows, max err {err:.3e} of sum|a*x| "
                "against the oracle (printed with %.15g)")
            check(len(y) == coo.num_rows and err <= TOLERANCE["float64"],
                  f"{program} {' '.join(flags)}: y disagrees with the "
                  f"oracle: {err:.3e}")
            check(label in proc.stderr,
                  f"{program} {' '.join(flags)} printed no {label} line")
            if "--format=hybrid" in flags:
                check("hybrid_from_coo:" in proc.stderr
                      and "hub fraction" in proc.stderr,
                      "--format=hybrid -v printed no hybrid_from_coo line")
            if "--backend=xla" in flags:
                check("backend: xla" in proc.stderr,
                      f"{program} --backend=xla -v did not name its backend")
            if papi[0] in flags:
                check("Throughput" in proc.stderr and "Roofline" in
                      proc.stderr, "the event file's report is missing")
                check(("region,repeat,time" in proc.stderr)
                      == ("--papi-event-format=csv" in flags),
                      "the summary's format is not the one asked for")
                check("HBM roofline:" in proc.stderr
                      or "--papi-event-format=csv" in flags,
                      "the plain summary printed no roofline")
        files = os.listdir(trace) if os.path.isdir(trace) else []
        size = sum(os.path.getsize(os.path.join(trace, f)) for f in files)
        check(size > 0, f"--trace={trace} wrote nothing")
        log(f"cli: --trace wrote {files} ({size:,} bytes)")


def phase_hybrid_path(coo, x64, want, scale, device="cuda"):
    """`ellspmv --format=hybrid`'s path at config3's full width:
    hybrid_from_coo, benchmark_spmv per_iter in fp64 and f32, every row held
    against the oracle, one gather and one K1 launch per bucket per call."""
    import torch

    from ellspmv_tpu_torch.bench.harness import benchmark_spmv
    from ellspmv_tpu_torch.config import value_dtype
    from ellspmv_tpu_torch.formats.hybrid import (hybrid_from_coo,
                                                  kernel_launches)
    n = coo.num_rows
    runs, counts = {}, {}
    calls = 2 + WARMUP + REPEAT
    for prec in ("float64", "float32"):
        _reset_counts()
        t0 = time.perf_counter()
        hm = hybrid_from_coo(coo, value_dtype=prec, device=device)
        _sync(device)
        host_s = time.perf_counter() - t0
        x = torch.from_numpy(x64).to(device).to(value_dtype(prec))
        per_call = kernel_launches(hm)
        log(f"  hybrid {prec}: hybrid_from_coo to {device} in {host_s:.2f} s,"
            f" hub {int(hm.hub_cols.shape[0]):,} columns holding "
            f"{hm.hub_nnz_fraction:.3f} of the slots; hub buckets (rows, "
            f"width, columns) {bucket_lines(hm.hub)}; rest buckets "
            f"{bucket_lines(hm.rest)}; launches per call {per_call}")
        res = benchmark_spmv(None, hm, x, None, repeat=REPEAT, warmup=WARMUP)
        grew = _counts()
        for line in res.iteration_lines()[:2]:
            log(f"  hybrid {prec} gemv_hybrid: {line}")
        log(f"  hybrid {prec} best: {res.best:.6f} s, {res.gnz_per_s():.3f} "
            f"Gnz/s, physical {res.actual_gb_per_s():.1f} GB/s "
            f"({res.actual_bytes:,} bytes per multiply); launches {grew}")
        for k, c in per_call.items():
            check(device != "cuda" or grew[k] == c * calls,
                  f"hybrid {prec}: {grew[k]} {k} launches, expected "
                  f"{c * calls}")
        iters = WARMUP + REPEAT
        got = res.y.double().cpu().numpy()
        _all_rows_check(f"hybrid {prec} per_iter", res.y, n, got,
                        _row_err(got, iters * want, iters * scale),
                        TOLERANCE[prec])
        counts[prec] = _counts()
        runs[prec] = (hm, x)
    return runs, counts


def _hub_gather_timing(hm, x, prec, peak_bw):
    """The hybrid's gather of x into the hub (``permute.apply_permute``),
    alone in a CUDA graph: each call on the next of several copies of x
    (and the map), more bytes together than the L2, beside the same call
    on one set of inputs, which the L2 keeps."""
    from ellspmv_tpu_torch.bench.traffic import gather_bytes
    from ellspmv_tpu_torch.ops import permute
    cols = hm.hub_cols
    one = (cols.numel() * cols.element_size() + x.numel() * x.element_size()
           + cols.numel() * x.element_size())
    copies = _rotating((cols, x), one)
    cold = graph_ms(_cycling(permute.apply_permute, copies))
    hot = graph_ms(lambda: permute.apply_permute(cols, x))
    del copies
    nbytes = gather_bytes(cols, x.element_size())
    bound_ms, _ = _bound(nbytes, 0, prec, peak_bw)
    log(f"  hybrid gather of x {prec}: {cold:.4f} ms on the device, inputs "
        f"cold ({hot:.4f} ms on one set, L2-resident); bound "
        f"{bound_ms:.4f} ms ({nbytes:,} bytes: the map, the {cols.numel():,}"
        f" hub entries of x read once, the output), "
        f"{100 * bound_ms / cold:.1f}% of it")
    return cold


def phase_hybrid_timing(coo, runs, stream_runs, peak_bw):
    """At config3: hybrid_spmv in a CUDA graph beside the stream path on the
    same matrix, in turns, and eagerly beside cuSPARSE; its device time
    split by the profiler into K1, the gather and the reassembly; K1 on
    every bucket of both parts against its plain version; its bound. The
    hybrid's row of the PERF.md table."""
    from torch.profiler import ProfilerActivity, profile

    from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
    from ellspmv_tpu_torch.ops.dispatch import spmv
    out = {}
    for prec, (hm, x) in runs.items():
        st, xs = stream_runs[prec]
        lib = cusparse_of(coo, x.dtype, x.device)
        graph = _versus(f"hybrid_spmv {prec} against the stream path "
                        "(CUDA graph, per call)",
                        {"hybrid_spmv": lambda: spmv(hm, x),
                         "stream_spmv": lambda: spmv(st, xs)}, graph_ms)
        eager = _versus(f"hybrid_spmv {prec} and cuSPARSE (eager, CUDA "
                        "events over 20 calls)",
                        {"hybrid_spmv": lambda: spmv(hm, x),
                         "cuSPARSE": lambda: lib @ x}, time_ms)
        _buckets_vs_plain(f"hybrid_spmv {prec} hub", hm.hub,
                          x[hm.hub_cols.long()], prec)
        _buckets_vs_plain(f"hybrid_spmv {prec} rest", hm.rest, x, prec)
        _hub_gather_timing(hm, x, prec, peak_bw)
        calls = 10
        _sync(x.device.type)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                spmv(hm, x)
            _sync(x.device.type)
        times = device_times_us(prof)
        buckets = {"narrow": 0, "wide": 0}
        for part in (hm.hub, hm.rest):
            for b in part.buckets:
                buckets["narrow" if b.lcol is not None else "wide"] += 1
        split = {"K1": 0.0, "gather": 0.0, "reassembly": 0.0}
        for key, (count, us) in times.items():
            if "ell_spmv_kernel" in key:
                per_call = buckets["narrow" if "unsigned short" in key
                                   else "wide"]
                split["K1"] += us / count * per_call / 1e3
            elif "permute_kernel" in key:
                split["gather"] += us / count / 1e3
            else:
                split["reassembly"] += us / calls / 1e3
        nbytes = estimate_actual_bytes(hm, with_y=False)
        work = sum(p.sellsize for p in (hm.hub, hm.rest))
        bound_ms, bound_by = _bound(nbytes, 2 * work, prec, peak_bw)
        g = graph["hybrid_spmv"]
        log(f"  hybrid_spmv {prec}: {g:.4f} ms on the device, "
            f"{eager['hybrid_spmv']:.4f} ms eager; under the profiler K1 "
            f"{split['K1']:.4f} ms ({buckets} launches), the gather "
            f"{split['gather']:.4f}, the reassembly {split['reassembly']:.4f}"
            f" per call; the stream path {graph['stream_spmv']:.4f} ms on "
            f"the device; cuSPARSE {eager['cuSPARSE']:.4f} ms eager; bound "
            f"{bound_ms:.4f} ms ({nbytes:,} bytes, {bound_by}), "
            f"{100 * bound_ms / g:.1f}% of it")
        for key, (count, us) in sorted(times.items(), key=lambda t: -t[1][1]):
            log(f"    device: {us / count:9.2f} us x {count:4d}  {key[:90]}")
        out[prec] = g
    return out


# ---------------------------------------------------------------------------
# Multi-device (``parallel/``): NCCL at world size 1, four gloo ranks on
# the one card, the dryrun and the programs
# ---------------------------------------------------------------------------

CONFIG2_ROWS = 2_000_000        # banded_random(2,000,000, 16, 512)


def _rank_launches(label, launches, need, device="cuda"):
    """Check that every rank launched each kernel of `need` (on a card; on
    the CPU the wrappers run their plain versions)."""
    for r, counts in enumerate(launches):
        check(device != "cuda" or all(counts[k] >= 1 for k in need),
              f"{label}: rank {r} did not launch {need}: {counts}")


def _ranks_report(label, res, sharded, gather_s):
    """The workload table beside each rank's kernels alone, and the
    allgather's time."""
    log(f"  {label}: per call over the ranks {res.best * 1e3:.4f} ms "
        f"(best of {len(res.times)} per_iter, allgather included); "
        f"allgather alone {gather_s * 1e3:.4f} ms")
    rows = sharded.workload_report()
    log(f"    {rows[0]}   alone (ms)")
    for line, t in zip(rows[1:], res.shard_seconds):
        log(f"    {line:<28s} {t * 1e3:.4f}")
    times = res.shard_seconds
    log(f"    slowest rank alone / mean: {max(times) / np.mean(times):.3f}")


def phase_multi_device(coo, pl_coo, pl_x64, pl_want, pl_scale,
                       device="cuda"):
    """(a) fem_mesh_2d(1440) fp64 ELL through ``parallel`` over NCCL at
    world size 1: y bit-equal to the one-device `ell_spmv`, both timed
    per_iter; (b) four ranks sharing the card over gloo: the fem ELL in
    fp64 and f32 (partition rows, y bit-equal to the one-device port), the
    config2 CSR (banded_random(2,000,000, 16, 512), --partition-nonzeros,
    every row against the oracle), config3's stream
    format under the rows and the nonzeros partitions (every row within
    1e-13 of sum |a*x|), CG on the fem mesh (true residual <= 10*tol,
    iterations within 1 of the one-device solve), each with the workload
    table, each rank's kernels alone and the allgather's time; the kernels
    launched on every rank; (d) ``dryrun_multichip(4)`` on the card;
    (e) the programs: ``ellspmv --devices=2`` on cuda exits 1, and
    ``ellspmv``/``cgsolve --device=cpu --devices=4 -v`` on a
    fem_mesh_2d(256) file held against the oracle. ((c), the cuda tests of
    ``tests/test_torch_card.py`` over 1, 2 and 4 ranks, ran in phase 3.)
    Returns the ranks' kernel launches."""
    import torch

    from ellspmv_tpu_torch.bench.harness import (benchmark_sharded,
                                                 benchmark_spmv)
    from ellspmv_tpu_torch.cli.cgsolve import solve
    from ellspmv_tpu_torch.formats.csr import csr_from_coo
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.models.generators import banded_random
    from ellspmv_tpu_torch.ops.dispatch import spmv
    from ellspmv_tpu_torch.parallel.dryrun import dryrun_multichip
    from ellspmv_tpu_torch.parallel.launch import RankPool
    from ellspmv_tpu_torch.parallel.mesh import describe
    from ellspmv_tpu_torch.parallel.solver import solve_sharded
    from ellspmv_tpu_torch.parallel.spmv import (gather_seconds_task,
                                                 run_spmv, shard_matrix)
    from ellspmv_tpu_torch.parallel.stream import shard_stream

    one_rank = ["cuda:0"] if device == "cuda" else ["cpu"]
    shared = one_rank * 4
    totals = []
    n = coo.num_rows
    x64 = torch.from_numpy(np.random.RandomState(41).rand(n))
    t0 = time.perf_counter()
    ells = {prec: ell_from_coo(coo, sort_rows=True, value_dtype=prec)
            for prec in ("float64", "float32")}
    log(f"  fem_mesh_2d(1440) ELL on the host, fp64 and f32: "
        f"{time.perf_counter() - t0:.1f} s")

    # (a) NCCL at world size 1 against the one-device call
    ell = ells["float64"]
    card = ell.to(device)
    one = benchmark_spmv(None, card, x64.to(device), repeat=10, warmup=2)
    with RankPool(one_rank) as pool:
        t0 = time.perf_counter()
        sm = shard_matrix(ell, 1)
        launches = []
        y = run_spmv(pool, sm, x64, launches=launches)
        check(torch.equal(y, spmv(card, x64.to(device)).cpu()),
              "(a) NCCL world 1: y differs from the one-device ell_spmv")
        res = benchmark_sharded(pool, sm, x64, repeat=10, warmup=2,
                                matrix=ell)
        check(torch.equal(res.y, one.y.cpu()),
              "(a) NCCL world 1: the benchmark's y differs from the "
              "one-device benchmark's")
        totals += launches + res.rank_launches
        gather_s = pool.run(gather_seconds_task, [(sm.split_x(x64)[0],)])[0]
    _rank_launches("(a)", launches, ["ell_spmv"], device)
    log(f"  (a) {describe(one_rank)}: y bit-equal to the one-device "
        f"ell_spmv; per_iter best {res.best * 1e3:.4f} ms over the ranks "
        f"(allgather alone {gather_s * 1e3:.4f} ms) against "
        f"{one.best * 1e3:.4f} ms on one device: "
        f"{(res.best - one.best) * 1e3:+.4f} ms per call "
        f"({time.perf_counter() - t0:.1f} s)")
    del card, one

    # (b) four ranks sharing the card over gloo
    with RankPool(shared, timeout=900) as pool:
        log(f"  (b) {describe(shared)}")
        for prec, ell in ells.items():
            t0 = time.perf_counter()
            sm = shard_matrix(ell, 4)
            x = x64.to(ell.values.dtype)
            launches = []
            y = run_spmv(pool, sm, x, launches=launches)
            check(torch.equal(y, spmv(ell.to(device), x.to(device)).cpu()),
                  f"(b) fem ELL {prec}: y differs from the one-device port")
            res = benchmark_sharded(pool, sm, x, repeat=5, warmup=1,
                                    matrix=ell, per_device=True)
            gather_s = pool.run(gather_seconds_task,
                                [(b,) for b in sm.split_x(x)])[0]
            totals += launches + res.rank_launches
            _rank_launches(f"(b) fem ELL {prec}", launches, ["ell_spmv"], device)
            _ranks_report(f"(b) fem ELL {prec}, partition rows, y bit-equal"
                          " to the one-device port", res, sm, gather_s)
            log(f"    ({time.perf_counter() - t0:.1f} s)")
        del ells

        t0 = time.perf_counter()
        bcoo = banded_random(CONFIG2_ROWS if device == "cuda" else 20_000, 16,
                             512, seed=0)
        bx = np.random.RandomState(42).rand(bcoo.num_columns)
        csr = csr_from_coo(bcoo, value_dtype="float64")
        sm = shard_matrix(csr, 4, partition="nonzeros")
        launches = []
        y = run_spmv(pool, sm, torch.from_numpy(bx), launches=launches)
        want, scale = row_oracle(bcoo, bx)
        err = _row_err(y.numpy(), want, scale)
        check(err <= TOLERANCE["float64"],
              f"(b) config2 CSR: rows disagree with the oracle: {err:.3e}")
        res = benchmark_sharded(pool, sm, torch.from_numpy(bx), repeat=5,
                                warmup=1, matrix=csr, per_device=True)
        gather_s = pool.run(gather_seconds_task,
                            [(b,) for b in sm.split_x(torch.from_numpy(bx))
                             ])[0]
        totals += launches + res.rank_launches
        _rank_launches("(b) config2 CSR", launches, ["ell_spmv"], device)
        _ranks_report(f"(b) config2 CSR --partition-nonzeros: every row "
                      f"within {err:.3e} of sum|a*x|", res, sm, gather_s)
        log(f"    ({time.perf_counter() - t0:.1f} s)")
        del bcoo, csr, sm, want, scale

        px = torch.from_numpy(pl_x64)
        for partition in ("rows", "nonzeros"):
            t0 = time.perf_counter()
            ss = shard_stream(pl_coo, 4, partition=partition,
                              value_dtype="float64")
            plan_s = time.perf_counter() - t0
            launches = []
            y = run_spmv(pool, ss, px, launches=launches)
            err = _row_err(y.numpy(), pl_want, pl_scale)
            check(err <= TOLERANCE["float64"],
                  f"(b) config3 stream, {partition}: rows disagree with the "
                  f"oracle: {err:.3e}")
            res = benchmark_sharded(pool, ss, px, repeat=5, warmup=1,
                                    metrics=_stream_metrics(ss),
                                    per_device=True)
            gather_s = pool.run(gather_seconds_task,
                                [(b,) for b in ss.split_x(px)])[0]
            totals += launches + res.rank_launches
            _rank_launches(f"(b) config3 stream {partition}", launches,
                           ["ell_spmv", "stream_sum", "permute"], device)
            _ranks_report(f"(b) config3 stream, partition {partition}: "
                          f"every row within {err:.3e} of sum|a*x|; the "
                          f"ranks' plans {plan_s:.1f} s on the host", res,
                          ss, gather_s)
            log(f"    ({time.perf_counter() - t0:.1f} s)")
            del ss

        t0 = time.perf_counter()
        tol, maxiter = CG_SETTINGS["float64"]
        b = np.ones(n)
        _, one, _ = solve(coo, b, tol=tol, maxiter=maxiter, device=device)
        sm = shard_matrix(ell_from_coo(coo, sort_rows=True,
                                       value_dtype="float64"), 4)
        sol = solve_sharded(pool, sm, torch.from_numpy(b), tol=tol,
                            maxiter=maxiter)
        rel = true_residual(coo, sol["x"], b)
        totals += sol["launches"]
        _rank_launches("(b) CG", sol["launches"], ["ell_spmv", "dot"], device)
        log(f"  (b) CG fp64 over the ranks: {sol['iterations']} iterations "
            f"(one device: {one.iterations}), true residual {rel:.3e} of "
            f"||b|| (tol {10 * tol:g}), {sol['seconds']:.3f} s in CG "
            f"({sol['seconds'] / max(sol['iterations'], 1) * 1e3:.3f} ms per"
            f" iteration; {time.perf_counter() - t0:.1f} s with set-up)")
        check(rel <= 10 * tol and abs(sol["iterations"] - one.iterations)
              <= 1, "(b) CG over the ranks: residual or iterations off")
        del sm

    # (d) the dryrun on the card
    t0 = time.perf_counter()
    line = dryrun_multichip(4, placement=shared)
    log(f"  (d) {line} ({time.perf_counter() - t0:.1f} s)")

    # (e) the programs
    import io

    from ellspmv_tpu_torch.io.mtx import read_vector, write_matrix
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d
    if device == "cuda":
        proc = _run_cli(["--devices=2", "examples/test.mtx"], "--devices=2 "
                        "on cuda", expect=1)
        check("requested 2 devices, have 1" in proc.stderr,
              f"ellspmv --devices=2 on cuda: {proc.stderr!r}")
    small = fem_mesh_2d(256)
    want, scale = row_oracle(small, np.ones(small.num_columns))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fem_mesh_2d_256.mtx")
        write_matrix(path, small)
        proc = _run_cli(["--device=cpu", "--devices=4", "-v", path],
                        "--device=cpu --devices=4 -v")
        y = read_vector(io.BytesIO(proc.stdout.encode()))
        err = _row_err(y, want, scale)
        check(len(y) == small.num_rows and err <= TOLERANCE["float64"]
              and "rows per device:" in proc.stderr,
              f"ellspmv --device=cpu --devices=4: y err {err:.3e}")
        proc = _run_cli(["--device=cpu", "--devices=4", "-v", path],
                        "--device=cpu --devices=4 -v", "cgsolve")
        x = read_vector(io.BytesIO(proc.stdout.encode()))
        rel = true_residual(small, x, np.ones(small.num_rows))
        check(len(x) == small.num_rows and rel <= 1e-7,
              f"cgsolve --device=cpu --devices=4: true residual {rel:.3e}")
    log(f"  (e) ellspmv over 4 CPU ranks: every row within {err:.3e} of "
        f"sum|a*x|; cgsolve over 4 CPU ranks: true residual {rel:.3e}")
    return {k: sum(c[k] for c in totals) for k in totals[0]}


def _stream_metrics(ss):
    """The stream format's accounting (``bench/harness.py``) of a sharded
    fp64 stream, whose whole matrix is not built."""
    from ellspmv_tpu_torch.bench.harness import SpmvMetrics
    n, m, nnz = ss.num_rows, ss.num_columns, ss.num_nonzeros
    return SpmvMetrics(nnz, 2 * nnz, 8 * (n + m) + 12 * nnz, 8 * n + 20 * nnz)


# ---------------------------------------------------------------------------
# The suite, and the card tests by name
# ---------------------------------------------------------------------------

# The JAX package's stream path at config3-10x, normwise against the oracle
# (VERDICT weak 2; double-double on the TPU): the range F2 names.
JAX_10X_ERR = (3.6e-14, 4.4e-14)


def phase_suite(timing, peak_bw):
    """``python -m ellspmv_tpu_torch.bench.suite --json``, in this process
    so that the launch counts are read: every row at full scale, each timed
    row's y held against the oracle (fp64, 1e-13 of sum |a*x| per row);
    config3-10x's normwise error beside the JAX package's; the triad beside
    the data sheet, and K1's and K2's bytes at fem_mesh_2d(1440) over it.
    Returns the rows and the counts."""
    import torch

    from ellspmv_tpu_torch.bench.suite import run_suite
    from ellspmv_tpu_torch.ops.dispatch import spmv

    def hold(name, coo, matrix, x64):
        t0 = time.perf_counter()
        got = spmv(matrix, torch.from_numpy(x64).cuda())
        want, scale = row_oracle(coo, x64)
        err = _row_err(got.double().cpu().numpy(), want, scale)
        log(f"  suite {name}: all {coo.num_rows:,} rows against the oracle: "
            f"max err {err:.3e} of sum|a*x| (tol 1e-13; "
            f"{time.perf_counter() - t0:.1f} s)")
        check(err <= TOLERANCE["float64"],
              f"suite {name}: rows disagree with the oracle: {err:.3e}")

    class Log:
        def write(self, text):
            for line in text.rstrip("\n").split("\n"):
                log(f"  suite: {line}")

    _reset_counts()
    rows = run_suite(quick=False, as_json=True, stream=Log(), device="cuda",
                     check=hold)
    counts = _counts()
    log(f"  suite: launches {counts}")
    by = {r["config"]: r for r in rows}
    err10 = by["config3-10x stream oracle"]["normwise_err"]
    log(f"  suite: config3-10x normwise error {err10:.3e} (the JAX package: "
        f"{JAX_10X_ERR[0]:.1e}-{JAX_10X_ERR[1]:.1e}, ROADMAP F2)")
    peak = by["hbm_peak"]
    triad = peak["measured_gb_per_s"]
    log(f"  suite: triad {triad:.1f} GB/s against the data sheet's "
        f"{peak_bw / 1e9:.1f} ({100 * triad * 1e9 / peak_bw:.1f}%); "
        f"source {peak['source']}")
    for name in ("ell_spmv", "dia_spmv"):
        t = timing[name, "float64"]
        rate = t["bound_ms"] * peak_bw / t["ms"] / 1e9
        log(f"  suite: {name} at fem_mesh_2d(1440) fp64 moves {rate:.1f} GB/s"
            f", {100 * rate / triad:.1f}% of the triad")
    return rows, counts


CARD_TESTS = ["tests/test_torch_card.py", "tests/test_torch_imports.py"]


def phase_card_tests():
    """The ``cuda`` tests by name: pytest on the card, without the JAX
    package's conftest. Fails if any fails or none ran."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p",
           "no:cacheprovider", "-m", "cuda", *CARD_TESTS, "-q", "-rA"]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=900)
    outcomes = re.findall(r"^(PASSED|FAILED|ERROR|SKIPPED)\s+(\S+)",
                          proc.stdout, re.M)
    for outcome, name in outcomes:
        log(f"  card test {outcome}: {name}")
    summary = proc.stdout.strip().splitlines()[-1:] or ["(no output)"]
    log(f"  card tests: {summary[0]} (exit {proc.returncode})")
    failed = [n for o, n in outcomes if o in ("FAILED", "ERROR")]
    if proc.returncode != 0 or failed:
        for line in (proc.stdout + proc.stderr).splitlines()[-80:]:
            log(f"  pytest: {line}")
    check(proc.returncode == 0 and not failed,
          f"card tests failed: {failed or 'see the pytest lines above'}")
    passed = sum(o == "PASSED" for o, _ in outcomes)
    check(passed > 0, "no card test ran")
    return passed


CARD = [None]    # the nvidia-smi line: the card's name and power limit


PHASE_SECONDS = {}


def timed(label, fn, *args, **kw):
    """Run one phase, log its seconds and keep them for the summary."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    PHASE_SECONDS[label] = time.perf_counter() - t0
    log(f"[{label}: {PHASE_SECONDS[label]:.1f} s]")
    return out


def main() -> int:
    import torch

    from ellspmv_tpu_torch.config import hbm_peak_bytes_per_s
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.models.generators import (dense_rows, fem_mesh_2d,
                                                     power_law)
    from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy
    t_start = time.perf_counter()
    phase_device()
    peak_bw = hbm_peak_bytes_per_s("cuda")
    check(peak_bw is not None, f"no data-sheet memory peak for "
                               f"{torch.cuda.get_device_name(0)} in "
                               "ellspmv_tpu_torch/config.py (set "
                               "HBM_PEAK_GBPS)")
    timed("build", phase_build)
    log("phase 3: the card tests by name, and each kernel against its plain "
        "version")
    timed("card tests", phase_card_tests)
    timed("K1 vs plain", phase_kernel_vs_plain)
    timed("K2 vs plain", phase_dia_vs_plain)
    timed("K7 vs plain", phase_probe_vs_plain)
    timed("K6 vs plain", phase_dot_vs_plain)
    timed("stream vs plain", phase_stream_vs_plain)
    timed("SELL and CSR vs plain", phase_sell_vs_plain)
    timed("hybrid vs plain", phase_hybrid_vs_plain)
    timed("F8 probe", phase_f8)
    log("phase 4: the ellspmv, cgsolve and csrspmv programs")
    timed("programs: ELL, DIA, CG", phase_cli)
    timed("programs: stream", phase_stream_cli)
    timed("programs: SELL and CSR", phase_sell_csr_cli)
    timed("programs: hybrid, xla, papi, trace", phase_hybrid_cli)
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
    ell_runs, ell_counts = timed("ELL path", phase_ell_path, coo, x64,
                                 sample)
    dia_runs, dia_counts = timed("headline path", phase_headline_path, coo,
                                 x64, sample)
    log(f"max_memory_allocated: {torch.cuda.max_memory_allocated():,} "
        "bytes")
    cg_counts = timed("solver path", phase_cg_path, coo, peak_bw)
    log(f"solver path: launches {cg_counts}")
    timed("headline program", phase_headline_program)
    t0 = time.perf_counter()
    fem_want, fem_scale = row_oracle(coo, x64)
    log(f"fem_mesh_2d(1440): the oracle over all rows in "
        f"{time.perf_counter() - t0:.1f} s")
    csr_runs, csr_counts = timed("CSR path", phase_csr_path, coo, x64,
                                 fem_want, fem_scale)
    del fem_want, fem_scale
    t0 = time.perf_counter()
    pl_coo = power_law(*CONFIG3, seed=0)
    pl_x64 = np.random.RandomState(2).rand(pl_coo.num_columns)
    pl_want = coo_spmv_numpy(pl_coo, pl_x64)
    pl_scale = coo_spmv_numpy(CooMatrix(
        pl_coo.num_rows, pl_coo.num_columns, pl_coo.rowidx, pl_coo.colidx,
        np.abs(pl_coo.values)), pl_x64)
    log(f"full size: power_law{CONFIG3} (config3): {pl_coo.num_rows:,} rows, "
        f"{pl_coo.num_nonzeros:,} nonzeros, longest row "
        f"{int(np.bincount(pl_coo.rowidx).max()):,}; generated with its "
        f"oracle in {time.perf_counter() - t0:.1f} s")
    stream_runs, stream_counts = timed("stream path", phase_stream_path,
                                       pl_coo, pl_x64, pl_want, pl_scale)
    hybrid_runs, hybrid_counts = timed("hybrid path", phase_hybrid_path,
                                       pl_coo, pl_x64, pl_want, pl_scale)
    t0 = time.perf_counter()
    dr_coo = dense_rows(**DENSE_ROWS)
    dr_x64 = np.random.RandomState(3).rand(dr_coo.num_columns)
    dr_want, dr_scale = row_oracle(dr_coo, dr_x64)
    log(f"full size: dense_rows({DENSE_ROWS}): {dr_coo.num_rows:,} rows, "
        f"{dr_coo.num_nonzeros:,} nonzeros, longest row "
        f"{int(np.bincount(dr_coo.rowidx).max()):,}; generated with its "
        f"oracle in {time.perf_counter() - t0:.1f} s")
    sell_runs, sell_counts, chosen = timed("SELL path", phase_sell_path,
                                           dr_coo, dr_x64, dr_want, dr_scale)
    del dr_want, dr_scale
    log("phase 6: timing")
    timing = timed("ELL and DIA timing", phase_timing, coo, ell_runs,
                   dia_runs, peak_bw)
    timing.update(timed("stream timing", phase_stream_timing, pl_coo,
                        stream_runs, peak_bw))
    timed("CSR timing", phase_csr_timing, coo, csr_runs, ell_runs, peak_bw)
    timed("SELL timing", phase_sell_timing, dr_coo, sell_runs, peak_bw,
          chosen)
    timed("hybrid timing", phase_hybrid_timing, pl_coo, hybrid_runs,
          stream_runs, peak_bw)
    timed("K7 floor", probe_floor)
    window_verdict()
    del ell_runs, dia_runs, csr_runs, stream_runs, hybrid_runs, sell_runs
    del dr_coo
    log("phase 7: multi-device")
    multi_counts = timed("multi-device", phase_multi_device, coo, pl_coo,
                         pl_x64, pl_want, pl_scale)
    log(f"multi-device: the ranks' launches {multi_counts}")
    del coo, pl_coo, pl_want, pl_scale
    log("phase 8: the benchmark suite")
    _, suite_counts = timed("suite", phase_suite, timing, peak_bw)
    paths = [ell_counts, dia_counts, *cg_counts.values(),
             *stream_counts.values(), *csr_counts.values(),
             *sell_counts.values(), *hybrid_counts.values(), multi_counts,
             suite_counts]
    launches = {name: sum(c[name] for c in paths)
                for name in ("ell_spmv", "dia_spmv", "fma_probe", "permute",
                             "stream_sum", "stream_sum_src")}
    launches["dot"] = cg_counts["float64"]["dot"] + multi_counts["dot"]
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the main paths was not launched: {launches}")
    kernels = []
    for name, key in (("ell_spmv", "float64"), ("fma_probe", "float32"),
                      ("dia_spmv", "float64"), ("dot", "float64"),
                      ("stream_sum", "float64"),
                      ("stream_sum_src", "float64"), ("permute", "float64")):
        source, replaces = KERNELS[name]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
                        **timing[name, key]})
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in PHASE_SECONDS.items()))
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
