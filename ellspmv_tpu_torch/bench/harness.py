"""Benchmark harness: warmup and a timed loop with the reference's exact
metric accounting, and the device-memory roofline, the counterpart of
``ellspmv_tpu.bench.harness``.

ELL formulas (ellspmv.c:1857-1862):

    flops     = 2*(ellsize + diagsize)          # diagsize counted always
    min_bytes = rows*sv + cols*sv + ellsize*si + ellsize*sv + diagsize*sv
    max_bytes = rows*sv + ellsize*sv + ellsize*si + ellsize*sv
                + diagsize*sv + diagsize*sv     # x re-read per nonzero

DIA (no reference analogue; the JAX package's accounting): every stored
diagonal value takes part and no column index is read:

    flops = 2*diasize, min_bytes = rows*sv + cols*sv + diasize*sv,
    max_bytes = rows*sv + 2*diasize*sv

Stream (the JAX package's accounting; sv is the compute type's size, 4 for
bfloat16): each stored entry is moved as a 4-byte position and a value:

    flops = 2*nnz, min_bytes = rows*sv + cols*sv + nnz*(4 + sv),
    max_bytes = rows*sv + nnz*(4 + 2*sv)

Gnz/s uses the file's stored nonzero count (ellspmv.c:1871).

Two timing protocols:

- ``per_iter`` (ellspmv.c:1745-1876): two discarded calls, `warmup`
  untimed iterations, then `repeat` timed ones, with y accumulating. On a
  CUDA device each timed iteration is bracketed by CUDA events and followed
  by a synchronise, so the host's launch path inside the events counts.
  Where the best time is under 3x the round trip of an empty launch and a
  synchronise, the result carries the JAX package's warning that the times
  measure dispatch (`BenchResult.warning`).
- ``chained``: y accumulates with a serial dependency, ``x <- 1e-6*y_new``
  after each multiply, in loops of two lengths; the slope of their times is
  the time per iteration, so what is constant per loop (the first launch,
  the final synchronise) drops out. On a CUDA device each loop is timed
  with CUDA events around the whole loop and no host synchronise inside
  it. The slope includes the ``x <- 1e-6*y`` pass (2*rows*sv bytes). fp64
  carries native fp64 (the JAX package carries double-double pairs on the
  TPU).

On the CPU both protocols time with the host clock.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable

import torch

from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
from ellspmv_tpu_torch.config import hbm_peak_bytes_per_s
from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix
from ellspmv_tpu_torch.formats.stream import StreamMatrix

# The chained protocol's carry scale: small enough that ||A||*scale < 1 for
# any realistic matrix, so y cannot overflow in long loops.
CHAINED_SCALE = 1e-6


@dataclasses.dataclass
class SpmvMetrics:
    """Static per-iteration work accounting (reference formulas)."""
    num_nonzeros: int      # stored entries in the file (Gnz/s numerator)
    num_flops: int
    min_bytes: int
    max_bytes: int

    @staticmethod
    def for_matrix(matrix) -> "SpmvMetrics":
        if isinstance(matrix, EllMatrix):
            sv = matrix.values.element_size()
            si = matrix.colidx.element_size()
            n, m = matrix.num_rows, matrix.num_columns
            ellsize, diagsize = matrix.ellsize, matrix.diagsize
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * (ellsize + diagsize),
                min_bytes=(n * sv + m * sv + ellsize * si + ellsize * sv
                           + diagsize * sv),
                max_bytes=(n * sv + ellsize * sv + ellsize * si
                           + ellsize * sv + diagsize * sv + diagsize * sv))
        if isinstance(matrix, DiaMatrix):
            sv = matrix.data.element_size()
            n, m = matrix.num_rows, matrix.num_columns
            diasize = matrix.diasize
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * diasize,
                min_bytes=n * sv + m * sv + diasize * sv,
                max_bytes=n * sv + diasize * sv + diasize * sv)
        if isinstance(matrix, StreamMatrix):
            # padding-free: every stored entry counted once as a 4-byte
            # position and a value, as the JAX package counts it
            sv = matrix.values.element_size()
            n, m = matrix.num_rows, matrix.num_columns
            work = matrix.worksize
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * work,
                min_bytes=n * sv + m * sv + work * (4 + sv),
                max_bytes=n * sv + work * (4 + 2 * sv))
        raise NotImplementedError(
            f"metrics for {type(matrix).__name__} are not yet ported "
            "(see ROADMAP.md)")


@dataclasses.dataclass
class BenchResult:
    times: list[float]          # seconds per timed iteration
    metrics: SpmvMetrics
    y: torch.Tensor | None      # result after the accumulating iterations
    device: str                 # the card's name, or "cpu"
    protocol: str = "per_iter"
    hbm_peak: float | None = None    # bytes/s of the card; None on the CPU
    span_iters: int | None = None    # chained: iterations in the slope
    actual_bytes: int | None = None  # bytes the kernel moves per iteration
    warning: str | None = None       # per_iter: the times measure dispatch

    @property
    def best(self) -> float:
        return min(self.times)

    def gnz_per_s(self, t=None) -> float:
        return self.metrics.num_nonzeros * 1e-9 / (t or self.best)

    def gflop_per_s(self, t=None) -> float:
        return self.metrics.num_flops * 1e-9 / (t or self.best)

    def min_gb_per_s(self, t=None) -> float:
        return self.metrics.min_bytes * 1e-9 / (t or self.best)

    def max_gb_per_s(self, t=None) -> float:
        return self.metrics.max_bytes * 1e-9 / (t or self.best)

    def roofline_fraction(self) -> float | None:
        """Effective bandwidth (min-bytes model) / the card's peak; formats
        that store less than ELLPACK can exceed 1."""
        if self.hbm_peak is None:
            return None
        return self.metrics.min_bytes / self.best / self.hbm_peak

    def actual_gb_per_s(self, t=None) -> float | None:
        """The kernel's own bytes (bench/traffic.py) over the time."""
        if self.actual_bytes is None:
            return None
        return self.actual_bytes * 1e-9 / (t or self.best)

    def physical_roofline(self) -> float | None:
        """The kernel's own bytes over the time / the card's peak: at most
        about 1, unlike the effective share."""
        if self.actual_bytes is None or self.hbm_peak is None:
            return None
        return self.actual_bytes / self.best / self.hbm_peak

    def iteration_lines(self) -> list[str]:
        """Per-iteration report in the reference's format
        (ellspmv.c:1868-1875). Under the chained protocol the measurement
        is one slope, printed once and labelled as such."""
        if self.protocol == "chained":
            t = self.best
            span = (f" over a {self.span_iters}-iteration chained span"
                    if self.span_iters else "")
            return [f"{t:.9f} seconds/iteration (slope{span}; "
                    f"{self.gnz_per_s(t):.3f} Gnz/s, "
                    f"{self.gflop_per_s(t):.3f} Gflop/s, "
                    f"{self.min_gb_per_s(t):.1f} to "
                    f"{self.max_gb_per_s(t):.1f} GB/s)"]
        return [f"{t:.6f} seconds ({self.gnz_per_s(t):.3f} Gnz/s, "
                f"{self.gflop_per_s(t):.3f} Gflop/s, "
                f"{self.min_gb_per_s(t):.1f} to {self.max_gb_per_s(t):.1f} "
                f"GB/s)" for t in self.times]


def dispatch_round_trip(device: torch.device) -> float:
    """Seconds of an empty launch and a synchronise on `device`, the least
    of three after one untimed (the JAX harness's no-op round trip)."""
    z = torch.zeros((), device=device)

    def once() -> float:
        t0 = time.perf_counter()
        torch.add(z, 1)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    once()
    return min(once() for _ in range(3))


def _dispatch_warning(best: float, dispatch: float) -> str | None:
    """Per-iteration times under 3x the launch round trip measure dispatch,
    not the kernel (``ellspmv_tpu.bench.harness._dispatch_warning``, its
    text)."""
    if best < 3 * dispatch:
        return (f"per-iteration times are dispatch-dominated (dispatch "
                f"round trip ~{dispatch * 1e3:.1f} ms); use "
                "--protocol=chained for kernel-time measurements")
    return None


def _per_iter(spmv_fn, matrix, x, y, repeat, warmup, sync):
    cuda = x.device.type == "cuda"
    # Two discarded calls before the loop, as in the JAX harness (there they
    # compile both trace signatures; here they load the kernel and warm the
    # allocator), so the first timed line is a plain kernel run.
    d1 = spmv_fn(matrix, x, y)
    spmv_fn(matrix, x, d1)
    yk = y
    for _ in range(warmup):
        yk = spmv_fn(matrix, x, yk)
    sync()
    times = []
    for _ in range(repeat):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yk = spmv_fn(matrix, x, yk)
            end.record()
            sync()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            yk = spmv_fn(matrix, x, yk)
            times.append(time.perf_counter() - t0)
    return times, yk


def _chained(spmv_fn, matrix, x, y, repeat, warmup, sync):
    """The slope of two chained loop lengths, best of 3, with one rescale
    towards a 0.3 s span (at most 4096 iterations); returns the time per
    iteration, the y of the last long loop and its length."""
    if matrix.num_rows != matrix.num_columns:
        raise ValueError("chained protocol needs a square matrix "
                         "(x is re-derived from y each iteration)")
    # the carry stays in the values' type (an f32 kernel returns f32 y,
    # which becomes the next x)
    dtype = (matrix.data if isinstance(matrix, DiaMatrix)
             else matrix.values).dtype
    x0 = x.to(dtype)
    y0 = (torch.zeros(matrix.num_rows, dtype=dtype, device=x.device)
          if y is None else y.to(dtype))
    xk = torch.empty_like(x0)      # the loop writes x here: no allocation

    def run(iters):
        xk.copy_(x0)
        yk = y0
        for _ in range(iters):
            yk = spmv_fn(matrix, xk, yk)
            torch.mul(yk, CHAINED_SCALE, out=xk)   # the serial dependency
        return yk

    def timed(iters):
        if x.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = run(iters)
            end.record()
            sync()
            return start.elapsed_time(end) * 1e-3, out
        t0 = time.perf_counter()
        out = run(iters)
        return time.perf_counter() - t0, out

    def measure(lo, hi):
        timed(lo)
        timed(lo + hi)
        per_iter, out = float("inf"), None
        for _ in range(3):
            t_lo, _ = timed(lo)
            t_hi, out = timed(lo + hi)
            per_iter = min(per_iter, max((t_hi - t_lo) / hi, 1e-12))
        return per_iter, out

    lo, hi = max(1, warmup or 2), max(8, repeat)
    per_iter, out = measure(lo, hi)
    if per_iter * hi < 0.25:
        hi2 = min(1 << math.ceil(math.log2(0.3 / max(per_iter, 1e-7))), 4096)
        if hi2 > 2 * hi:
            per_iter, out = measure(lo, hi2)
            hi = hi2
    return per_iter, out, hi


def benchmark_spmv(spmv_fn: Callable | None, matrix, x: torch.Tensor,
                   y: torch.Tensor | None = None, repeat: int = 1,
                   warmup: int = 0, protocol: str = "per_iter",
                   metrics: SpmvMetrics | None = None) -> BenchResult:
    """Benchmark `spmv_fn(matrix, x, y) -> y_new` on the device of `x`
    (`spmv_fn=None` uses the library dispatch) under `protocol`; `metrics`
    defaults to the matrix's own accounting."""
    if metrics is None:
        metrics = SpmvMetrics.for_matrix(matrix)
    if spmv_fn is None:
        from ellspmv_tpu_torch.ops.dispatch import spmv as spmv_fn
    cuda = x.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(x.device)

    device = torch.cuda.get_device_name(x.device) if cuda else "cpu"
    span = warning = None
    if protocol == "per_iter":
        times, yk = _per_iter(spmv_fn, matrix, x, y, repeat, warmup, sync)
        warning = _dispatch_warning(min(times), dispatch_round_trip(x.device))
    elif protocol == "chained":
        per_iter, yk, span = _chained(spmv_fn, matrix, x, y, repeat, warmup,
                                      sync)
        times = [per_iter] * repeat
    else:
        raise ValueError(f"unknown protocol {protocol!r}")
    return BenchResult(times, metrics, yk, device, protocol,
                       hbm_peak_bytes_per_s(x.device), span_iters=span,
                       actual_bytes=estimate_actual_bytes(matrix),
                       warning=warning)
