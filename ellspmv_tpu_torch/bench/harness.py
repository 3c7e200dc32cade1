"""Benchmark harness: warmup and a timed loop with the reference's exact
metric accounting, the counterpart of ``ellspmv_tpu.bench.harness`` for the
``per_iter`` protocol.

ELL formulas (ellspmv.c:1857-1862):

    flops     = 2*(ellsize + diagsize)          # diagsize counted always
    min_bytes = rows*sv + cols*sv + ellsize*si + ellsize*sv + diagsize*sv
    max_bytes = rows*sv + ellsize*sv + ellsize*si + ellsize*sv
                + diagsize*sv + diagsize*sv     # x re-read per nonzero

Gnz/s uses the file's stored nonzero count (ellspmv.c:1871).

Protocol (ellspmv.c:1745-1876): two discarded calls, `warmup` untimed
iterations, then `repeat` timed ones, with y accumulating across warmup and
timed iterations. On a CUDA device each timed iteration is bracketed by CUDA
events and followed by a synchronise; on the CPU it is timed with the host
clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from ellspmv_tpu_torch.formats.ell import EllMatrix


@dataclasses.dataclass
class SpmvMetrics:
    """Static per-iteration work accounting (reference formulas)."""
    num_nonzeros: int      # stored entries in the file (Gnz/s numerator)
    num_flops: int
    min_bytes: int
    max_bytes: int

    @staticmethod
    def for_matrix(matrix) -> "SpmvMetrics":
        if not isinstance(matrix, EllMatrix):
            raise NotImplementedError(
                f"metrics for {type(matrix).__name__} are not yet ported "
                "(see ROADMAP.md)")
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


@dataclasses.dataclass
class BenchResult:
    times: list[float]          # seconds per timed iteration
    metrics: SpmvMetrics
    y: torch.Tensor | None      # result after warmup+timed iterations
    device: str                 # the card's name, or "cpu"

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

    def iteration_lines(self) -> list[str]:
        """Per-iteration report in the reference's format
        (ellspmv.c:1868-1875)."""
        return [f"{t:.6f} seconds ({self.gnz_per_s(t):.3f} Gnz/s, "
                f"{self.gflop_per_s(t):.3f} Gflop/s, "
                f"{self.min_gb_per_s(t):.1f} to {self.max_gb_per_s(t):.1f} "
                f"GB/s)" for t in self.times]


def benchmark_spmv(spmv_fn: Callable | None, matrix, x: torch.Tensor,
                   y: torch.Tensor | None = None, repeat: int = 1,
                   warmup: int = 0) -> BenchResult:
    """Benchmark `spmv_fn(matrix, x, y) -> y_new` on the device of `x`
    (`spmv_fn=None` uses the library dispatch)."""
    metrics = SpmvMetrics.for_matrix(matrix)
    if spmv_fn is None:
        from ellspmv_tpu_torch.ops.dispatch import spmv as spmv_fn
    cuda = x.device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(x.device)

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
    device = torch.cuda.get_device_name(x.device) if cuda else "cpu"
    return BenchResult(times, metrics, yk, device)
