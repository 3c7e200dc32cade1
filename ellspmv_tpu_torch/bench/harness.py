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

CSR (csrspmv.c:2882-2887): the ELL formulas over csrsize, plus rowptr
((rows+1)*si in min_bytes, rows*si in max_bytes).

SELL (the JAX package's accounting): every stored slot, padding included,
and every tail entry counted as a 4-byte index and a value:

    flops = 2*work, min_bytes = rows*sv + cols*sv + work*(4 + sv),
    max_bytes = rows*sv + work*(4 + 2*sv), work = sellsize + tailsize

The hybrid: the SELL formulas over the work of both parts, the hub's and
the rest's.

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
  the final synchronise) drops out. As in the JAX package, whose loop is
  one ``jax.jit`` of a ``lax.fori_loop``, the slope is device time per
  iteration: on a CUDA device the loop runs in blocks of `CHAINED_BLOCK`
  iterations and single ones, each captured once in a CUDA graph
  (``utils/graphs.py``; the matrix through ``ops.dispatch.traceable_spmv``
  unless the caller gives `spmv_fn`), and each loop is timed with CUDA
  events around graph replays alone. The slope includes the ``x <-
  1e-6*y`` pass (2*rows*sv bytes). On the CPU the same blocks run eagerly.
  fp64 carries native fp64 (the JAX package carries double-double pairs on
  the TPU).

On the CPU both protocols time with the host clock.

Over ranks (``parallel/``, `benchmark_sharded`) every timed call includes
the allgather of x, as the JAX package's sharded call does: per_iter
brackets each rank's call with CUDA events after a barrier, and chained
makes each rank's y block its next x block (square matrices), in the same
blocks through ``parallel/spmv.sharded_spmv_fn``: on NCCL ranks, a card
each, the blocks are CUDA graphs that hold the allgather, as the JAX
package jits the loop around its ``shard_map``; on CPU ranks they run
eagerly. Gloo ranks that share a card launch every iteration eagerly
(`_eager_loop`): gloo's collectives on a card cannot be captured. Every
time is the maximum over the ranks (the reference's region ends at the
team's barrier), so the ranks take the same decisions and report the same
times.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Callable

import torch

from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
from ellspmv_tpu_torch.config import hbm_peak_bytes_per_s
from ellspmv_tpu_torch.formats.csr import CsrMatrix
from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix
from ellspmv_tpu_torch.formats.hybrid import HybridMatrix
from ellspmv_tpu_torch.formats.sell import SellMatrix
from ellspmv_tpu_torch.formats.stream import StreamMatrix

# The chained protocol's carry scale: small enough that ||A||*scale < 1 for
# any realistic matrix, so y cannot overflow in long loops.
CHAINED_SCALE = 1e-6
# Iterations of the chained loop in one captured block. A block ends with
# one copy of y into its static buffer, 2*rows*sv bytes per block: 0.25
# bytes a row per iteration at 64, 0.3% of the fewest any suite row moves
# (config1's DIA: five diagonals, x, y in and out and the x <- 1e-6*y pass,
# 80 bytes a row in fp64; halved with the copy in f32).
CHAINED_BLOCK = 64


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
        if isinstance(matrix, CsrMatrix):
            sv = matrix.values.element_size()
            si = matrix.rowptr.element_size()
            n, m = matrix.num_rows, matrix.num_columns
            csrsize, diagsize = matrix.csrsize, matrix.diagsize
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * (csrsize + diagsize),
                min_bytes=(n * sv + m * sv + (n + 1) * si + csrsize * si
                           + csrsize * sv + diagsize * sv),
                max_bytes=(n * sv + csrsize * sv + n * si + csrsize * si
                           + csrsize * sv + diagsize * sv + diagsize * sv))
        if isinstance(matrix, (SellMatrix, HybridMatrix)):
            sv = matrix.values.element_size()
            n, m = matrix.num_rows, matrix.num_columns
            parts = ([matrix] if isinstance(matrix, SellMatrix) else
                     [p for p in (matrix.hub, matrix.rest) if p is not None])
            work = sum(p.sellsize + p.tailsize for p in parts)
            return SpmvMetrics(
                num_nonzeros=matrix.num_nonzeros,
                num_flops=2 * work,
                min_bytes=n * sv + m * sv + work * (4 + sv),
                max_bytes=n * sv + work * (4 + 2 * sv))
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
    # over ranks: each rank's kernel launches in the run, and (when asked)
    # each rank's local kernels alone, seconds per call, timed in turns
    rank_launches: list[dict] | None = None
    shard_seconds: list[float] | None = None

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


def _per_iter(spmv_fn, matrix, x, y, repeat, warmup, sync,
              before=lambda: None):
    """`before` runs ahead of each timed call, outside its time (a
    barrier, where ranks time together)."""
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
        before()
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


def _chained_start(matrix, x, y):
    """The chained loop's first x and y for a square `matrix`, in the
    values' type (an f32 kernel returns f32 y, which becomes the next x)."""
    if matrix.num_rows != matrix.num_columns:
        raise ValueError("chained protocol needs a square matrix "
                         "(x is re-derived from y each iteration)")
    dtype = (matrix.data if isinstance(matrix, DiaMatrix)
             else matrix.values).dtype
    return x.to(dtype), (torch.zeros(matrix.num_rows, dtype=dtype,
                                     device=x.device)
                         if y is None else y.to(dtype))


def _eager_loop(spmv_fn, matrix, x0, y0):
    """The chained loop as eager launches, one `spmv_fn` call and one scale
    per iteration: (start, run), where `start()` sets x to `x0` and
    `run(iters)` runs `iters` iterations from `y0`, returning y."""
    xk = torch.empty_like(x0)      # the loop writes x here: no allocation

    def run(iters):
        yk = y0
        for _ in range(iters):
            yk = spmv_fn(matrix, xk, yk)
            torch.mul(yk, CHAINED_SCALE, out=xk)   # the serial dependency
        return yk

    return (lambda: xk.copy_(x0)), run


@contextlib.contextmanager
def _block_loop(spmv_fn, matrix, x0, y0):
    """The chained loop in blocks: `iters` = q*CHAINED_BLOCK + r runs as q
    blocks of CHAINED_BLOCK iterations and r single ones, each ending with
    y copied into its static buffer. On a card each of the two is captured
    once in a CUDA graph and replayed, so that a timed loop holds only
    replays; on the CPU they run eagerly. Yields (start, run) as
    `_eager_loop` returns them (`run` returns the static y); frees the
    graphs on exit."""
    xk, yk = x0.clone(), y0.clone()

    def block(iters):
        def body():
            y = yk
            for _ in range(iters):
                y = spmv_fn(matrix, xk, y)
                torch.mul(y, CHAINED_SCALE, out=xk)
            yk.copy_(y)
        return body

    with contextlib.ExitStack() as graphs:
        if x0.device.type == "cuda":
            from ellspmv_tpu_torch.utils.graphs import Graph
            many, one = (graphs.enter_context(Graph(block(n), x0.device))
                         .replay for n in (CHAINED_BLOCK, 1))
        else:
            many, one = block(CHAINED_BLOCK), block(1)

        def start():
            xk.copy_(x0)
            yk.copy_(y0)

        def run(iters):
            for _ in range(iters // CHAINED_BLOCK):
                many()
            for _ in range(iters % CHAINED_BLOCK):
                one()
            return yk

        yield start, run


def _chained(loop, device, repeat, warmup, sync, agree=None):
    """The slope of two chained loop lengths of `loop` (`_eager_loop`'s or
    `_block_loop`'s (start, run)) on `device`, best of 3, with one rescale
    towards a 0.3 s span (at most 4096 iterations); returns the time per
    iteration, the y of the last long loop and its length. `agree` maps
    each measured loop time to the one every rank uses (their maximum), so
    that ranks take the same decisions."""
    agree = agree or (lambda t: t)
    start, run = loop

    def timed(iters):
        start()
        if device.type == "cuda":
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
            out = run(iters)
            end.record()
            sync()
            return agree(begin.elapsed_time(end) * 1e-3), out
        t0 = time.perf_counter()
        out = run(iters)
        return agree(time.perf_counter() - t0), out

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
    (`spmv_fn=None` uses the library dispatch, and under the chained
    protocol its traceable form) under `protocol`; `metrics` defaults to
    the matrix's own accounting. Under the chained protocol on a card
    `spmv_fn` is captured in CUDA graphs, so it must be capturable (the
    dispatch is, once `traceable_spmv` has made its first call)."""
    if metrics is None:
        metrics = SpmvMetrics.for_matrix(matrix)
    operand = matrix
    if spmv_fn is None and protocol == "chained":
        from ellspmv_tpu_torch.ops.dispatch import traceable_spmv
        operand, spmv_fn = traceable_spmv(matrix)
    elif spmv_fn is None:
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
        with _block_loop(spmv_fn, operand,
                         *_chained_start(matrix, x, y)) as loop:
            per_iter, yk, span = _chained(loop, x.device, repeat, warmup,
                                          sync)
        times = [per_iter] * repeat
    else:
        raise ValueError(f"unknown protocol {protocol!r}")
    return BenchResult(times, metrics, yk, device, protocol,
                       hbm_peak_bytes_per_s(x.device), span_iters=span,
                       actual_bytes=estimate_actual_bytes(matrix),
                       warning=warning)


# -- over ranks (``parallel/``) ---------------------------------------------

def shard_kernel_seconds(shard, x_full, backend: str = "auto",
                         calls: int = 10) -> float:
    """Seconds per call of a rank's local kernels alone (no allgather), on
    the gathered `x_full`. On a card: `calls` calls captured in one CUDA
    graph, replayed between CUDA events, best of 3, so that the host's
    launch path drops out; on the CPU: calls chained through y in loops of
    2 and 10, the slope, best of 2 (the JAX package's per-device
    micro-runs)."""
    from ellspmv_tpu_torch.parallel.spmv import local_spmv

    def once():
        return local_spmv(shard, x_full, None, backend)

    if x_full.device.type == "cuda":
        from ellspmv_tpu_torch.utils.graphs import Graph

        def body():
            for _ in range(calls):
                once()
        best = float("inf")
        with Graph(body, x_full.device) as graph:
            for _ in range(3):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                torch.cuda.synchronize(x_full.device)
                best = min(best, start.elapsed_time(end) * 1e-3 / calls)
        return best

    def loop(iters):
        t0 = time.perf_counter()
        y = None
        for _ in range(iters):
            y = local_spmv(shard, x_full, y, backend)
        return time.perf_counter() - t0

    loop(2)
    loop(10)
    return min(max((loop(10) - loop(2)) / 8, 1e-12) for _ in range(2))


def _rank_chained_loop(shard, x, y, backend: str, eager: bool):
    """In a rank: the chained loop over the ranks from (`x`, `y` or 0) on
    the shard's device, as a context manager that yields (start, run):
    `_block_loop`'s blocks through ``parallel/spmv.sharded_spmv_fn``
    (captured on NCCL ranks, eager on CPU ranks) where
    ``parallel.mesh.traceable_loops`` holds, else, or given `eager`,
    `_eager_loop` over ``sharded_spmv``."""
    from ellspmv_tpu_torch.parallel.mesh import traceable_loops
    from ellspmv_tpu_torch.parallel.spmv import sharded_spmv, sharded_spmv_fn

    dtype = shard.matrix.values.dtype
    x = x.to(dtype)
    y0 = (torch.zeros(shard.block, dtype=dtype, device=x.device)
          if y is None else y.to(dtype))
    if traceable_loops(x.device) and not eager:
        operand, fn = sharded_spmv_fn(shard, backend)
        return _block_loop(fn, operand, x, y0)
    return contextlib.nullcontext(_eager_loop(
        lambda _, xv, yv: sharded_spmv(shard, xv, yv, backend), shard, x,
        y0))


def shard_bench_task(rank, shard, x_block, y_block, repeat: int,
                     warmup: int, protocol: str, backend: str,
                     per_device: bool, trace_dir: str | None,
                     eager: bool = False) -> dict:
    """A task: the rank's part of `benchmark_sharded`. Every timed call
    includes the allgather of x. per_iter: each call bracketed by CUDA
    events (the host clock on the CPU) after a barrier; chained: the
    rank's y block becomes its x block, in `_rank_chained_loop` (`eager`
    launches every iteration eagerly on any rank). Every time is the
    maximum over the ranks, so all ranks take the same decisions and
    report the same times. With `per_device`, each rank then times its
    local kernels alone in turn, between barriers, so that ranks sharing a
    card do not overlap."""
    import torch.distributed as dist

    from ellspmv_tpu_torch.parallel.launch import kernel_launches
    from ellspmv_tpu_torch.parallel.spmv import (allgather, max_over_ranks,
                                                 placed, sharded_spmv)
    from ellspmv_tpu_torch.utils.trace import device_trace

    device = rank.device
    shard = placed(rank, shard)
    x = x_block.to(device)
    y = None if y_block is None else y_block.to(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def spmv_fn(_shard, xv, yv):
        return sharded_spmv(shard, xv, yv, backend)

    before = kernel_launches()
    span = warning = None
    with device_trace(trace_dir):
        if protocol == "per_iter":
            times, yk = _per_iter(spmv_fn, shard, x, y, repeat, warmup, sync,
                                  before=dist.barrier)
            times = max_over_ranks(times)
            warning = _dispatch_warning(min(times),
                                        dispatch_round_trip(device))
        else:
            with _rank_chained_loop(shard, x, y, backend, eager) as loop:
                per_iter, yk, span = _chained(
                    loop, device, repeat, warmup, sync,
                    agree=lambda t: max_over_ranks([t])[0])
            times = [per_iter] * repeat
    after = kernel_launches()
    seconds = None
    if per_device:
        x_full = allgather(x)
        for turn in range(rank.world):
            dist.barrier()
            if turn == rank.rank:
                seconds = shard_kernel_seconds(shard, x_full, backend)
        dist.barrier()
    return {"times": times, "y": yk.double().cpu().numpy(),
            "span": span, "warning": warning, "shard_seconds": seconds,
            "launches": {k: after[k] - before[k] for k in after}}


def chained_task(rank, shard, x_block, iters: int, backend: str = "auto",
                 eager: bool = False) -> dict:
    """A task: `iters` iterations of the chained recurrence from (x, 0),
    run once in `_rank_chained_loop`; this rank's y block (fp64 NumPy) and
    its kernels' launches, replays included."""
    from ellspmv_tpu_torch.parallel.launch import kernel_launches
    from ellspmv_tpu_torch.parallel.spmv import placed

    shard = placed(rank, shard)
    before = kernel_launches()
    with _rank_chained_loop(shard, x_block.to(rank.device), None, backend,
                            eager) as (start, run):
        start()
        y = run(iters).double().cpu().numpy()
    after = kernel_launches()
    return {"y": y, "launches": {k: after[k] - before[k] for k in after}}


def run_chained(pool, sm, x: torch.Tensor, iters: int,
                backend: str = "auto", eager: bool = False,
                launches: list | None = None) -> torch.Tensor:
    """`iters` iterations of the chained recurrence ``y <- A*x + y, x <-
    1e-6*y`` from (`x`, 0) over the pool's ranks (`chained_task`): the
    logical y on the host, in the values' type. Appends each rank's
    launches to `launches` when given."""
    if sm.num_rows != sm.num_columns:
        raise ValueError("chained protocol needs a square matrix "
                         "(x is re-derived from y each iteration)")
    outs = pool.run(chained_task, [(sm.shards[r], xb, iters, backend, eager)
                                   for r, xb in enumerate(sm.split_x(x))])
    if launches is not None:
        launches.extend(o["launches"] for o in outs)
    return sm.join_y([o["y"] for o in outs])


def benchmark_sharded(pool, sm, x: torch.Tensor,
                      y: torch.Tensor | None = None, repeat: int = 1,
                      warmup: int = 0, protocol: str = "per_iter",
                      backend: str = "auto", matrix=None,
                      metrics: SpmvMetrics | None = None,
                      per_device: bool = False,
                      trace_dir: str | None = None) -> BenchResult:
    """Benchmark the row-sharded `sm` (``parallel/``) over the ranks of
    `pool` under `protocol`, x and y logical on the host: `benchmark_spmv`'s
    result, with the metrics and bytes of `matrix` (the whole matrix, as
    the one-device program converts it; given `metrics` instead, the bytes
    are not counted) and y gathered back. `per_device` adds each rank's
    local kernels alone (`shard_seconds`); `trace_dir` makes each rank
    write its own trace there."""
    if protocol not in ("per_iter", "chained"):
        raise ValueError(f"unknown protocol {protocol!r}")
    if protocol == "chained" and sm.num_rows != sm.num_columns:
        raise ValueError("chained protocol needs a square matrix "
                         "(x is re-derived from y each iteration)")
    xs, ys = sm.split_x(x), sm.split_y(y)
    outs = pool.run(shard_bench_task,
                    [(sm.shards[r], xs[r], ys[r], repeat, warmup, protocol,
                      backend, per_device, trace_dir)
                     for r in range(sm.world)])
    device = torch.device(pool.devices[0])
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    first = outs[0]
    return BenchResult(
        first["times"], metrics or SpmvMetrics.for_matrix(matrix),
        sm.join_y([o["y"] for o in outs]), name, protocol,
        hbm_peak_bytes_per_s(device), span_iters=first["span"],
        actual_bytes=(None if matrix is None
                      else estimate_actual_bytes(matrix)),
        warning=first["warning"],
        rank_launches=[o["launches"] for o in outs],
        shard_seconds=([o["shard_seconds"] for o in outs] if per_device
                       else None))
