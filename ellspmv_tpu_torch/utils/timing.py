"""Phase timing, the counterpart of ``ellspmv_tpu.utils.timing``: the
reference's per-phase stderr timers (clock_gettime around
read/convert/spmv/write, ellspmv.c:1265-1268 etc.) as a reusable context
manager. Host clock: work on a card must be synchronised inside the phase
for its time to count."""

from __future__ import annotations

import sys
import time


class PhaseTimer:
    """Collects named phase durations; optionally logs on exit.

    >>> t = PhaseTimer(verbose=True)
    >>> with t.phase("mtxfile_read"):
    ...     ...
    >>> t.times["mtxfile_read"]
    """

    def __init__(self, verbose: bool = False, stream=None):
        self.verbose = verbose
        self.stream = stream or sys.stderr
        self.times: dict[str, float] = {}

    def phase(self, name: str, extra: str = ""):
        timer = self

        class _Ctx:
            def __enter__(self):
                self.t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                dt = time.perf_counter() - self.t0
                timer.times[name] = timer.times.get(name, 0.0) + dt
                if timer.verbose and exc[0] is None:
                    suffix = f", {extra}" if extra else ""
                    timer.stream.write(f"{name}: {dt:.6f} seconds{suffix}\n")
                return False

        return _Ctx()


def time_ms(fn, iters: int = 20) -> float:
    """Milliseconds per call of `fn` on the current card: three calls to
    warm up, then `iters` calls between CUDA events (the host's launch path
    included where it outlasts the device)."""
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


def graph_ms(fn, iters: int = 20) -> float:
    """Device time per call of `fn`, with the host's launch path taken out:
    `iters` calls captured in one CUDA graph (``utils/graphs.py``), replayed
    between CUDA events."""
    import torch

    from ellspmv_tpu_torch.utils.graphs import Graph

    def body():
        for _ in range(iters):
            fn()
    with Graph(body, torch.cuda.current_device()) as graph:
        return time_ms(graph.replay, 5) / iters
