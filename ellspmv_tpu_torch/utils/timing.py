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
