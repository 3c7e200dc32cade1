"""Phase timing and the port's span recorder.

`PhaseTimer` is the counterpart of ``ellspmv_tpu.utils.timing``: the
reference's per-phase stderr timers (clock_gettime around
read/convert/spmv/write, ellspmv.c:1265-1268 etc.) as a reusable context
manager. Host clock: work on a card must be synchronised inside the phase
for its time to count.

`span(name, **attrs)` marks one step of the program's set-up, named
``<layer>.<step>``. Spans are kept only inside `recording()`; elsewhere
`span` returns one shared object that does nothing, after a single read of
a module global. A recorded span keeps its parent (the span open around
it), its attributes, and the name of the exception that closed it, if
any. Its times are ``time.perf_counter_ns()`` shifted by an anchor read
when the recording opens, which puts them on the Unix-epoch clock of
``torch.profiler``'s events. While a profiler is active, each recorded span
also enters ``torch.profiler.record_function`` under its own name, so that
it shows in the device trace. Spans are for set-up: none is opened per
multiply. One thread records; a recording is not shared between threads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

#: The open `Recording`, or None: the one global `span` reads.
_active = None


@dataclasses.dataclass(slots=True)
class Span:
    """One recorded span: `parent` is the index in `Recording.spans` of the
    span open around it (-1 for none), `end_ns` is None while it is open,
    `error` the name of the exception that closed it."""
    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    attrs: dict
    error: str | None = None

    @property
    def seconds(self) -> float:
        if self.end_ns is None:
            return 0.0
        return (self.end_ns - self.start_ns) * 1e-9


class Recording:
    """The spans recorded between the opening and the closing of
    `recording()`, in the order they opened."""

    def __init__(self):
        self.anchor_ns = time.time_ns() - time.perf_counter_ns()
        self.spans: list[Span] = []
        self._open: list[int] = []

    def find(self, name: str) -> list[Span]:
        return [s for s in self.spans if s.name == name]

    def children(self, index: int) -> list[Span]:
        return [s for s in self.spans if s.parent == index]

    def within(self, index: int, prefix: str) -> bool:
        """Whether a span around span `index` has a name that starts with
        `prefix`."""
        parent = self.spans[index].parent
        while parent >= 0:
            if self.spans[parent].name.startswith(prefix):
                return True
            parent = self.spans[parent].parent
        return False

    def total_s(self, prefix: str) -> float:
        """Seconds in spans whose name starts with `prefix`; a span inside
        another such span counts within the outer one only."""
        return sum((s.seconds for i, s in enumerate(self.spans)
                    if s.name.startswith(prefix)
                    and not self.within(i, prefix)), 0.0)

    def self_s(self, name: str) -> float:
        """Seconds in spans named `name`, less those of their children."""
        return sum((s.seconds - sum(c.seconds for c in self.children(i))
                    for i, s in enumerate(self.spans) if s.name == name), 0.0)


class _Nothing:
    """What `span` returns outside a recording."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NOTHING = _Nothing()


class _Open:
    """A span being recorded."""
    __slots__ = ("recording", "span", "profiled")

    def __init__(self, recording: Recording, name: str, attrs: dict):
        self.recording = recording
        self.span = Span(name, 0, None, -1, attrs)
        self.profiled = None

    def __enter__(self):
        import torch
        rec, s = self.recording, self.span
        if torch._C._autograd._profiler_enabled():
            self.profiled = torch.profiler.record_function(s.name)
            self.profiled.__enter__()
        s.parent = rec._open[-1] if rec._open else -1
        rec._open.append(len(rec.spans))
        rec.spans.append(s)
        s.start_ns = time.perf_counter_ns() + rec.anchor_ns
        return self

    def __exit__(self, exc_type, exc, tb):
        rec, s = self.recording, self.span
        s.end_ns = time.perf_counter_ns() + rec.anchor_ns
        if exc_type is not None:
            s.error = exc_type.__name__
        rec._open.pop()
        if self.profiled is not None:
            self.profiled.__exit__(exc_type, exc, tb)
        return False

    def set(self, **attrs):
        """Add attributes known only once the step has run."""
        self.span.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one step named `name`, kept with `attrs` in
    the open recording; `NOTHING` where none is open. Either has
    ``set(**attrs)``."""
    rec = _active
    if rec is None:
        return NOTHING
    return _Open(rec, name, attrs)


def open_spans() -> list[str] | None:
    """The names of the spans open in the open recording, outermost first;
    None where no recording is open."""
    rec = _active
    if rec is None:
        return None
    return [rec.spans[i].name for i in rec._open]


@contextlib.contextmanager
def recording():
    """Record the spans of the block; yields the `Recording`. An inner
    recording takes the spans until it closes."""
    global _active
    outer, rec = _active, Recording()
    _active = rec
    try:
        yield rec
    finally:
        _active = outer


class PhaseTimer:
    """Collects named phase durations; optionally logs on exit. Each phase
    is also a span of its name.

    >>> t = PhaseTimer(verbose=True)
    >>> with t.phase("mtxfile_read"):
    ...     ...
    >>> t.times["mtxfile_read"]
    """

    def __init__(self, verbose: bool = False, stream=None):
        self.verbose = verbose
        self.stream = stream or sys.stderr
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, extra: str = ""):
        t0 = time.perf_counter()
        done = False
        try:
            with span(name):
                yield
            done = True
        finally:
            dt = time.perf_counter() - t0
            self.times[name] = self.times.get(name, 0.0) + dt
            if self.verbose and done:
                suffix = f", {extra}" if extra else ""
                self.stream.write(f"{name}: {dt:.6f} seconds{suffix}\n")


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
