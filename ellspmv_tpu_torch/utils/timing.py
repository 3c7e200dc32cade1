"""Phase timing and the port's span recorder.

`PhaseTimer` is the counterpart of ``ellspmv_tpu.utils.timing``: the
reference's per-phase stderr timers (clock_gettime around
read/convert/spmv/write, ellspmv.c:1265-1268 etc.) as a reusable context
manager. Host clock: work on a card must be synchronised inside the phase
for its time to count.

`span(name, **attrs)` marks one step of the program's set-up, named
``<layer>.<step>``. A span is kept in two places:

- the set-up log. The spans named in `ENTRIES` (the chooser, the first
  call, HPCG's hierarchy, NPB's capture) always keep the tree of spans
  they hold, whether or not a recording is open; only the outermost entry
  open does, and an entry opened inside another is a span of its tree.
  When it closes, its tree (a `Recording` whose first span is the entry's)
  joins the process's log: `setup_log()` gives the last `LOG_TREES`,
  oldest first;
- the open `recording()`, which keeps every span opened while it is open.

Outside both an entry and a recording, `span` returns one shared object
that does nothing. A kept span keeps its parent (the span open around it),
its attributes, and the name of the exception that closed it, if any. No
attribute holds a tensor or an array: the log keeps its trees for the life
of the process. Its times are ``time.perf_counter_ns()`` shifted by an
anchor read when its recording opens, which puts them on the Unix-epoch
clock of ``torch.profiler``'s events. While a profiler is active, each
kept span also enters ``torch.profiler.record_function`` under its own
name, so that it shows in the device trace. Spans are for set-up: none is
opened per multiply or per graph replay. One thread records; a recording
is not shared between threads.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import sys
import time

#: The set-up entries: each keeps its tree in the log where no other entry
#: is open around it.
ENTRIES = frozenset({"formats.auto_from_coo", "dispatch.first_call",
                     "multigrid.build", "solvers.power_step.capture"})
#: How many trees the log keeps.
LOG_TREES = 16

#: The open `Recording`, or None.
_active = None
#: The tree of the outermost entry open, or None.
_tree = None
#: The set-up log, oldest first.
_log = collections.deque(maxlen=LOG_TREES)


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
    """The spans kept between the opening and the closing of
    `recording()`, or of a set-up entry (its tree, the entry's span
    first), in the order they opened."""

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
    """What `span` returns where no span is kept."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


NOTHING = _Nothing()


class _Open:
    """A span being kept: in the tree of the entry open, in the open
    recording, or in both, as a `Span` in each that shares `attrs`. An
    `entry` opens the tree."""
    __slots__ = ("name", "attrs", "entry", "kept", "profiled")

    def __init__(self, name: str, attrs: dict, entry: bool):
        self.name, self.attrs, self.entry = name, attrs, entry
        self.kept = []
        self.profiled = None

    def __enter__(self):
        global _tree
        import torch
        if torch._C._autograd._profiler_enabled():
            self.profiled = torch.profiler.record_function(self.name)
            self.profiled.__enter__()
        if self.entry:
            _tree = Recording()
        for rec in (_tree, _active):
            if rec is not None:
                s = Span(self.name, 0, None,
                         rec._open[-1] if rec._open else -1, self.attrs)
                rec._open.append(len(rec.spans))
                rec.spans.append(s)
                self.kept.append((rec, s))
        now = time.perf_counter_ns()
        for rec, s in self.kept:
            s.start_ns = now + rec.anchor_ns
        return self

    def __exit__(self, exc_type, exc, tb):
        global _tree
        now = time.perf_counter_ns()
        for rec, s in self.kept:
            s.end_ns = now + rec.anchor_ns
            if exc_type is not None:
                s.error = exc_type.__name__
            rec._open.pop()
        if self.entry:
            _log.append(self.kept[0][0])
            _tree = None
        if self.profiled is not None:
            self.profiled.__exit__(exc_type, exc, tb)
        return False

    def set(self, **attrs):
        """Add attributes known only once the step has run."""
        self.attrs.update(attrs)


def span(name: str, **attrs):
    """A context manager around one step named `name`, kept with `attrs`
    where spans are kept (the module's docstring), else `NOTHING`. Either
    has ``set(**attrs)``."""
    if _tree is None:
        if name in ENTRIES:
            return _Open(name, attrs, True)
        if _active is None:
            return NOTHING
    return _Open(name, attrs, False)


def open_spans() -> list[str] | None:
    """The names of the kept spans open, outermost first: the entry's
    tree's where one is open, else the open recording's; None where no span
    is kept."""
    rec = _active if _tree is None else _tree
    if rec is None:
        return None
    return [rec.spans[i].name for i in rec._open]


def setup_log() -> list[Recording]:
    """The trees of the last `LOG_TREES` set-up entries closed in this
    process, oldest first."""
    return list(_log)


@contextlib.contextmanager
def recording():
    """Record the spans of the block; yields the `Recording`. An inner
    recording takes the spans until it closes; an entry's tree keeps its
    own as well."""
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
