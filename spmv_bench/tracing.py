"""The device trace of a window and its reduction.

`record` wraps the window in ``torch.profiler`` (host and CUDA activity)
and hands back the trace's events as plain tuples; `reduce` turns them
into what the metrics read: the seconds in which an operation ran on the
card (the union of kernels, copies and sets), the traced window's length
(the host span named `WINDOW`), the kernels launched, the device
operations that took most time, and the idle gaps on the card labelled by
what the host was doing: the innermost host event around each gap.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

#: The host span around the measured window.
WINDOW = "spmv_bench.window"
#: Gaps labelled one by one; the rest are summed under SMALL_GAPS.
LABELLED_GAPS = 2000
SMALL_GAPS = "(shorter gaps)"


@dataclasses.dataclass
class Event:
    name: str
    start_ns: int
    end_ns: int
    on_device: bool
    kernel: bool = False   # a kernel, not a copy or a set


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernels: int
    device_ops: list      # [[name, seconds]], most time first, at most 10
    idle_gaps: list       # [[host activity, seconds]], at most 10


def _from_kineto(prof) -> list[Event]:
    """The profiler's events: those on the card (kernels, copies, sets;
    not the host's spans drawn again on the card's line) and the host's."""
    events = []
    for e in prof.profiler.kineto_results.events():
        on_device = not str(e.device_type()).endswith("CPU")
        name = e.name()
        if on_device and (e.is_user_annotation() or name.endswith("Sync")):
            continue
        start = e.start_ns()
        events.append(Event(name, start, start + e.duration_ns(), on_device,
                            on_device and not name.startswith(("Memcpy",
                                                               "Memset"))))
    return events


@contextlib.contextmanager
def record(enabled: bool):
    """Trace the block when `enabled`; yields a list that holds the
    events once the block has ended (empty when not enabled)."""
    events: list[Event] = []
    if not enabled:
        yield events
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(WINDOW):
            yield events
    events.extend(_from_kineto(prof))


def _union(starts: np.ndarray, ends: np.ndarray):
    """Merged intervals of (starts, ends), sorted."""
    if starts.size == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.empty(s.size, bool)
    new[0] = True
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, s.size - 1]
    return s[first], reach[last]


def reduce(events: list[Event]) -> TraceSummary | None:
    """The summary of the window's trace, or None where it holds no
    window or no device operation."""
    spans = [e for e in events if not e.on_device and e.name == WINDOW]
    if not spans:
        return None
    w0, w1 = spans[0].start_ns, spans[0].end_ns
    dev = [e for e in events if e.on_device and e.end_ns > w0
           and e.start_ns < w1]
    if not dev:
        return None
    starts = np.clip([e.start_ns for e in dev], w0, w1).astype(np.int64)
    ends = np.clip([e.end_ns for e in dev], w0, w1).astype(np.int64)
    us, ue = _union(starts, ends)
    busy = int((ue - us).sum())

    by_name: dict[str, int] = {}
    for e, s, t in zip(dev, starts, ends):
        by_name[e.name] = by_name.get(e.name, 0) + int(t - s)
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]

    # idle gaps: before the first operation, between the merged busy
    # intervals, after the last
    gs = np.r_[w0, ue]
    ge = np.r_[us, w1]
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    host = [e for e in events if not e.on_device and e.name != WINDOW]
    hs = np.array([e.start_ns for e in host], np.int64)
    he = np.array([e.end_ns for e in host], np.int64)
    hd = he - hs
    idle: dict[str, int] = {}
    order = np.argsort(gs - ge)        # longest first
    for k in order[:LABELLED_GAPS]:
        mid = (gs[k] + ge[k]) // 2
        inside = np.flatnonzero((hs <= mid) & (he >= mid)) if host else []
        label = (host[inside[np.argmin(hd[inside])]].name
                 if len(inside) else "(no host event)")
        idle[label] = idle.get(label, 0) + int(ge[k] - gs[k])
    rest = int((ge - gs)[order[LABELLED_GAPS:]].sum())
    if rest:
        idle[SMALL_GAPS] = idle.get(SMALL_GAPS, 0) + rest
    idle_gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return TraceSummary(
        busy_s=busy * 1e-9, window_s=(w1 - w0) * 1e-9,
        kernels=sum(1 for e in dev if e.kernel and e.start_ns >= w0),
        device_ops=[[n, t * 1e-9] for n, t in device_ops],
        idle_gaps=[[n, t * 1e-9] for n, t in idle_gaps])
