"""Device tracing, the counterpart of ``ellspmv_tpu.utils.trace`` (and of
the reference's PAPI region, papi_util.c:562-769).

PAPI counts cache refills and flops on the CPU; on a card the ground truth
is a profiler trace: each kernel's launches and device time. `device_trace`
wraps a region in ``torch.profiler`` (CUDA activity where a card is
present, host activity always) and writes a Chrome trace into the
directory, which ``chrome://tracing`` or Perfetto opens.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def device_trace(trace_dir: str | None):
    """Trace the region into ``trace_dir/trace_<pid>.pt.trace.json`` when
    `trace_dir` is set (``--trace=DIR``), creating the directory; a no-op
    otherwise."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(trace_dir, f"trace_{os.getpid()}.pt.trace.json"))
