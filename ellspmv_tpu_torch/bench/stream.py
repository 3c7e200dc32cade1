"""Measured device-memory peak: a STREAM-style triad timed by loop-length
slope, the counterpart of ``ellspmv_tpu.bench.stream``.

The reference compares SpMV bandwidth against a quoted theoretical peak
(README:144-146). On a card the achievable rate can be measured:

- a chained triad ``out = b + 0.5*a`` (two reads and a write an
  iteration), the carry rotating through three float32 arrays of at least
  288 MB together, which the card's 50 MB L2 cannot hold;
- each loop length timed by CUDA events around the whole loop, the slope
  of two lengths per trial, the median of 5 trials;
- the JAX package's plausibility gate: a reading below 5% or above 120% of
  the card's data-sheet peak is reported as that peak instead, and said so.

The triad is a yardstick, not a port of a kernel: PyTorch's elementwise
ops compute it.
"""

from __future__ import annotations

import numpy as np
import torch


def measure_peak_bandwidth(size_mb: int = 288, iters: int = 64, log=None,
                           device="cuda") -> float:
    """Achievable device-memory bandwidth in bytes/s of the card `device`
    names, from a chained triad (out = b + 0.5*a: 2 reads + 1 write per
    iteration), measured as the median of 5 two-point loop-length slopes.
    Needs a card: the CPU has no device memory to measure."""
    from ellspmv_tpu_torch.config import hbm_peak_bytes_per_s

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("measure_peak_bandwidth: needs a CUDA device, got "
                         f"{device}")
    n = size_mb * 1024 * 1024 // 4 // 3       # 3 arrays in flight
    a = torch.from_numpy(np.random.RandomState(0).rand(n).astype(
        np.float32)).to(device)
    b = torch.from_numpy(np.random.RandomState(1).rand(n).astype(
        np.float32)).to(device)
    c = torch.empty_like(a)

    def triad(count):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        va, vb, free = a, b, c
        start.record()
        for _ in range(count):
            # out = b + 0.5*a, then (a, b) <- (out, a): the JAX carry
            torch.add(vb, va, alpha=0.5, out=free)
            va, vb, free = free, va, vb
        end.record()
        end.synchronize()
        return start.elapsed_time(end) * 1e-3

    lo, hi = max(2, iters // 16), iters
    triad(lo)
    triad(hi)
    slopes = []
    for _ in range(5):
        t_lo = triad(lo)
        t_hi = triad(hi)
        slopes.append((t_hi - t_lo) / (hi - lo))
    slopes.sort()
    per_iter = max(slopes[len(slopes) // 2], 1e-9)
    bw = 3 * n * 4 / per_iter

    nominal = hbm_peak_bytes_per_s(device)
    if nominal is None:
        return float(bw)
    # no card streams below 5% or above 120% of its data-sheet peak; a
    # reading outside that is a fault of the timing: report the data sheet
    if not (0.05 * nominal <= bw <= 1.2 * nominal):
        if log:
            log.write(f"measure_peak_bandwidth: {bw / 1e9:.0f} GB/s "
                      f"implausible vs nominal {nominal / 1e9:.0f} GB/s; "
                      "reporting nominal\n")
        return float(nominal)
    return float(bw)
