"""symgs_roofline_pct (%, device trace): the least bytes of the window's
SymGS sweeps (``least_bytes_hpcg.sweep_bytes`` of each level) at the
card's published peak, over the seconds K8 ran on the card by its kernel
name. The sweeps are counted by K8's launch counter in the window, eight
launches a sweep, shared out over the levels as one V-cycle runs them."""

from spmv_bench.least_bytes_hpcg import sweep_bytes

KERNEL = "dia_symgs_kernel"


def read(run):
    launches = getattr(run, "symgs_launches", 0)
    if not (run.trace and launches and run.peak_bytes_per_s):
        return None
    seconds = sum(t for name, t in run.trace.device_ops if KERNEL in name)
    if not seconds:
        return None
    per_cycle = run.mg_sweeps
    cycles = launches / (8 * sum(per_cycle))
    least = cycles * sum(k * sweep_bytes(grid)
                         for k, grid in zip(per_cycle, run.mg_grids))
    return 100.0 * least / run.peak_bytes_per_s / seconds
