"""pcg_roofline_pct (%, device trace): the least bytes of the window's PCG
iterations (``least_bytes_hpcg.pcg_iteration_bytes``: every matrix and
vector pass of an iteration, V-cycle included) at the card's published
peak, over the seconds the card was busy."""

from spmv_bench.least_bytes_hpcg import pcg_iteration_bytes


def read(run):
    grids = getattr(run, "mg_grids", None)
    if not (run.trace and run.iterations and run.peak_bytes_per_s and grids):
        return None
    least = pcg_iteration_bytes(grids) * run.iterations
    return 100.0 * least / run.peak_bytes_per_s / run.trace.busy_s
