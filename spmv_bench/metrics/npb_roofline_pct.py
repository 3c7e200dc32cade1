"""npb_roofline_pct (%, device trace): the least bytes of the window's
NPB outer steps (``least_bytes_npb.step_bytes``: every multiply and
vector pass of a step), the steps counted on the card, at the card's
published peak, over the seconds the card was busy."""

from spmv_bench.least_bytes_npb import step_bytes


def read(run):
    steps = getattr(run, "npb_steps", 0)
    if not (run.trace and steps and run.peak_bytes_per_s):
        return None
    least = step_bytes(run.distinct_values, run.referenced_columns, run.n,
                       run.npb_iterations) * steps
    return 100.0 * least / run.peak_bytes_per_s / run.trace.busy_s
