"""spmv_roofline_pct (%, device trace): the least bytes of the window's
chained iterations (``least_bytes.chained_iteration_bytes``) at the
card's published peak, over the seconds the card was busy."""

from spmv_bench.least_bytes import chained_iteration_bytes


def read(run):
    if not (run.trace and run.iterations and run.peak_bytes_per_s):
        return None
    least = chained_iteration_bytes(run.distinct_values,
                                    run.referenced_columns, run.n,
                                    run.value_bytes) * run.iterations
    return 100.0 * least / run.peak_bytes_per_s / run.trace.busy_s
