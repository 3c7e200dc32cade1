"""device_idle_pct.spmv (%, device trace): the share of the chained
window in which no kernel, copy or set ran on the card."""


def read(run):
    if not (run.trace and run.iterations):
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
