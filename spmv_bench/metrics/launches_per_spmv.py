"""launches_per_spmv (count, device trace): kernels that started on the
card in the window over the chained multiplies, the scale included."""


def read(run):
    if not (run.trace and run.iterations):
        return None
    return run.trace.kernels / run.iterations
