"""launches_per_pcg_iter (count, device trace): kernels that started on the
card in the window over the PCG iterations completed."""


def read(run):
    if not (run.trace and run.iterations):
        return None
    return run.trace.kernels / run.iterations
