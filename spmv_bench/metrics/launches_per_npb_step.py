"""launches_per_npb_step (count, device trace): kernels that started on
the card in the window over NPB's outer steps, counted on the card."""


def read(run):
    steps = getattr(run, "npb_steps", 0)
    if not (run.trace and steps):
        return None
    return run.trace.kernels / steps
