"""npb_capture_s (s, program span): one of NPB's outer steps captured in a
CUDA graph (``models/solvers.power_stepper``, its warm-up step and the
first-use builds in it included), from the span
``solvers.power_step.capture``."""


def read(run):
    spans = getattr(run, "npb_spans", None)
    if spans is None or not spans.find("solvers.power_step.capture"):
        return None
    return spans.total_s("solvers.power_step.capture")
