"""mg_setup_s (s, program span): HPCG's hierarchy built through the port,
``models/multigrid.build`` (each coarse level generated, chosen and
converted, and each level's first SpMV), from the span
``multigrid.build`` that the driver records around it."""


def read(run):
    spans = getattr(run, "mg_spans", None)
    if spans is None or not spans.find("multigrid.build"):
        return None
    return spans.total_s("multigrid.build")
