"""k1_roofline_pct (%, device trace): the least bytes of K1's part of the
window's chained multiplies (`k1_multiply_bytes`) at the card's published
peak, over the seconds K1 ran on the card by its kernel name. Nothing to
read where no K1 launch is in the trace (a matrix the chooser sends to
another format)."""

KERNEL = "ell_spmv_kernel"


def k1_multiply_bytes(distinct_values: int, referenced_columns: int, n: int,
                      value_bytes: int) -> int:
    """The least bytes of K1's part of a chained multiply, ``y := A·x + y``,
    whatever the layout K1 reads: as ``least_bytes.chained_iteration_bytes``
    counts them, less the scale's write of the next x, which K1 does not
    make. The matrix's independent values once (a symmetric pair once),
    x's referenced entries read once, y read and written once. ELLPACK's
    padding, its column indices and each symmetric pair stored twice are
    what K1 moves above this floor."""
    return value_bytes * (distinct_values + referenced_columns + 2 * n)


def read(run):
    if not (run.trace and run.iterations and run.peak_bytes_per_s):
        return None
    seconds = sum(t for name, t in run.trace.device_ops if KERNEL in name)
    if not seconds:
        return None
    least = k1_multiply_bytes(run.distinct_values, run.referenced_columns,
                              run.n, run.value_bytes) * run.iterations
    return 100.0 * least / run.peak_bytes_per_s / seconds
