"""spmv_gnz_s (Gnz/s, host clock): the matrix's nonzeros times the
chained multiplies completed in the window, over the window's seconds."""


def read(run):
    if not run.iterations:
        return None
    return run.nnz * run.iterations / run.window_s * 1e-9
