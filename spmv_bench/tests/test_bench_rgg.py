"""The random geometric graph (``generators/rgg.py``) against the DIMACS10
definition evaluated pair by pair in NumPy, on the CPU at small sizes; and
``k1_roofline_pct`` on a made-up trace.

``test_bench_correct.py`` runs every cell at the small size that its
table ``SMALL``, or ``spmv_bench/conftest.py``'s ``LATER_CELLS``, gives
its configuration. ``rgg_n_2_24`` came later than both, so this module
adds its size to ``LATER_CELLS`` as it is collected: 2^12 points, about
32,000 nonzeros, which the chooser sends to ELLPACK as at 2^24. So the
self-check runs as one directory, ``python -m pytest spmv_bench/tests``:
``test_bench_correct.py`` alone lacks this cell's size."""

import math

import numpy as np
import pytest
import torch

from spmv_bench import conftest, harness
from spmv_bench.generators import rgg
from spmv_bench.metrics.k1_roofline_pct import k1_multiply_bytes

SMALL = {"scale": 12, "radius_factor": 0.55}
conftest.LATER_CELLS.setdefault("rgg_n_2_24", SMALL)


def _params(scale):
    return {"scale": scale, "radius_factor": 0.55}


def _brute_force(xy: np.ndarray, r: float):
    """(i, j) of every pair i != j closer than r, in row-major order."""
    d = ((xy[:, None, 0] - xy[None, :, 0]) ** 2
         + (xy[:, None, 1] - xy[None, :, 1]) ** 2)
    adj = d < r * r
    np.fill_diagonal(adj, False)
    return np.nonzero(adj)


@pytest.mark.parametrize("scale", [10, 11, 12])
def test_edges_are_the_definitions(scale):
    params = _params(scale)
    m = rgg.generate(params, 2**40 + 3, "cpu")
    xy, _, _, r = rgg.numbered_points(params, "cpu")
    assert r == 0.55 * math.sqrt(math.log(2**scale) / 2**scale)
    i, j = _brute_force(xy.numpy(), r)
    assert m.num_rows == 2**scale
    assert np.array_equal(m.rows.numpy(), i)
    assert np.array_equal(m.cols.numpy(), j)


def test_symmetric_one_weight_a_pair_no_self_loops():
    m = rgg.generate(_params(12), 11, "cpu")
    n = m.num_rows
    key = m.rows * n + m.cols
    assert bool((key[1:] > key[:-1]).all())            # sorted, no duplicates
    assert not bool((m.rows == m.cols).any())
    a = torch.zeros(n, n, dtype=torch.float64)
    a[m.rows, m.cols] = m.values
    assert torch.equal(a, a.T)
    assert float(m.values.min()) >= 0 and float(m.values.max()) < 1
    assert m.distinct_values * 2 == m.num_nonzeros
    upper = m.rows < m.cols
    assert torch.unique(m.values[upper]).numel() == m.distinct_values
    deg = torch.bincount(m.rows, minlength=n)
    assert m.referenced_columns == int((deg > 0).sum())
    assert m.referenced_columns == int(
        (torch.bincount(m.cols, minlength=n) > 0).sum())


def test_vertices_are_numbered_by_cell():
    params = _params(12)
    drawn = rgg.drawn_points(params)
    xy, cell, k, r = rgg.numbered_points(params, "cpu")
    assert k == int(1 / r) and 1 / k >= r
    want, _ = rgg.cells(drawn, r)
    order = np.argsort(want.numpy(), kind="stable")
    assert torch.equal(xy, drawn[order])
    assert torch.equal(cell, want[order])
    assert bool((cell[1:] >= cell[:-1]).all())
    assert torch.equal(cell, (xy[:, 1] * k).long() * k
                       + (xy[:, 0] * k).long())
    # every edge joins cells at most one apart, each way
    m = rgg.generate(params, 1, "cpu")
    ci, cj = cell[m.rows], cell[m.cols]
    assert int((ci % k - cj % k).abs().max()) <= 1
    assert int((ci // k - cj // k).abs().max()) <= 1


def test_the_seed_draws_the_weights_on_one_point_set():
    a = rgg.generate(_params(10), 5, "cpu")
    b = rgg.generate(_params(10), 5, "cpu")
    c = rgg.generate(_params(10), 6, "cpu")
    assert torch.equal(a.cols, b.cols) and torch.equal(a.values, b.values)
    assert torch.equal(a.rows, c.rows) and torch.equal(a.cols, c.cols)
    assert not torch.equal(a.values, c.values)


def test_nonzeros_at_2_16_are_the_expectation():
    """n(n - 1) times the chance that two uniform points of the unit square
    lie closer than r: πr² less the boundary's loss, 8r³/3 - r⁴/2."""
    n = 2**16
    m = rgg.generate(_params(16), 3, "cpu")
    r = rgg.radius(n, 0.55)
    want = n * (n - 1) * (math.pi * r * r - 8 * r**3 / 3 + r**4 / 2)
    assert abs(m.num_nonzeros - want) < 0.02 * want
    deg = torch.bincount(m.rows, minlength=n).double()
    assert abs(float(deg.mean()) - want / n) < 0.02 * want / n


def test_k1_roofline_reads_the_kernel_by_name():
    from spmv_bench import tracing
    from spmv_bench.tracing import Event
    ms = 1_000_000
    events = [Event(tracing.WINDOW, 0, 10 * ms, False),
              Event("void ell_spmv_kernel<double, int, unsigned short>",
                    0, 6 * ms, True, True),
              Event("elementwise_kernel (the scale)", 6 * ms, 7 * ms,
                    True, True),
              Event("void ell_spmv_kernel<double, int, unsigned short>",
                    7 * ms, 9 * ms, True, True)]
    run = harness.Run("rgg_n_2_24.spmv", "NVIDIA H100 80GB HBM3", n=1000,
                      nnz=16000, distinct_values=8000,
                      referenced_columns=990, value_bytes=8,
                      peak_bytes_per_s=3.35e12, window_s=0.01,
                      iterations=100)
    run.trace = tracing.reduce(events)
    read = harness.reader("k1_roofline_pct")
    least = 8 * (8000 + 990 + 2 * 1000) * 100
    assert k1_multiply_bytes(8000, 990, 1000, 8) * 100 == least
    assert read(run) == pytest.approx(100 * least / 3.35e12 / 0.008)
    # no K1 in the trace (another format), no trace, no peak: nothing
    run.trace = tracing.reduce(events[:1] + events[2:3])
    assert read(run) is None
    run.trace = None
    assert read(run) is None
    run.trace = tracing.reduce(events)
    run.peak_bytes_per_s = None
    assert read(run) is None
