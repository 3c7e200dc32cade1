"""The trace reduction and each metric reader on a small synthetic trace."""

import json
import pathlib

import pytest

from spmv_bench import harness, least_bytes, tracing
from spmv_bench.tracing import Event

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
MS = 1_000_000


def _trace():
    """A 10 ms window: two kernels and a copy on the card, a 3 ms gap while
    the host sits in cudaFree, a 1 ms gap in cudaMalloc."""
    return [
        Event(tracing.WINDOW, 0, 10 * MS, False),
        Event("k1", 0, 2 * MS, True, True),
        Event("k2", 1 * MS, 3 * MS, True, True),      # overlaps k1
        Event("cudaFree", 3 * MS, 6 * MS, False),
        Event("Memcpy DtoD", 6 * MS, 7 * MS, True, False),
        Event("cudaMalloc", 7 * MS, 8 * MS, False),
        Event("k1", 8 * MS, 10 * MS, True, True),
        Event("k1", 11 * MS, 12 * MS, True, True),    # after the window
    ]


def test_reduce():
    s = tracing.reduce(_trace())
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s == pytest.approx(0.006)             # 0-3, 6-7, 8-10
    assert s.kernels == 3
    assert s.device_ops[0] == ["k1", pytest.approx(0.004)]
    assert dict(map(tuple, s.idle_gaps)) == {
        "cudaFree": pytest.approx(0.003), "cudaMalloc": pytest.approx(0.001)}


def test_reduce_finds_nothing_without_window_or_device():
    assert tracing.reduce(_trace()[1:]) is None
    assert tracing.reduce([e for e in _trace() if not e.on_device]) is None


def _run(trace=True):
    run = harness.Run("w", "NVIDIA H100 80GB HBM3", n=1000, nnz=10000,
                      distinct_values=6000, referenced_columns=900,
                      value_bytes=8, peak_bytes_per_s=3.35e12, setup_s=5.0,
                      convert_s=2.0, window_s=0.5, iterations=100)
    run.trace = tracing.reduce(_trace()) if trace else None
    return run


def test_every_metric_has_a_reader():
    for group in ("end_to_end", "per_layer"):
        for metric in BENCH[group]:
            assert callable(harness.reader(metric["name"]))


def test_chained_readers():
    run = _run()
    read = {m: harness.reader(m)(run) for m in (
        "spmv_gnz_s", "setup_s", "convert_s", "spmv_roofline_pct",
        "launches_per_spmv", "device_idle_pct.spmv")}
    assert read["spmv_gnz_s"] == pytest.approx(10000 * 100 / 0.5 * 1e-9)
    assert read["setup_s"] == 5.0 and read["convert_s"] == 2.0
    least = least_bytes.chained_iteration_bytes(6000, 900, 1000, 8) * 100
    assert read["spmv_roofline_pct"] == pytest.approx(
        100 * least / 3.35e12 / 0.006)
    assert read["launches_per_spmv"] == pytest.approx(0.03)
    assert read["device_idle_pct.spmv"] == pytest.approx(40.0)


def test_readers_find_nothing_without_multiplies():
    run = _run()
    run.iterations = 0
    for m in ("spmv_gnz_s", "spmv_roofline_pct", "launches_per_spmv",
              "device_idle_pct.spmv"):
        assert harness.reader(m)(run) is None, m


def test_device_readers_need_a_trace_and_a_peak():
    run = _run(trace=False)
    for m in ("spmv_roofline_pct", "launches_per_spmv",
              "device_idle_pct.spmv"):
        assert harness.reader(m)(run) is None
    run = _run()
    run.peak_bytes_per_s = None          # a card with no published peak
    assert harness.reader("spmv_roofline_pct")(run) is None
