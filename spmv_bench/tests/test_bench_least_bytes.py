"""The yardstick's arithmetic."""

from spmv_bench import least_bytes


def test_chained_iteration_bytes():
    # values 60, x read over 10 referenced columns, y read and written, x
    # written: 8 bytes each
    assert least_bytes.chained_iteration_bytes(60, 10, 12, 8) == \
        8 * (60 + 10 + 3 * 12)


def test_lynx68_scale():
    # 6,812,100 rows, 114.3M nonzeros symmetric: 60.56M distinct values
    n, distinct = 6_812_100, 60_558_801
    b = least_bytes.chained_iteration_bytes(distinct, n, n, 8)
    assert b == 8 * distinct + 32 * n
    assert abs(b / 3.35e12 - 0.2097e-3) < 1e-6


def test_peaks():
    assert least_bytes.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert least_bytes.peak_bytes_per_s("NVIDIA H100 PCIe") == 2.0e12
    assert least_bytes.peak_bytes_per_s("NVIDIA A100-SXM4-80GB") is None
