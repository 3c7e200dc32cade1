"""The yardstick of the roofline metrics: the least bytes a multiply has
to move, whatever the format, and the cards' peaks.

The counts take nothing from the program's layout. Values are random, so
no format stores fewer than the matrix's independent values
(``Matrix.distinct_values``: a symmetric matrix's pair once); each vector
is read or written once. So a roofline share on these counts reads the
same work whatever format the chooser picks, and no kernel can take it
over 100% without moving less than the matrix holds.
"""

from __future__ import annotations

#: Published HBM bandwidth, bytes/s, by the start of
#: ``torch.cuda.get_device_name()`` (NVIDIA's data sheets, at the full
#: power limit). A card not listed gets no roofline share.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # SXM5
    "NVIDIA H100 NVL": 3.9e12,
    "NVIDIA H100 PCIe": 2.0e12,
}


def peak_bytes_per_s(card: str) -> float | None:
    for name, peak in PEAK_BYTES_PER_S.items():
        if card.startswith(name):
            return peak
    return None


def chained_iteration_bytes(distinct_values: int, referenced_columns: int,
                            n: int, value_bytes: int) -> int:
    """One chained iteration, ``y := A·x + y`` then ``x <- 1e-6·y``: the
    values once, x's referenced entries read, y read and written, the
    next x written. (The scale's second read of y is left out: a kernel
    that writes x as it writes y does not make it.)"""
    return value_bytes * (distinct_values + referenced_columns + 3 * n)

