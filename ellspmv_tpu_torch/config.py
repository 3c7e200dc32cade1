"""Index-width selection, value types and the cards' memory peaks.

The reference selects its index type at compile time via ``IDXTYPEWIDTH``
(ellspmv.c:112-130). Here, as in ``ellspmv_tpu.config``, it is a run-time
choice: int32 by default, int64 when the matrix dimensions or nonzero count
demand it or when asked for.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ellspmv_tpu_torch.utils import calibration

# Largest value an int32 index may take (the reference's IDX_T_MAX,
# ellspmv.c:123).
_INT32_MAX = np.iinfo(np.int32).max

# --precision names and the torch types that store them.
VALUE_DTYPES = {
    "float64": torch.float64,
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def default_index_dtype() -> np.dtype:
    """Default index dtype (the reference's plain ``int``, ellspmv.c:126-130:
    32-bit on every platform it targets)."""
    return np.dtype(np.int32)


def select_index_dtype(num_rows: int, num_columns: int, num_nonzeros: int,
                       requested: str | np.dtype | None = None) -> np.dtype:
    """Pick an index dtype, honouring an explicit request.

    Promotes to int64 when a dimension or the nonzero count exceeds the int32
    range: the run-time analogue of rebuilding the reference with
    ``IDXTYPEWIDTH=64`` (README:25-30).
    """
    if requested is not None:
        dt = np.dtype(requested)
        if dt not in (np.dtype(np.int32), np.dtype(np.int64)):
            raise ValueError(f"index dtype must be int32 or int64, got {dt}")
        if dt == np.dtype(np.int32):
            if max(num_rows, num_columns, num_nonzeros) > _INT32_MAX:
                raise OverflowError(
                    "matrix too large for int32 indices; use int64 "
                    "(the reference would likewise fail unless rebuilt with "
                    "IDXTYPEWIDTH=64)")
        return dt
    if max(num_rows, num_columns, num_nonzeros) > _INT32_MAX:
        return np.dtype(np.int64)
    return default_index_dtype()


# Device-memory peak bandwidth in bytes/s of each card, keyed by
# torch.cuda.get_device_name, the denominator of the roofline shares in
# bench/ (the counterpart of ellspmv_tpu.config.HBM_PEAK_BYTES_PER_S).
# Vendor data-sheet peaks, not measured rates.
HBM_PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,   # H100 SXM5
    "NVIDIA H100 PCIe": 2.0e12,         # H100 PCIe, 80 GB HBM2e
    "NVIDIA H100 NVL": 3.9e12,          # H100 NVL, 94 GB HBM3
}


# Streaming multiprocessors of each card (its data sheet; on a card the
# device's own properties are read instead).
SM_COUNT = {
    "NVIDIA H100 80GB HBM3": 132,
    "NVIDIA H100 PCIe": 114,
    "NVIDIA H100 NVL": 132,
}

# One round of K1 (csrc/ell_spmv.cu): a thread's batch of four slots' loads,
# then their gathers of x, which a launch with fewer blocks than SMs cannot
# hide behind other blocks. Measured by bench/calibrate.probe_k1_geometry,
# the slope of K1's time over its rounds on short launches (4 to 96 blocks,
# widths 4 to 128, fp64, random columns over 1M) in a CUDA graph: NVIDIA
# H100 80GB HBM3 at a 700 W power limit (f32 read 1.49 us there). A card's
# calibration (bench/calibrate.py) takes precedence on that card.
K1_ROUND_SECONDS = {
    "NVIDIA H100 80GB HBM3": 1.67e-6,
}

# The card the chooser prices for where it runs without one (tests, and
# --device=cpu): the card the port is built and measured on.
HOST_PRICED_CARD = "NVIDIA H100 80GB HBM3"


def card_name(device="cuda") -> str:
    """The card `device` names, or `HOST_PRICED_CARD` off a card."""
    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return HOST_PRICED_CARD


def k1_geometry(device="cuda", dtype=torch.float64) -> tuple[float, int]:
    """(K1's round latency in seconds, SMs) of the card `device` names, or
    of `HOST_PRICED_CARD` off a card: what the chooser prices K1's short
    launches by (``bench/traffic.k1_launch_seconds``). The latency is an
    injected one, else on a card its calibrated one (``bench/calibrate.py``),
    each for `dtype` (float32's for float32, float64's otherwise), else
    `K1_ROUND_SECONDS`'s, else the host-priced card's."""
    device = torch.device(device)
    name = card_name(device)
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
    else:
        sms = SM_COUNT[name]
    key = "float32" if dtype == torch.float32 else "float64"
    measured = calibration.get(calibration.K1_ROUND[key], name,
                               cached=device.type == "cuda")
    if measured is None:
        measured = K1_ROUND_SECONDS.get(name,
                                        K1_ROUND_SECONDS[HOST_PRICED_CARD])
    return measured, sms


def pricing_rate(device="cuda") -> float:
    """The device-memory rate the chooser prices by: `hbm_peak_bytes_per_s`
    of `device`, or off a card the data-sheet peak of `HOST_PRICED_CARD`
    (``HBM_PEAK_GBPS`` overrides both); for a card not in
    `HBM_PEAK_BYTES_PER_S`, an injected rate, else its calibrated one
    (``bench/calibrate.py``), else the host-priced card's data sheet."""
    rate = hbm_peak_bytes_per_s(device)
    if rate is None:
        device = torch.device(device)
        name = card_name(device)
        rate = HBM_PEAK_BYTES_PER_S.get(name)
        if rate is None:
            rate = calibration.get(calibration.RATE, name,
                                   cached=device.type == "cuda")
        if rate is None:
            rate = HBM_PEAK_BYTES_PER_S[HOST_PRICED_CARD]
    return rate


def hbm_peak_bytes_per_s(device="cuda") -> float | None:
    """The data-sheet device-memory peak of the card `device` names, or
    None for a card not in the table and for the CPU, which has no device
    memory. The ``HBM_PEAK_GBPS`` environment variable overrides it, so a
    roofline can be pinned on any hardware."""
    env = os.environ.get("HBM_PEAK_GBPS")
    if env:
        return float(env) * 1e9
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return HBM_PEAK_BYTES_PER_S.get(torch.cuda.get_device_name(device))


def value_dtype(name: str | torch.dtype) -> torch.dtype:
    """The torch type for a ``--precision`` name (or a torch type as is)."""
    if isinstance(name, torch.dtype):
        if name not in VALUE_DTYPES.values():
            raise ValueError(f"unsupported value dtype {name}")
        return name
    key = name if isinstance(name, str) else np.dtype(name).name
    if key not in VALUE_DTYPES:
        raise ValueError(f"unsupported value dtype {name!r}")
    return VALUE_DTYPES[key]
