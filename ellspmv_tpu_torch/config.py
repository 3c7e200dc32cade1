"""Index-width selection and value types.

The reference selects its index type at compile time via ``IDXTYPEWIDTH``
(ellspmv.c:112-130). Here, as in ``ellspmv_tpu.config``, it is a run-time
choice: int32 by default, int64 when the matrix dimensions or nonzero count
demand it or when asked for.
"""

from __future__ import annotations

import numpy as np
import torch

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
