"""DIA SpMV: the wrapper of the hand-written CUDA kernel
(``csrc/dia_spmv.cu``) and its plain PyTorch version.

Counterpart of ``ellspmv_tpu.ops.dia_pallas.dia_spmv_pallas`` (and of the
XLA ``_dia_spmv`` in ``ellspmv_tpu.formats.dia``, which the plain version
follows). The wrapper takes the device from its tensors: on CUDA tensors it
launches the kernel or raises, and on CPU tensors it runs the plain version.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.ops import _build, ell_cuda

#: Kernel launches made by `dia_spmv` in this process.
launches = 0
#: The most diagonals the kernel takes (``dia_pallas.MAX_DIAGS``; the
#: offsets travel in the kernel's parameter block).
MAX_DIAGS = 64

_VALUE_TAGS = {torch.float64: "f64", torch.float32: "f32",
               torch.bfloat16: "bf16"}
_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 3 \
    + (ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p)


def dia_spmv_torch(dia: DiaMatrix, x: torch.Tensor,
                   y: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version, after ``_dia_spmv``: starting from y (or
    zeros), add each diagonal's values times the zero-padded shift of x, in
    the order of the offsets, accumulated in the values' type (float32 for
    bf16) and returned in the values' type."""
    n, m = dia.num_rows, dia.num_columns
    dtype = dia.data.dtype
    acc_dt = torch.float32 if dtype == torch.bfloat16 else dtype
    acc = (torch.zeros(n, dtype=acc_dt, device=x.device) if y is None
           else y.to(acc_dt, copy=True))
    xv = x.to(acc_dt)
    for k, off in enumerate(dia.offsets):
        # rows whose column i + off lies in [0, m); the rest add x's zero
        # padding
        lo, hi = max(0, -off), min(n, m - off)
        if hi > lo:
            acc[lo:hi] += dia.data[k, lo:hi].to(acc_dt) * xv[lo + off:hi + off]
    return acc.to(dtype)


def _check(dia: DiaMatrix, x: torch.Tensor, y: torch.Tensor | None):
    dtype = dia.data.dtype
    if dtype not in _VALUE_TAGS:
        raise TypeError(f"dia_spmv: unsupported value dtype {dtype}")
    if dia.num_diags > MAX_DIAGS:
        raise ValueError(f"dia_spmv: {dia.num_diags} diagonals; the kernel "
                         f"takes at most {MAX_DIAGS}")
    named = [("data", dia.data, (dia.num_diags, dia.num_rows), dtype),
             ("x", x, (dia.num_columns,), dtype)]
    if y is not None:
        named.append(("y", y, (dia.num_rows,), dtype))
    ell_cuda.check_tensors("dia_spmv", dia.data.device, named)


def dia_spmv(dia: DiaMatrix, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """y := A*x + y, a new vector of length ``dia.num_rows`` in the values'
    type. x, y and the matrix share one device and one value type."""
    global launches
    _check(dia, x, y)
    if x.device.type == "cpu":
        return dia_spmv_torch(dia, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmv: no kernel for tensors on {x.device}")
    # The fp64 path probes the card once, as the JAX fp64 DIA path does
    # (dia_pallas.py:285-286).
    if dia.data.dtype == torch.float64 \
            and not ell_cuda.fma_contraction_available(x.device):
        raise RuntimeError(
            f"dia_spmv: the fused multiply-add on {x.device} does not round "
            "once (fma_probe disagrees with the exact residual)")
    fn, error_string = _build.entry(f"dia_spmv_{_VALUE_TAGS[dia.data.dtype]}",
                                    _ARGS)
    out = torch.empty(dia.num_rows, dtype=dia.data.dtype, device=x.device)
    offsets = (ctypes.c_int64 * max(dia.num_diags, 1))(*dia.offsets)
    err = fn(dia.data.data_ptr(), x.data_ptr(),
             None if y is None else y.data_ptr(), out.data_ptr(),
             dia.num_rows, dia.num_columns, dia.num_diags, offsets,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dia_spmv kernel launch failed: "
                           f"{error_string(err).decode()} (error {err})")
    launches += 1
    return out
