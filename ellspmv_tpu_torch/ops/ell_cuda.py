"""ELLPACK SpMV: the wrappers of the hand-written CUDA kernels
(``csrc/ell_spmv.cu``, ``csrc/fma_probe.cu``) and their plain PyTorch
versions.

Counterpart of ``ellspmv_tpu.ops.ell_pallas.ell_spmv_pallas`` and of its
``fma_contraction_available``. Each wrapper takes the device from its
tensors: on CUDA tensors it launches its kernel or raises, and on CPU tensors
it runs the plain version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ellspmv_tpu_torch.formats.ell import EllMatrix
from ellspmv_tpu_torch.ops import _build

#: Kernel launches made by `ell_spmv` in this process.
launches = 0
#: Kernel launches made by `fma_probe` in this process.
probe_launches = 0
#: `fma_contraction_available` per device, probed once; clearing it makes
#: the next fp64 `ell_spmv` on a card probe again, as in a fresh process.
FMA_PROBE_RESULTS: dict[torch.device, bool] = {}

_VALUE_TAGS = {torch.float64: "f64", torch.float32: "f32",
               torch.bfloat16: "bf16"}
_INDEX_TAGS = {torch.int32: "i32", torch.int64: "i64"}


def ell_spmv_torch(ell: EllMatrix, x: torch.Tensor,
                   y: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version: ``(values * x[colidx]).sum(0)`` plus the
    diagonal plus y, accumulated in the values' type (float32 for bf16) and
    returned in the values' type."""
    n = ell.num_rows
    dtype = ell.values.dtype
    acc_dt = torch.float32 if dtype == torch.bfloat16 else dtype
    xa = x.to(acc_dt)
    out = (ell.values[:, :n].to(acc_dt) * xa[ell.colidx[:, :n]]).sum(0)
    if ell.diag is not None and ell.num_columns > 0:
        xi = torch.arange(n, device=x.device).clamp_(max=ell.num_columns - 1)
        out = out + ell.diag[:n].to(acc_dt) * xa[xi]
    if y is not None:
        out = out + y.to(acc_dt)
    return out.to(dtype)


def check_tensors(kernel: str, device: torch.device, named: list):
    """Raise unless each (name, tensor, shape, dtype) of `named` lies on
    `device` with that shape and type and is contiguous."""
    for name, t, want_shape, want_dtype in named:
        if t.device != device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, the "
                             f"matrix on {device}")
        if tuple(t.shape) != want_shape:
            raise ValueError(f"{kernel}: {name} has shape {tuple(t.shape)},"
                             f" expected {want_shape}")
        if t.dtype != want_dtype:
            raise TypeError(f"{kernel}: {name} is {t.dtype}, expected "
                            f"{want_dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} is not contiguous")


def _check(ell: EllMatrix, x: torch.Tensor, y: torch.Tensor | None):
    dtype, device = ell.values.dtype, ell.values.device
    if dtype not in _VALUE_TAGS:
        raise TypeError(f"ell_spmv: unsupported value dtype {dtype}")
    if ell.colidx.dtype not in _INDEX_TAGS:
        raise TypeError(f"ell_spmv: unsupported index dtype "
                        f"{ell.colidx.dtype}")
    shape = (ell.rowsize, ell.padded_rows)
    named = [("colidx", ell.colidx, shape, ell.colidx.dtype),
             ("values", ell.values, shape, dtype),
             ("x", x, (ell.num_columns,), dtype)]
    if ell.diag is not None:
        named.append(("diag", ell.diag, (ell.padded_rows,), dtype))
    if y is not None:
        named.append(("y", y, (ell.num_rows,), dtype))
    check_tensors("ell_spmv", device, named)
    if ell.num_rows > ell.padded_rows:
        raise ValueError("ell_spmv: num_rows exceeds the padded row count")


_SPMV_ARGS = (ctypes.c_void_p,) * 6 + (ctypes.c_int64,) * 4 \
    + (ctypes.c_void_p,)
_PROBE_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int64, ctypes.c_void_p)


def ell_spmv(ell: EllMatrix, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """y := A*x + y, a new vector of length ``ell.num_rows`` in the values'
    type. x, y and the matrix share one device and one value type."""
    global launches
    _check(ell, x, y)
    if x.device.type == "cpu":
        return ell_spmv_torch(ell, x, y)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmv: no kernel for tensors on {x.device}")
    # The fp64 path's first call on a card probes it, as the JAX fp64 path
    # does (ell_pallas.DevicePlan._fastdd): its stated accuracy assumes
    # multiply-adds that round once.
    if ell.values.dtype == torch.float64 \
            and not fma_contraction_available(x.device):
        raise RuntimeError(
            f"ell_spmv: the fused multiply-add on {x.device} does not round "
            "once (fma_probe disagrees with the exact residual)")
    fn, error_string = _build.entry(
        f"ell_spmv_{_VALUE_TAGS[ell.values.dtype]}_"
        f"{_INDEX_TAGS[ell.colidx.dtype]}", _SPMV_ARGS)
    out = torch.empty(ell.num_rows, dtype=ell.values.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(ell.colidx.data_ptr(), ell.values.data_ptr(),
             None if ell.diag is None else ell.diag.data_ptr(),
             x.data_ptr(), None if y is None else y.data_ptr(),
             out.data_ptr(), ell.num_rows, ell.padded_rows, ell.rowsize,
             ell.num_columns, stream)
    if err != 0:
        raise RuntimeError(f"ell_spmv kernel launch failed: "
                           f"{error_string(err).decode()} (error {err})")
    launches += 1
    return out


def fma_probe_torch(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The probe's plain version: the exact residual ``a*b - fl(a*b)`` of
    each float32 product, computed in float64 (where the product of two
    float32 values is exact)."""
    return (a.double() * b.double() - (a * b).double()).float()


def probe_inputs(device) -> tuple[torch.Tensor, torch.Tensor]:
    """The fp64 path's probe inputs: the JAX probe's (8, 128) float32 pairs
    from ``RandomState(0)`` (ell_pallas.py:155-157)."""
    rng = np.random.RandomState(0)
    a = rng.uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    b = rng.uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    return torch.from_numpy(a).to(device), torch.from_numpy(b).to(device)


def fma_probe(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``fmaf(a, b, -fl(a*b))`` elementwise for float32 tensors of one shape
    on one device: the exact residual of each product wherever the fused
    multiply-add rounds once."""
    global probe_launches
    for name, t in (("a", a), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"fma_probe: {name} is {t.dtype}, expected "
                            "torch.float32")
        if t.device != a.device or t.shape != a.shape:
            raise ValueError("fma_probe: a and b differ in device or shape")
        if not t.is_contiguous():
            raise ValueError(f"fma_probe: {name} is not contiguous")
    if a.device.type == "cpu":
        return fma_probe_torch(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"fma_probe: no kernel for tensors on {a.device}")
    fn, error_string = _build.entry("fma_probe_f32", _PROBE_ARGS)
    out = torch.empty_like(a)
    err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
             torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fma_probe kernel launch failed: "
                           f"{error_string(err).decode()} (error {err})")
    probe_launches += 1
    return out


def fma_contraction_available(device) -> bool:
    """Whether the fused multiply-add on `device` rounds once: `fma_probe`
    on the probe inputs equals the exact residual and is not all zero (the
    test of ``ell_pallas.fma_contraction_available``). Probed once per
    device and kept in `FMA_PROBE_RESULTS`."""
    device = torch.device(device)
    if device not in FMA_PROBE_RESULTS:
        a, b = probe_inputs(device)
        got = fma_probe(a, b).cpu()
        exact = fma_probe_torch(a.cpu(), b.cpu())
        FMA_PROBE_RESULTS[device] = bool(torch.equal(got, exact)
                                         and bool((exact != 0).any()))
    return FMA_PROBE_RESULTS[device]
