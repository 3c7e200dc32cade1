"""fp64 dot product: the wrapper of the hand-written CUDA kernel
(``csrc/dot.cu``) and its plain PyTorch version.

Counterpart of ``ellspmv_tpu.ops.dd_reduce.dd_vdot`` and ``dd_vdot_split``
(the Pallas kernel ``_dot_kernel``, K6), which compute the fp64 dot products
of the CG solver in double-double on the TPU. The card has native fp64, so
`vdot` takes fp64 vectors. The wrapper takes the device from its tensors: on
CUDA tensors it launches the kernel or raises, and on CPU tensors it runs the
plain version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ellspmv_tpu_torch.ops import _build
from ellspmv_tpu_torch.ops.ell_cuda import check_tensors

#: Kernel launches made by `vdot` in this process.
launches = 0
#: The per-block partial sums the kernel may write (its blocks at most).
PARTIALS = 1024

_ARGS = (ctypes.c_void_p,) * 4 + (ctypes.c_int64,) * 2 + (ctypes.c_void_p,)


def vdot_torch(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: the elementwise product, then its sum."""
    return (x * y).sum()


def _check(x: torch.Tensor, y: torch.Tensor):
    if x.dim() != 1:
        raise ValueError(f"vdot: x has shape {tuple(x.shape)}, expected a "
                         "vector")
    n = x.shape[0]
    check_tensors("vdot", x.device, [("x", x, (n,), torch.float64),
                                     ("y", y, (n,), torch.float64)])


def vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Σ x[i]·y[i] of two fp64 vectors of one length on one device, as a
    0-d fp64 tensor on that device. On a card the sum's order depends on
    the length alone, so equal inputs give equal bits."""
    global launches
    _check(x, y)
    if x.device.type == "cpu":
        return vdot_torch(x, y)
    if x.device.type != "cuda":
        raise ValueError(f"vdot: no kernel for tensors on {x.device}")
    fn, error_string = _build.entry("dot_f64", _ARGS)
    partials = torch.empty(PARTIALS, dtype=torch.float64, device=x.device)
    out = torch.empty((), dtype=torch.float64, device=x.device)
    err = fn(x.data_ptr(), y.data_ptr(), partials.data_ptr(), out.data_ptr(),
             x.shape[0], PARTIALS,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"vdot kernel launch failed: "
                           f"{error_string(err).decode()} (error {err})")
    launches += 1
    return out
