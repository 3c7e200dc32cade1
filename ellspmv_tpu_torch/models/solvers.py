"""Conjugate gradient over the SpMV kernels, the counterpart of
``ellspmv_tpu.models.solvers.cg``.

The JAX solver runs its loop inside one ``lax.while_loop``; PyTorch runs
eagerly, so this loop is Python. α and β stay on the device as 0-d tensors,
and the vector updates take them as tensors, so the one host read per
iteration is the convergence test ``rs > tol2``. That read synchronises with
the card once per iteration; a CUDA graph, or testing only every few
iterations, would remove it (later work, see PERF.md).

fp64 dot products go through the hand-written kernel K6 (`ops.dot_cuda`,
the counterpart of the Pallas double-double ``dd_vdot``); float32 ones
through ``torch.dot``, as the JAX solver leaves ``jnp.vdot`` to XLA.

The JAX package's ``cg_dd`` (and ``ops/dd_vec.py``) carry fp64 vectors as
f32 hi/lo pairs because the TPU has no fp64; native fp64 CG computes the
same thing, so they have no counterpart here.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ellspmv_tpu_torch.ops import dot_cuda


class CgResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float   # sqrt(r.r) of the recursive residual r


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
       tol: float = 1e-8, maxiter: int = 1000, operand=None,
       vdot: Callable | None = None) -> CgResult:
    """Conjugate gradient for SPD A, starting from r = b - A·x0, p = r.

    Stops when r·r <= tol²·(b·b) or after `maxiter` iterations. `matvec(v)`
    returns A·v, or `matvec(operand, v)` when `operand` is given. `vdot`
    replaces the dot product (default: K6 for fp64 vectors, ``torch.dot``
    otherwise); the smoke run passes the plain versions through `matvec`
    and `vdot` to solve the same system without the kernels.
    """
    mv = (lambda v: matvec(operand, v)) if operand is not None else matvec
    if vdot is None:
        vdot = dot_cuda.vdot if b.dtype == torch.float64 else torch.dot
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - mv(x)
    p = r.clone()
    rs = vdot(r, r)
    tol2 = torch.tensor(tol, dtype=rs.dtype, device=rs.device) ** 2 \
        * vdot(b, b)
    k = 0
    while k < maxiter and bool(rs > tol2):
        ap = mv(p)
        alpha = rs / vdot(p, ap)
        x.addcmul_(alpha, p)                      # x += alpha * p
        r.addcmul_(alpha, ap, value=-1)           # r -= alpha * ap
        rs_new = vdot(r, r)
        torch.addcmul(r, rs_new / rs, p, out=p)   # p = r + (rs_new/rs) * p
        rs = rs_new
        k += 1
    return CgResult(x=x, iterations=k, residual_norm=float(torch.sqrt(rs)))
