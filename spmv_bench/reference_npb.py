"""The plain reference of ``npb_cg_c.cg``: NPB CG's timed phase (cg.f's
``conj_grad`` and the outer loop of ``main``) over the plain reference's
scatter-sum SpMV (``reference.Coo``), in the matrix's value type, its dot
products by ``torch.dot``. It imports nothing of the port.

An outer step from x: ``conj_grad`` (z = 0, r = x, p = r, ρ = r·r, then
`iterations` times q = A·p, α = ρ/(p·q), z += α·p, r -= α·q, ρ' = r·r,
p = r + (ρ'/ρ)·p), then ‖x - A·z‖, ζ = SHIFT + 1/(x·z) and x = z/‖z‖,
the reciprocal of the norm taken first, as NPB does.
"""

from __future__ import annotations

import torch

from spmv_bench.reference import Coo


def conj_grad(a: Coo, x: torch.Tensor, iterations: int):
    """z after `iterations` of CG on A·z = x from z = 0, and ‖x - A·z‖."""
    z = torch.zeros_like(x)
    r = x.clone()
    p = r.clone()
    rho = torch.dot(r, r)
    for _ in range(iterations):
        q = a.matvec(p)
        alpha = rho / torch.dot(p, q)
        z = z + alpha * p
        r = r - alpha * q
        rho0, rho = rho, torch.dot(r, r)
        p = r + (rho / rho0) * p
    d = x - a.matvec(z)
    return z, torch.sqrt(torch.dot(d, d))


def outer_step(a: Coo, x: torch.Tensor, shift: float, iterations: int):
    """One outer step from x: the next x, ζ and ‖x - A·z‖."""
    z, rnorm = conj_grad(a, x, iterations)
    zeta = shift + 1.0 / torch.dot(x, z)
    return z * (1.0 / torch.sqrt(torch.dot(z, z))), zeta, rnorm


def timed(a: Coo, niter: int, shift: float, iterations: int):
    """NPB's timed phase: x = 1, then `niter` outer steps. Returns x, ζ
    and ‖x - A·z‖ of the last step."""
    x = torch.ones(a.n, dtype=a.values.dtype, device=a.values.device)
    zeta = rnorm = None
    for _ in range(niter):
        x, zeta, rnorm = outer_step(a, x, shift, iterations)
    return x, zeta, rnorm
