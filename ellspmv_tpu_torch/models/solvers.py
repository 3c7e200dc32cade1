"""Conjugate gradient over the SpMV kernels, the counterpart of
``ellspmv_tpu.models.solvers.cg``.

The JAX solver runs its loop inside one ``lax.while_loop``, the convergence
test on the device. `cg` is its counterpart: one CG step (`masked_step`),
masked by a flag on the device, captured once in a CUDA graph
(``utils/graphs.py``) and replayed. Once the flag ``r·r > tol²·(b·b)``
falls, a step leaves x, r, r·r and the iteration count k as they are, so
the host need not test convergence before it queues the next step. Each
step copies k to pinned memory; the host waits for the step before the
newest it queued and reads k there. A later step's copy may have landed
by then, but k stops growing exactly where the flag falls, so "k is below
the number of the step waited for" reads the same from any of them: the
steps a solve runs follow from its iterations alone, not from how far the
card has got, and ranks that replay collectives in their steps
(``parallel/solver.cg_sharded``) all run the same number of them.
`STEPS_AHEAD` masked steps run after convergence. On the CPU the same step
runs eagerly and the flag is read after each step.

`cg_eager` is the loop that tests convergence on the host before every
iteration: the sharded solver runs it on gloo ranks that share a card
(whose collectives a graph cannot hold), and the card tests hold `cg`
against it, bit for bit.

fp64 dot products go through the hand-written kernel K6 (`ops.dot_cuda`,
the counterpart of the Pallas double-double ``dd_vdot``); float32 ones
through ``torch.dot``, as the JAX solver leaves ``jnp.vdot`` to XLA.

`pcg_set` is the one preconditioned CG, HPCG's timed unit (CG.cpp with
tolerance 0): a fixed number of preconditioned iterations from x = 0,
every tensor restarted on the device, nothing read by the host. Its
tensors (`PcgSet`) live across sets, so a driver captures one set in a
CUDA graph once and replays it for every later set.

`power_step` is NPB CG's outer step (the NAS Parallel Benchmarks' inverse
power iteration): `pcg_set` without a preconditioner on b = x, then ζ and
the next x, all on the device, with a step counter there; `power_stepper`
captures one step once and replays it.

The JAX package's ``cg_dd`` (and ``ops/dd_vec.py``) carry fp64 vectors as
f32 hi/lo pairs because the TPU has no fp64; native fp64 CG computes the
same thing, so they have no counterpart here.
"""

from __future__ import annotations

import contextlib
from typing import Callable, NamedTuple

import torch

from ellspmv_tpu_torch.ops import dot_cuda
from ellspmv_tpu_torch.utils.timing import span

#: Masked steps a converged `cg` runs on a card: the host's convergence
#: test lags the newest step it queued by STEPS_AHEAD - 1.
STEPS_AHEAD = 2


class CgResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: float   # sqrt(r.r) of the recursive residual r
    steps: int             # the steps run, masked ones included


class CgState(NamedTuple):
    """CG's tensors on the device, which `masked_step` updates in place: x,
    the residual r, the direction p, rs = r·r, tol2 = tol²·(b·b), the
    iterations k (int32) and the flag ``active = rs > tol2``."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rs: torch.Tensor
    tol2: torch.Tensor
    k: torch.Tensor
    active: torch.Tensor


def _operators(matvec, b, operand, vdot):
    mv = (lambda v: matvec(operand, v)) if operand is not None else matvec
    if vdot is None:
        vdot = dot_cuda.vdot if b.dtype == torch.float64 else torch.dot
    return mv, vdot


def cg_start(mv: Callable, vdot: Callable, b: torch.Tensor,
             x0: torch.Tensor | None, tol: float) -> CgState:
    """r = b - A·x0, p = r, rs = r·r, tol2 = tol²·(b·b), k = 0."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    r = b - mv(x)
    p = r.clone()
    rs = vdot(r, r)
    tol2 = torch.tensor(tol, dtype=rs.dtype, device=rs.device) ** 2 \
        * vdot(b, b)
    k = torch.zeros((), dtype=torch.int32, device=b.device)
    return CgState(x, r, p, rs, tol2, k, rs > tol2)


def masked_step(s: CgState, mv: Callable, vdot: Callable):
    """One CG step on `s`, in place, masked by ``s.active``: where it holds,
    the ops and values of `cg_eager`'s iteration, and the count goes up;
    where it does not, α and β are 0, so x, r, rs and k keep their values
    (and their bits, but that a zero entry of x or r may change sign, which
    only a -0 in b or x0 can start) and p becomes r, finite, so nothing
    overflows however many masked steps run. Then ``s.active`` becomes
    ``rs > tol2``."""
    ap = mv(s.p)
    alpha = torch.where(s.active, s.rs / vdot(s.p, ap), 0.0)
    s.x.addcmul_(alpha, s.p)                     # x += alpha * p
    s.r.addcmul_(alpha, ap, value=-1)            # r -= alpha * ap
    rs_new = vdot(s.r, s.r)
    # p = r + (rs_new/rs) * p
    torch.addcmul(s.r, torch.where(s.active, rs_new / s.rs, 0.0), s.p,
                  out=s.p)
    torch.where(s.active, rs_new, s.rs, out=s.rs)
    s.k.add_(s.active)
    torch.gt(s.rs, s.tol2, out=s.active)


def cg(matvec: Callable, b: torch.Tensor, x0: torch.Tensor | None = None,
       tol: float = 1e-8, maxiter: int = 1000, operand=None,
       vdot: Callable | None = None) -> CgResult:
    """Conjugate gradient for SPD A, starting from r = b - A·x0, p = r.

    Stops when r·r <= tol²·(b·b) or after `maxiter` iterations. `matvec(v)`
    returns A·v, or `matvec(operand, v)` when `operand` is given; on a card
    it is captured in a CUDA graph, so it must be capturable (as
    ``ops.dispatch.traceable_spmv``'s is). `vdot` replaces the dot product
    (default: K6 for fp64 vectors, ``torch.dot`` otherwise); the smoke run
    passes the plain versions through `matvec` and `vdot` to solve the same
    system without the kernels. Iterations, x and the residual equal
    `cg_eager`'s bit for bit."""
    mv, vdot = _operators(matvec, b, operand, vdot)
    s = cg_start(mv, vdot, b, x0, tol)
    cuda = b.device.type == "cuda"
    lag = STEPS_AHEAD - 1
    count = torch.zeros((), dtype=s.k.dtype, pin_memory=cuda)

    def step():
        masked_step(s, mv, vdot)
        if cuda:
            count.copy_(s.k, non_blocking=True)

    done = [torch.cuda.Event() for _ in range(lag + 1)] if cuda else []
    steps, run = 0, step
    with contextlib.ExitStack() as graphs:
        if cuda and maxiter > 0:
            from ellspmv_tpu_torch.utils.graphs import Graph
            # the capture's warm-up runs the first step
            run = graphs.enter_context(Graph(step, b.device)).replay
            steps = 1
            done[steps % (lag + 1)].record()
        while steps < maxiter:
            if not cuda:
                if not bool(s.active):
                    break
            elif steps > lag:
                waited = steps - lag
                done[waited % (lag + 1)].synchronize()
                # k of that step or of a later one: below `waited` exactly
                # when the flag fell before step `waited`
                if int(count) < waited:
                    break
            run()
            steps += 1
            if cuda:
                done[steps % (lag + 1)].record()
        iterations = int(s.k)
    return CgResult(x=s.x, iterations=iterations,
                    residual_norm=float(torch.sqrt(s.rs)), steps=steps)


def cg_eager(matvec: Callable, b: torch.Tensor,
             x0: torch.Tensor | None = None, tol: float = 1e-8,
             maxiter: int = 1000, operand=None,
             vdot: Callable | None = None) -> CgResult:
    """`cg`'s solve as a loop launched eagerly that reads the convergence
    test ``rs > tol2`` on the host before every iteration: α and β stay on
    the device as 0-d tensors, so that is its one synchronisation an
    iteration. `matvec` need not be capturable."""
    mv, vdot = _operators(matvec, b, operand, vdot)
    x, r, p, rs, tol2, _, _ = cg_start(mv, vdot, b, x0, tol)
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
    return CgResult(x=x, iterations=k, residual_norm=float(torch.sqrt(rs)),
                    steps=k)


class PcgSet(NamedTuple):
    """The tensors of `pcg_set`, which every set reuses: x, the residual r,
    the direction p, rz = r·z, and ``norms[k] = ‖r_k‖`` for k = 0 to the
    set's iterations."""
    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    norms: torch.Tensor


def pcg_set_state(b: torch.Tensor, iterations: int) -> PcgSet:
    """`pcg_set`'s tensors for sets of `iterations` on `b`'s device."""
    return PcgSet(torch.zeros_like(b), torch.zeros_like(b),
                  torch.zeros_like(b), torch.zeros((), dtype=b.dtype,
                                                   device=b.device),
                  torch.zeros(iterations + 1, dtype=b.dtype,
                              device=b.device))


def pcg_set(s: PcgSet, matvec: Callable, b: torch.Tensor,
            precond: Callable | None = None, operand=None,
            vdot: Callable | None = None) -> None:
    """One set of HPCG's CG (CG.cpp) with tolerance 0, in `s`: x = 0, r =
    b - A·x, then ``len(s.norms) - 1`` iterations of z = M·r (z = r
    without `precond`), rz = r·z, p = z (first) or z + (rz/rz_old)·p, A·p,
    α = rz/(p·A·p), x += α·p, r -= α·A·p, each writing ‖r‖ into
    `s.norms`. Nothing reads the host and no shape depends on the values,
    so a set can be captured once (``utils/graphs.Graph``) and replayed:
    every set starts from the same x = 0. `matvec`, `operand` and `vdot`
    are `cg`'s.

    From x = 0 the residual is b itself, bit for bit what b - A·0 gives,
    so no multiply is spent on it. Without `precond`, z = r, and r·z is
    the r·r that the last iteration took for its norm, in the same bits:
    it is not taken twice."""
    mv, vdot = _operators(matvec, b, operand, vdot)
    s.x.zero_()
    s.r.copy_(b)                                        # r = b - A·0
    rr = vdot(s.r, s.r)
    torch.sqrt(rr, out=s.norms[0])
    for k in range(1, s.norms.numel()):
        if precond is None:
            z, rz = s.r, rr
        else:
            z = precond(s.r)
            rz = vdot(s.r, z)
        if k == 1:
            s.p.copy_(z)
        else:
            torch.addcmul(z, rz / s.rz, s.p, out=s.p)   # p = z + β·p
        s.rz.copy_(rz)
        ap = mv(s.p)
        alpha = rz / vdot(s.p, ap)
        s.x.addcmul_(alpha, s.p)                        # x += α·p
        s.r.addcmul_(alpha, ap, value=-1)               # r -= α·A·p
        rr = vdot(s.r, s.r)
        torch.sqrt(rr, out=s.norms[k])


class PowerState(NamedTuple):
    """The tensors of `power_step`, which every step reuses: NPB's x, the
    inner solve's tensors (`cg`, whose x is NPB's z), ζ, ‖x - A·z‖ and the
    steps completed (int64), all on one device."""
    x: torch.Tensor
    cg: PcgSet
    zeta: torch.Tensor
    rnorm: torch.Tensor
    steps: torch.Tensor


def power_state(n: int, iterations: int, dtype=torch.float64,
                device="cpu") -> PowerState:
    """`power_step`'s tensors for `iterations` CG iterations a step, x = 1
    and no step counted."""
    x = torch.ones(n, dtype=dtype, device=device)
    scalar = dict(dtype=dtype, device=device)
    return PowerState(x, pcg_set_state(x, iterations),
                      torch.zeros((), **scalar), torch.zeros((), **scalar),
                      torch.zeros((), dtype=torch.int64, device=device))


def power_step(s: PowerState, matvec: Callable, shift: float, operand=None,
               vdot: Callable | None = None) -> None:
    """One outer step of NPB CG's inverse power iteration (cg.f's
    ``conj_grad`` and ``main``), in place in `s`: z from `pcg_set` without
    a preconditioner on b = x (NPB's fixed count of CG iterations from z =
    0), then ‖x - A·z‖, ζ = shift + 1/(x·z) and x = z·(1/‖z‖), and the step
    counted. That is one multiply an iteration and one more. Nothing reads
    the host and no shape depends on the values, so a step can be captured
    once (`power_stepper`) and replayed. `matvec`, `operand` and `vdot` are
    `cg`'s."""
    mv, vdot = _operators(matvec, s.x, operand, vdot)
    pcg_set(s.cg, mv, s.x, vdot=vdot)
    z = s.cg.x
    d = s.x - mv(z)
    torch.sqrt(vdot(d, d), out=s.rnorm)
    torch.add(1 / vdot(s.x, z), shift, out=s.zeta)
    torch.mul(z, 1 / torch.sqrt(vdot(z, z)), out=s.x)
    s.steps.add_(1)


def power_stepper(s: PowerState, matvec: Callable, shift: float,
                  operand=None, vdot: Callable | None = None):
    """``(run, graph)``: `run()` makes one `power_step` on `s`. On a card
    the step is captured once in a CUDA graph (``utils/graphs.Graph``,
    whose warm-up makes one step), in the span
    ``solvers.power_step.capture`` (attributes `cg_iterations` and
    `multiplies`), and `run` replays it; the caller closes `graph`. On the
    CPU `run` is the step itself and `graph` None."""

    def step():
        power_step(s, matvec, shift, operand, vdot)
    if s.x.device.type != "cuda":
        return step, None
    from ellspmv_tpu_torch.utils.graphs import Graph
    iterations = s.cg.norms.numel() - 1
    with span("solvers.power_step.capture", cg_iterations=iterations,
              multiplies=iterations + 1):
        graph = Graph(step, s.x.device)
    return graph.replay, graph
