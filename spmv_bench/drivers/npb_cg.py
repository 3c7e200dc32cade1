"""NPB CG's timed phase: back-to-back runs of NITER outer steps of inverse
power iteration, each from x = 1, each step 25 iterations of CG without a
preconditioner and one more multiply (cg.f's ``conj_grad`` and ``main``).

The class: the harness hands a driver the row count alone, and the CPU
self-checks make smaller classes than the configuration's, so the driver
takes SHIFT, NITER and the published ζ (``shift``, ``niter``,
``zeta_verify``) of the matrix it was handed from the generator's record
of what it made at that row count (``generators/npb_cg.made``).

`prepare`, with the port as the program: `power_stepper`
(``models/solvers.py``) captures one step in a CUDA graph, in the span
``solvers.power_step.capture`` of a ``utils/timing.recording()`` that
``npb_capture_s`` reads; then NPB's untimed step from x = 1, in the span
``solvers.power_step.warmup``; then x = 1 and the step counter 0. On the
CPU the steps run eagerly. With the harness's `Reference` in the
program's place (the control), the plain reference's step
(``reference_npb.py``) in the Reference's type, eagerly.

`window` runs runs, each x = 1 then NITER steps, at most ``in_flight``
ahead of the card, until ``seconds`` have passed on the host's clock, then
waits for the card. The first run's x and ζ are copied aside as they
land; the last run's stay in place. The card's step counter is read once,
after the window, through host memory pinned at set-up, so that the
traced window holds no allocation: ``run.iterations`` is the multiplies
it made, ``cg_iterations + 1`` a step.

`check`: ``x_gap``, the widest gap between x after the first and the last run and
the plain reference's x after one run in fp64, row by row, over the
reference's largest |x|. x is a unit vector, the eigenvector the iteration
converges to, so its rows are small where the eigenvector is, and the
largest one is the scale. Two fp64 solvers that sum in other orders part
by a few units of the last place, which the iteration does not grow; the
float32 control, a wrong multiply or a lost step move x far more. And
``zeta_gap``, |ζ - published| / published after the first and the last
run, against NPB's own verification limit, 1e-10.

One process on one card. Mix keys: ``cg_iterations``, ``in_flight``,
``limits.zeta_gap``, ``limits.x_gap``.
"""

from __future__ import annotations

import dataclasses
import math
import time

import torch

from spmv_bench import reference, reference_npb
from spmv_bench.generators import npb_cg


@dataclasses.dataclass
class State:
    cell: object
    shift: float
    niter: int
    iterations: int
    published: float
    step: object             # one step: a replay, or an eager call
    x: torch.Tensor
    zeta: torch.Tensor
    steps: torch.Tensor      # the steps completed, counted on the device
    first_x: torch.Tensor
    first_zeta: torch.Tensor
    count: torch.Tensor      # where the host reads `steps`
    keep: tuple = ()         # what the step's tensors belong to
    graph: object = None
    runs: int = 0


def _port(cell, operand, fn, shift, iterations):
    from ellspmv_tpu_torch.models import solvers
    from ellspmv_tpu_torch.utils import timing
    s = solvers.power_state(cell.n, iterations, cell.dtype, cell.device)
    with timing.recording() as rec:
        step, graph = solvers.power_stepper(s, fn, shift, operand=operand)
        with timing.span("solvers.power_step.warmup"):
            s.x.fill_(1)
            step()
            if graph is not None:
                torch.cuda.synchronize(cell.device)
    cell.run.npb_spans = rec
    return step, graph, s.x, s.zeta, s.steps, (s,)


def _reference(cell, operand, shift, iterations):
    x = torch.ones(cell.n, dtype=operand.values.dtype, device=cell.device)
    zeta = torch.zeros((), dtype=x.dtype, device=cell.device)
    steps = torch.zeros((), dtype=torch.int64, device=cell.device)

    def step():
        nx, z, _ = reference_npb.outer_step(operand, x, shift, iterations)
        x.copy_(nx)
        zeta.copy_(z)
        steps.add_(1)
    step()                                # NPB's untimed step
    return step, None, x, zeta, steps, ()


def prepare(cell, operand, fn) -> State:
    if cell.chips != 1:
        raise ValueError(f"the npb_cg driver runs on one card, not "
                         f"{cell.chips}")
    params = npb_cg.made[cell.n]
    shift, niter = float(params["shift"]), int(params["niter"])
    iterations = int(cell.mix["cg_iterations"])
    if isinstance(operand, reference.Coo):
        parts = _reference(cell, operand, shift, iterations)
    else:
        parts = _port(cell, operand, fn, shift, iterations)
    step, graph, x, zeta, steps, keep = parts
    x.fill_(1)
    steps.zero_()
    cell.run.npb_iterations = iterations
    cuda = torch.device(cell.device).type == "cuda"
    return State(cell, shift, niter, iterations,
                 float(params["zeta_verify"]), step, x, zeta, steps,
                 torch.empty_like(x), torch.empty_like(zeta),
                 torch.zeros((), dtype=steps.dtype, pin_memory=cuda), keep,
                 graph)


def window(state: State, seconds: float) -> None:
    cell = state.cell
    cuda = torch.device(cell.device).type == "cuda"
    in_flight = int(cell.mix["in_flight"])
    done = [torch.cuda.Event() for _ in range(in_flight)] if cuda else []
    if cuda:
        torch.cuda.synchronize(cell.device)
    i = 0
    t0 = time.perf_counter()
    while True:
        if cuda and i >= in_flight:
            done[i % in_flight].synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
        state.x.fill_(1)
        for _ in range(state.niter):
            state.step()
        if i == 0:
            state.first_x.copy_(state.x)
            state.first_zeta.copy_(state.zeta)
        if cuda:
            done[i % in_flight].record()
        i += 1
    if cuda:
        torch.cuda.synchronize(cell.device)
    cell.run.window_s = time.perf_counter() - t0
    state.count.copy_(state.steps)
    steps = int(state.count)
    cell.run.npb_steps = steps
    cell.run.iterations = (state.iterations + 1) * steps
    cell.run.attempted = cell.run.iterations
    state.runs = i


def release(state: State) -> None:
    """Keep the first and the last run's x and ζ; drop the graph and the
    step's other tensors."""
    if state.graph is not None:
        state.graph.close()
        state.graph = None
    state.step = None
    state.keep = ()


def check(state: State, ref: reference.Coo) -> dict:
    """``x_gap`` against one run of the plain reference in fp64,
    ``zeta_gap`` against NPB's published ζ."""
    limits = state.cell.mix["limits"]
    x_ref, zeta_ref, rnorm = reference_npb.timed(ref, state.niter,
                                                 state.shift,
                                                 state.iterations)
    print(f"spmv_bench: the reference's run: zeta {float(zeta_ref)!r}, "
          f"|x - A*z| {float(rnorm):.6e} after {state.niter} steps",
          flush=True)
    scale = float(x_ref.abs().max())
    zeta_gap = x_gap = 0.0
    pairs = [(state.first_x, state.first_zeta)]
    if state.runs > 1:
        pairs.append((state.x, state.zeta))
    for x, zeta in pairs:
        z_gap = abs(float(zeta) - state.published) / state.published
        gap = float((x.to(torch.float64) - x_ref).abs().max()) / scale
        if math.isnan(z_gap) or math.isnan(gap):
            zeta_gap = x_gap = float("nan")
            break
        zeta_gap, x_gap = max(zeta_gap, z_gap), max(x_gap, gap)
    checks = {"x_gap": (x_gap, float(limits["x_gap"])),
              "zeta_gap": (zeta_gap, float(limits["zeta_gap"]))}
    if not all(v <= limit for v, limit in checks.values()):
        state.cell.run.failed = (state.iterations + 1) * state.niter
    return checks
