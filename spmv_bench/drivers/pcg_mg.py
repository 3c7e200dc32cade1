"""HPCG's timed phase: back-to-back sets of preconditioned CG, each a fixed
number of iterations at tolerance 0 from x = 0, on b = A·1, with HPCG's
multigrid V-cycle as the preconditioner.

The grid: the harness hands a driver the row count alone, so nx = ny = nz
= ∛n, checked to be exact and a multiple of ``2**(levels-1)`` (the mix
file's ``grid`` says so): this traffic runs HPCG's cubes only.

`prepare`, with the port as the program: the hierarchy through the port
(``models/multigrid.build`` from the fine matrix the harness converted,
each coarse level through the chooser), recorded in a
``utils/timing.recording()`` that ``mg_setup_s`` reads; b = A·1 through
the port's SpMV; then one set captured in a CUDA graph
(``utils/graphs.Graph``, whose warm-up runs one set) and replayed once.
Every set replays that graph: it restarts x, r, p, r·z and the residual
norms on the card, so nothing is captured again. On the CPU the sets run
eagerly. With the harness's `Reference` in the program's place (the
control), the plain reference's hierarchy (``reference_hpcg.py``) in the
Reference's type instead, its sets run eagerly.

`window` replays sets, at most ``in_flight`` ahead of the card, until
``seconds`` have passed on the host's clock, then waits for the card. The
first set's x is copied aside as it lands; the last set's stays in place.
``run.iterations`` counts the PCG iterations completed. K8's launches in
the window (``ops/symgs_cuda.launches``, which the graph's replays
advance) count the smoother's sweeps for ``symgs_roofline_pct``.

`check`: ``x_gap``, the widest gap, row by row, between the program's x
after the first set and after the last, and the plain reference's x after
one set, each over the reference's |x| in that row. The scale: b = A·1, so
the exact solution is 1 in every row, and a set leaves x within its
residual's reach of it, so every row of x is of size 1 and a row's gap is
its relative error. Two fp64 solvers that sum in other orders part by a
few units of the last place, carried through the set's iterations; a
wrong sweep, colour, transfer or coefficient moves x by far more than
that, and so does the float32 control, whose sets stall at float32's
rounding.

One process on one card. Mix keys: ``iterations``, ``levels``,
``in_flight``, ``grid``, ``limits.x_gap``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from spmv_bench import reference, reference_hpcg


@dataclasses.dataclass
class State:
    cell: object
    grid: tuple
    depth: int
    iterations: int
    run_set: object          # one set: a replay, or an eager call
    x: torch.Tensor          # the set's x, where it ends
    first: torch.Tensor
    keep: tuple = ()         # what the set's tensors belong to
    counter: object = None   # the module whose `launches` counts K8's
    graph: object = None
    replays: int = 0


def grid_of(n: int, levels: int) -> tuple:
    side = round(n ** (1 / 3))
    step = 2 ** (levels - 1)
    if side ** 3 != n or side % step:
        raise ValueError(f"the pcg_mg driver runs HPCG's cubes: {n:,} rows "
                         f"is not a cube whose side divides by {step}")
    return (side, side, side)


def _port(cell, operand, fn, grid, depth, iterations) -> State:
    from ellspmv_tpu_torch.models import multigrid, solvers
    from ellspmv_tpu_torch.ops import symgs_cuda
    from ellspmv_tpu_torch.utils import timing
    with timing.recording() as rec:
        hierarchy = multigrid.build(operand, grid, depth)
    cell.run.mg_spans = rec
    cell.run.mg_grids = [lv.grid for lv in hierarchy.levels]
    cell.run.mg_sweeps = hierarchy.sweeps_per_cycle()
    b = fn(operand, torch.ones(cell.n, dtype=cell.dtype, device=cell.device))
    s = solvers.pcg_set_state(b, iterations)

    def one_set():
        solvers.pcg_set(s, fn, b, precond=hierarchy, operand=operand)
    state = State(cell, grid, depth, iterations, one_set, s.x,
                  torch.empty_like(s.x), (hierarchy, b, s), symgs_cuda)
    if torch.device(cell.device).type == "cuda":
        from ellspmv_tpu_torch.utils.graphs import Graph
        state.graph = Graph(one_set, cell.device)
        state.run_set = state.graph.replay
        state.run_set()                   # the replays' own first launch
        torch.cuda.synchronize(cell.device)
    return state


def _reference(cell, operand, grid, depth, iterations) -> State:
    levels = reference_hpcg.hierarchy(operand, grid, depth,
                                      operand.values.dtype)
    b = levels[0].matvec(torch.ones(cell.n, dtype=operand.values.dtype,
                                    device=cell.device))
    x = torch.zeros_like(b)

    def one_set():
        x.copy_(reference_hpcg.pcg_set(levels, b, iterations)[0])
    return State(cell, grid, depth, iterations, one_set, x,
                 torch.empty_like(x), (levels, b))


def prepare(cell, operand, fn) -> State:
    if cell.chips != 1:
        raise ValueError(f"the pcg_mg driver runs on one card, not "
                         f"{cell.chips}")
    mix = cell.mix
    depth, iterations = int(mix["levels"]), int(mix["iterations"])
    grid = grid_of(cell.n, depth)
    if isinstance(operand, reference.Coo):
        return _reference(cell, operand, grid, depth, iterations)
    return _port(cell, operand, fn, grid, depth, iterations)


def window(state: State, seconds: float) -> None:
    cell = state.cell
    cuda = state.graph is not None
    in_flight = int(cell.mix["in_flight"])
    done = [torch.cuda.Event() for _ in range(in_flight)] if cuda else []
    before = state.counter.launches if state.counter else 0
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize(cell.device)
    i = 0
    t0 = time.perf_counter()
    while True:
        if cuda and i >= in_flight:
            done[i % in_flight].synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
        state.run_set()
        if i == 0:
            state.first.copy_(state.x)
        if cuda:
            done[i % in_flight].record()
        elif torch.device(cell.device).type == "cuda":
            torch.cuda.synchronize(cell.device)
        i += 1
    if torch.device(cell.device).type == "cuda":
        torch.cuda.synchronize(cell.device)
    cell.run.window_s = time.perf_counter() - t0
    cell.run.iterations = i * state.iterations
    cell.run.attempted = cell.run.iterations
    if state.counter:
        cell.run.symgs_launches = state.counter.launches - before
    state.replays = i


def release(state: State) -> None:
    """Keep the first and the last set's x; drop the graph, the hierarchy
    and the set's other tensors."""
    if state.graph is not None:
        state.graph.close()
        state.graph = None
    state.run_set = None
    state.keep = ()


def check(state: State, ref: reference.Coo) -> dict:
    """``x_gap`` against one set of the plain reference in fp64."""
    limit = float(state.cell.mix["limits"]["x_gap"])
    levels = reference_hpcg.hierarchy(ref, state.grid, state.depth)
    b = levels[0].matvec(torch.ones(ref.n, dtype=torch.float64,
                                    device=ref.rows.device))
    x_ref, norms = reference_hpcg.pcg_set(levels, b, state.iterations)
    del levels
    print(f"spmv_bench: the reference's set: |r| fell from "
          f"{float(norms[0]):.6e} to {float(norms[-1]):.6e} in "
          f"{state.iterations} iterations", flush=True)
    scale = x_ref.abs()
    value = 0.0
    for x in ([state.first, state.x] if state.replays > 1
              else [state.first]):
        diff = (x.to(torch.float64) - x_ref).abs()
        gap = torch.where(scale > 0, diff / torch.where(scale > 0, scale,
                                                        1.0),
                          torch.where(diff > 0, torch.inf, 0.0))
        if gap.isnan().any():
            value = float("nan")
            break
        value = max(value, float(gap.max()))
    if not value <= limit:
        state.cell.run.failed = state.iterations
    return {"x_gap": (value, limit)}
