"""The chained SpMV: ``y := A·x + y``, then ``x <- scale·y``, so that
every multiply waits for the last.

Iterations run in blocks of ``block``, each captured once in a CUDA graph
(on the CPU the blocks run eagerly). Two graphs take turns: one reads y
from buffer 0 and leaves it in buffer 1, the other the reverse, so once
the window has closed the last block's input is still there. The window
replays the graphs, at most ``in_flight`` blocks ahead of the card, until
``seconds`` have passed on the host's clock, then waits for the card. The
first block's output is copied aside as it lands. The reference then runs
the first block from the seed's x and y = 0, and the last block from its
input: the first holds the run to its start (a loop that loses its state
agrees with itself later on), the last holds the y the window ends
with.

One process on one card: a cell that asks for more chips needs a driver
of its own, which launches the ranks.

Mix keys: ``block``, ``in_flight``, ``scale``, ``limits.y_gap``.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from spmv_bench import reference
from spmv_bench.drivers import capture, derive


@dataclasses.dataclass
class State:
    cell: object
    x0: torch.Tensor
    x: torch.Tensor
    first: torch.Tensor
    bufs: list
    bodies: list
    graphs: list
    replays: int = 0


def prepare(cell, operand, fn) -> State:
    if cell.chips != 1:
        raise ValueError(f"the chained driver runs on one card, not "
                         f"{cell.chips}")
    mix, n, device = cell.mix, cell.n, cell.device
    block, scale = int(mix["block"]), float(mix["scale"])
    g = torch.Generator(device=device)
    g.manual_seed(derive(cell.seed, "x0"))
    x0 = torch.rand(n, generator=g, dtype=torch.float64,
                    device=device).to(cell.dtype)
    x = x0.clone()
    bufs = [torch.zeros(n, dtype=cell.dtype, device=device)
            for _ in range(2)]

    def body(k):
        def run():
            y = bufs[k]
            for _ in range(block):
                y = fn(operand, x, y)
                torch.mul(y, scale, out=x)
            bufs[1 - k].copy_(y)
        return run

    bodies = [body(0), body(1)]
    graphs = []
    if torch.device(device).type == "cuda":
        graphs = [capture(b, device) for b in bodies]
        for graph in graphs:         # the replays' own first launch
            graph.replay()
        torch.cuda.synchronize(device)
    else:
        for b in bodies:
            b()
    x.copy_(x0)
    bufs[0].zero_()
    return State(cell, x0, x, torch.empty_like(x0), bufs, bodies, graphs)


def window(state: State, seconds: float) -> None:
    cell = state.cell
    in_flight = int(cell.mix["in_flight"])
    run = ([g.replay for g in state.graphs] if state.graphs
           else state.bodies)
    cuda = bool(state.graphs)
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
        run[i % 2]()
        if i == 0:
            state.first.copy_(state.bufs[1])
        if cuda:
            done[i % in_flight].record()
        i += 1
    if cuda:
        torch.cuda.synchronize(cell.device)
    cell.run.window_s = time.perf_counter() - t0
    cell.run.iterations = i * int(cell.mix["block"])
    cell.run.attempted = cell.run.iterations
    state.replays = i


def release(state: State) -> None:
    """Keep the last block's input and output; drop the graphs."""
    for graph in state.graphs:
        graph.reset()
    state.graphs.clear()
    state.bodies.clear()


def check(state: State, ref: reference.Coo) -> dict:
    """``y_gap``: the widest gap, row by row, between the program's y and
    the reference's after the first block and after the last, each
    against the size of what that block added up in that row."""
    mix = state.cell.mix
    block, scale = int(mix["block"]), float(mix["scale"])
    last = state.replays - 1
    y_in, y_out = state.bufs[last % 2], state.bufs[1 - last % 2]
    x0 = state.x0.to(torch.float64)
    blocks = [(x0, torch.zeros_like(x0), state.first)]
    if last > 0:
        y0 = y_in.to(torch.float64)
        blocks.append((y0 * scale, y0, y_out))
    value = 0.0
    for x_start, y_start, y_prog in blocks:
        y_ref, size = reference.chained(ref, x_start, y_start, block, scale)
        diff = (y_prog.to(torch.float64) - y_ref).abs()
        gap = torch.where(size > 0, diff / torch.where(size > 0, size, 1.0),
                          torch.where(diff > 0, torch.inf, 0.0))
        if gap.numel():
            value = max(value, float(gap.max()))
            if gap.isnan().any():
                value = float("nan")
    limit = float(mix["limits"]["y_gap"])
    if not value <= limit:
        state.cell.run.failed = block
    return {"y_gap": (value, limit)}
