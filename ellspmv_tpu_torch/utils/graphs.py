"""CUDA-graph capture: the port's counterpart of compiling a whole loop into
one device program, as the JAX package does with one ``jax.jit`` of a
``lax.fori_loop`` (the chained protocol) or a ``lax.while_loop`` (CG).

`Graph` runs a body once on a side stream first (its warm-up: whatever the
port does only on first use, such as the nvcc build, K7's probe with its
host read, the allocator's and cuBLAS's set-up, happens there), then
captures one call of the body in a CUDA graph. `Graph.replay` launches the
whole graph on the current stream at the cost of one launch. A body that
cannot be captured (a host read, a synchronise, a copy from pageable host
memory) makes the capture raise; nothing falls back to eager launches.
`close` frees the graph and its private memory pool.

The kernel wrappers count their launches where they are called (``ops/``).
During a capture nothing runs: the wrappers' calls only record kernels into
the graph. `Graph` takes those counts back after the capture and adds them
again at every replay, so that the counts stay the kernels that ran on the
card (and so do ``dia_cuda.symmetric_launches``, the part of K2's that
took its symmetric form, and ``ell_cuda.sliced_launches``, the part of
K1's on the sliced layout).

A body may hold NCCL collectives (over ranks, ``parallel/``: the allgather
of x, CG's all_reduces), the counterpart of the collectives inside one jit
of a ``shard_map``: ProcessGroupNCCL records them into the graph, and each
replay runs them on the group's communicator, which NCCL lets captured and
eager collectives share (the ranks' eager agreements, such as
``parallel/spmv.max_over_ranks``, run between replays). Every rank must
capture and replay its graphs in the same order, as it would launch the
collectives. The group's watchdog does not time a collective inside a
replay (``parallel/launch.RankPool``'s deadline still fails a rank stuck
there), and its polling of eager works from another thread does not spoil
a capture under the default capture mode: captures of 3,000 allgathers
and all_reduces (150-190 ms each) with 20 eager works left pending all
matched, drained first or not (PERF.md §6, the bring-up's findings;
torch 2.11, NCCL 2.28.9, an H100), so `Graph` drains nothing and keeps
that mode. Gloo's collectives on a card cannot be captured (gloo waits for the
card's tensors on the host): the capture raises, and
``parallel/mesh.traceable_loops`` keeps those ranks on eager loops.
"""

from __future__ import annotations

import torch

from ellspmv_tpu_torch.ops import dia_cuda, ell_cuda, launch_counters


class Graph:
    """`body()` captured once in a CUDA graph on `device`, after one call
    of it on a side stream (whose effects stand: a caller whose body
    updates state counts it as work done). Use as a context manager, or
    call `close`."""

    def __init__(self, body, device):
        self.device = torch.device(device)
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body()
        current.wait_stream(side)
        counters = [*launch_counters().values(),
                    (dia_cuda, "symmetric_launches"),
                    (ell_cuda, "sliced_launches")]
        before = [getattr(m, a) for m, a in counters]
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
                body()
        finally:
            #: (module, attribute, launches) that one replay adds
            self.launches = []
            for (m, a), b in zip(counters, before):
                recorded = getattr(m, a) - b
                setattr(m, a, b)
                if recorded:
                    self.launches.append((m, a, recorded))

    def replay(self):
        """Launch the graph on the current stream; count its kernels."""
        self.graph.replay()
        for m, a, n in self.launches:
            setattr(m, a, getattr(m, a) + n)

    def close(self):
        """Free the graph and its memory pool."""
        self.graph.reset()

    def __enter__(self) -> "Graph":
        return self

    def __exit__(self, *exc):
        self.close()
        return False
