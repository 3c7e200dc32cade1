"""Traffic drivers, one module per ``"driver"`` a mix file names, each
with ``prepare(cell, operand, fn)`` (set-up: captures and warm-up),
``window(state, seconds)``, ``release(state)`` (drops what holds the
program's memory) and ``check(state, ref)`` (the compared numbers)."""

from __future__ import annotations

import hashlib


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the part of a run that `tags` names."""
    digest = hashlib.blake2b(repr((int(seed),) + tags).encode(),
                             digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def capture(body, device):
    """`body()` once on a side stream (its warm-up), then captured in a
    CUDA graph; returns the graph."""
    import torch

    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        body()
    current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.device(device), torch.cuda.graph(graph):
        body()
    return graph
