"""The Graph500 Kronecker graph as a symmetric matrix, on the device.

The edge list is the Graph500 specification's generator, in torch: 2^scale
vertices, edgefactor·2^scale edges, each edge's row and column bits drawn
level by level from the initiator (A, B, C, D = 1 - A - B - C), then the
vertex labels permuted at random. (The specification shuffles the edge
list too; the COO is sorted next, so that leaves no trace.) The graph is
undirected, as the specification's kernel 1 builds it: each edge gives the
entries (i, j) and (j, i); self-loops and repeated edges are dropped; each
remaining edge gets one weight, uniform on [0, 1), as the specification's
SSSP weights. Vertices that no edge touches are empty rows.

params: ``scale``, ``edgefactor``, ``a``, ``b``, ``c``.
"""

from __future__ import annotations

import torch

from spmv_bench.generators import Matrix, referenced_columns


def generate(params: dict, seed: int, device) -> Matrix:
    scale = int(params["scale"])
    a, b, c = float(params["a"]), float(params["b"]), float(params["c"])
    n = 1 << scale
    m = int(params["edgefactor"]) * n
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    ab, c_norm, a_norm = a + b, c / (1.0 - a - b), a / (a + b)
    i = torch.zeros(m, dtype=torch.int64, device=device)
    j = torch.zeros(m, dtype=torch.int64, device=device)
    for bit in range(scale):
        i_bit = torch.rand(m, generator=g, dtype=torch.float64,
                           device=device) > ab
        j_bit = torch.rand(m, generator=g, dtype=torch.float64,
                           device=device) > torch.where(i_bit, c_norm,
                                                        a_norm)
        i |= i_bit.long() << bit
        j |= j_bit.long() << bit
        del i_bit, j_bit
    label = torch.randperm(n, generator=g, device=device)
    i, j = label[i], label[j]
    del label
    keep = i != j
    lo = torch.minimum(i, j)[keep]
    hi = torch.maximum(i, j)[keep]
    del i, j, keep
    pair = torch.unique(lo * n + hi)
    del lo, hi
    weight = torch.rand(pair.numel(), generator=g, dtype=torch.float64,
                        device=device)
    r, c_ = pair // n, pair % n
    del pair
    key, order = torch.sort(torch.cat([r * n + c_, c_ * n + r]))
    distinct = weight.numel()
    values = torch.cat([weight, weight])[order]
    del r, c_, weight, order
    rows, cols = key // n, key % n
    del key
    return Matrix(n, rows, cols, values, distinct, referenced_columns(cols, n))
