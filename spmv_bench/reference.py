"""The plain reference: ``y := A·x + y`` as a COO scatter-sum in plain
torch, and the chained recursion on top of it. It imports nothing of the
port and takes nothing the port made: the benchmark hands it the
generator's COO, made again from the seed.

Products are summed by ``index_add_`` in blocks of at most `BLOCK`
entries, so that the reference fits beside what it checks.
"""

from __future__ import annotations

import torch

BLOCK = 1 << 25


class Coo:
    """A COO matrix in one value type: `rows`, `cols` int64, `values`."""

    def __init__(self, n, rows, cols, values, dtype=torch.float64):
        self.n = n
        self.rows, self.cols = rows, cols
        self.values = values.to(dtype)

    def matvec(self, x: torch.Tensor, y: torch.Tensor | None = None,
               absolute: bool = False) -> torch.Tensor:
        """``A·x + y`` in the values' type (or ``|A|·|x| + y`` where
        `absolute`)."""
        out = (torch.zeros(self.n, dtype=self.values.dtype, device=x.device)
               if y is None else y.to(self.values.dtype, copy=True))
        xv = x.to(self.values.dtype)
        if absolute:
            xv = xv.abs()
        for lo in range(0, self.rows.numel(), BLOCK):
            v = self.values[lo:lo + BLOCK]
            prod = (v.abs() if absolute else v) * xv[self.cols[lo:lo + BLOCK]]
            out.index_add_(0, self.rows[lo:lo + BLOCK], prod)
        return out


def chained(a: Coo, x: torch.Tensor, y: torch.Tensor, iters: int,
            scale: float):
    """`iters` chained iterations from (x, y): ``y := A·x + y``, ``x <-
    scale·y``. Returns y and ``|y0| + Σ |A|·|x_k|``, the size of what the
    iterations added up, against which a row's gap is measured."""
    size = y.to(a.values.dtype).abs()
    for _ in range(iters):
        size = a.matvec(x, size, absolute=True)
        y = a.matvec(x, y)
        x = y * scale
    return y, size

