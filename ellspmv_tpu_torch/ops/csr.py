"""CSR SpMV: the counterpart of ``ellspmv_tpu.ops.csr_pallas`` (the sliced-ELL
repack on K1) and of ``ellspmv_tpu.ops.csr_xla`` (the segment sum).

The reference's CSR kernels walk rowptr row by row (csrgemv,
csrspmv.c:1588-1593). The JAX package runs a CSR on the TPU by repacking its
entries once, on the host, into the sliced ELL of ``formats/sell.py``,
cached on the matrix, whose buckets run the ELL kernel; the split diagonal
and y follow as an epilogue (csrgemvsd's semantics, csrspmv.c:1598-1629).
`csr_spmv` is that route, and the one the port's ``csrspmv`` runs: on a card
every bucket is a K1 launch.

`csr_spmv_segment` is the segment-sum form (a product per stored entry,
then a sum by row): the SELL format's CSR tail and the tests use it. It
is plain PyTorch on any device, as in the JAX package it is XLA, not a
Pallas kernel.
"""

from __future__ import annotations

import torch

from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.csr import CsrMatrix


def csr_spmv_segment(csr: CsrMatrix, x: torch.Tensor,
                     y: torch.Tensor | None = None) -> torch.Tensor:
    """y := A*x + y in the values' type: y plus the row sums of the
    products ``values * x[colidx]``, then the split diagonal, as
    ``csr_xla._csr_spmv`` orders them. The row sums are one segmented sum
    over `rowptr` (``torch.segment_reduce``: one sequential sum a row on
    the CPU, as the JAX package's ``segment_sum`` there, and deterministic
    on a card, where ``index_add_``'s atomics add in a varying order)."""
    n, dtype = csr.num_rows, csr.values.dtype
    x = x.to(dtype)
    out = x.new_zeros(n)
    if csr.csrsize:
        out = torch.segment_reduce(csr.values * x[csr.colidx], "sum",
                                   lengths=csr.rowptr[1:] - csr.rowptr[:-1],
                                   unsafe=True)
    if y is not None:
        out = y.to(dtype) + out
    return _add_diagonal(csr, x, out)


def _add_diagonal(csr: CsrMatrix, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Add the split diagonal's products to the first min(rows, columns)
    entries of `out`, a vector the caller owns, in place."""
    if csr.diag is not None:
        k = min(csr.num_rows, csr.num_columns)
        out[:k] += csr.diag[:k] * x[:k]
    return out


def to_sell(csr: CsrMatrix):
    """The sliced-ELL repack of `csr`'s stored entries (``sell_from_coo``'s
    defaults, as ``csr_pallas._to_sell`` builds it), on the host, then on
    the CSR's device; built once and cached on the matrix."""
    cached = getattr(csr, "_sell_cache", None)
    if cached is not None:
        return cached
    from ellspmv_tpu_torch.formats.sell import sell_from_coo
    values = csr.values.cpu()
    host = values.double() if values.dtype == torch.bfloat16 else values
    coo = CooMatrix(csr.num_rows, csr.num_columns, csr.rowids.cpu().numpy(),
                    csr.colidx.cpu().numpy(), host.numpy())
    sm = sell_from_coo(coo, value_dtype=values.dtype, device="cpu")
    csr._sell_cache = sm.to(csr.device)
    return csr._sell_cache


def csr_spmv(csr: CsrMatrix, x: torch.Tensor,
             y: torch.Tensor | None = None) -> torch.Tensor:
    """y := A*x + y through the cached sliced-ELL repack (K1 per bucket on
    a card, the plain version on the CPU), then the split diagonal and y,
    in the values' type. (``--backend=xla`` runs `csr_spmv_segment`
    instead, as the JAX package runs ``csr_xla`` there.)"""
    from ellspmv_tpu_torch.formats.sell import sell_spmv
    x = x.to(csr.values.dtype)
    out = _add_diagonal(csr, x, sell_spmv(to_sell(csr), x))
    return out if y is None else out + y.to(out.dtype)
