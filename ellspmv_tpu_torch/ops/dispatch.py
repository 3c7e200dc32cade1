"""Kernel dispatch, the counterpart of ``ellspmv_tpu.ops.dispatch.spmv``
(and of the reference's flag dispatch in main, ellspmv.c:1834-1843), keyed
on the format and the backend.

``auto`` and ``pallas`` run the hand-written kernels. ``xla`` runs the plain
PyTorch versions, on the matrix's device, of exactly what the JAX
package's ``xla`` backend moves off its Pallas kernels: ELL through
``ell_cuda.ell_spmv_torch``, CSR through the segment sum
(``ops/csr.csr_spmv_segment``, the counterpart of ``csr_xla``), and the
buckets of SELL and of both hybrid parts through the ELL plain version. DIA
and the stream format keep their kernels, as the JAX package ignores the
backend for them; so does the hybrid's gather of x, which the JAX package
runs the same way under every backend. The backend is only ever what the
user asked for: nothing moves to a plain version because a kernel failed.

`traceable_spmv` is the counterpart of ``ellspmv_tpu.ops.dispatch.
traceable_spmv``: the SpMV in a form that a CUDA graph can capture, as the
JAX package's is one that an outer ``jax.jit`` can trace.
"""

from __future__ import annotations

import torch

from ellspmv_tpu_torch.formats.csr import CsrMatrix
from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix
from ellspmv_tpu_torch.formats.hybrid import HybridMatrix, hybrid_spmv
from ellspmv_tpu_torch.formats.sell import (SellMatrix, bucket_spmv,
                                            sell_spmv)
from ellspmv_tpu_torch.formats.stream import StreamMatrix, stream_spmv
from ellspmv_tpu_torch.ops import dia_cuda
from ellspmv_tpu_torch.ops.csr import csr_spmv, csr_spmv_segment
from ellspmv_tpu_torch.utils.timing import span

def spmv(matrix, x, y=None, backend: str = "auto"):
    """y := A*x + y on the device of `matrix` and `x`, through the
    hand-written kernels of the matrix's format (`backend` ``auto`` or
    ``pallas``) or the plain versions that ``xla`` names."""
    if isinstance(matrix, DiaMatrix):
        return dia_cuda.dia_spmv(matrix, x, y)
    if isinstance(matrix, EllMatrix):
        return bucket_spmv(backend)(matrix, x, y)
    if isinstance(matrix, StreamMatrix):
        return stream_spmv(matrix, x, y)
    if isinstance(matrix, SellMatrix):
        return sell_spmv(matrix, x, y, backend=backend)
    if isinstance(matrix, HybridMatrix):
        return hybrid_spmv(matrix, x, y, backend=backend)
    if isinstance(matrix, CsrMatrix):
        if backend == "xla":
            return csr_spmv_segment(matrix, x, y)
        # the sliced-ELL repack on K1, the JAX package's route on the TPU
        return csr_spmv(matrix, x, y)
    raise TypeError(f"unsupported matrix type {type(matrix)}")


def traceable_spmv(matrix, backend: str = "auto"):
    """Return ``(operand, fn)``: ``fn(operand, x, y=None)`` is `spmv` of
    `matrix` under `backend`, bit for bit, and is safe to capture in a CUDA
    graph (``utils/graphs.py``) that the chained protocol and CG replay.

    What `spmv` does on every call is capturable: it reads nothing back to
    the host, and every allocation's size follows from the shapes. What the
    port does only on the first call is not: the nvcc build and load, K7's
    probe and its host read on the first fp64 call on a card, the CSR's
    sliced-ELL repack on the host (cached on the matrix), the layout
    constants' checks. So before it returns, this makes one call on a zero
    x, on the matrix's device, and waits for it, in the span
    ``dispatch.first_call``. (A `SellMatrix` works out
    `trivial_reassembly` from `order` at construction, and `to` carries
    it.) The operand is the matrix itself: a graph holds the addresses of
    its tensors, so the caller keeps it alive as long as the graph."""
    if not isinstance(matrix, (DiaMatrix, EllMatrix, StreamMatrix,
                               SellMatrix, HybridMatrix, CsrMatrix)):
        raise TypeError(f"no traceable spmv for {type(matrix)}")
    values = matrix.data if isinstance(matrix, DiaMatrix) else matrix.values
    with span("dispatch.first_call"):
        spmv(matrix, torch.zeros(matrix.num_columns, dtype=values.dtype,
                                 device=values.device), None, backend)
        if values.device.type == "cuda":
            torch.cuda.synchronize(values.device)

    def fn(operand, x, y=None):
        return spmv(operand, x, y, backend)

    return matrix, fn
