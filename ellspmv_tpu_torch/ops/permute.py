"""Static permutation of a stream: the host plan (`gather_from_targets`), the
wrapper of the hand-written CUDA gather kernel (``csrc/permute.cu``) and its
plain PyTorch version.

Counterpart of ``ellspmv_tpu.ops.permute``: ``build_permute`` with
``apply_permute`` (the W1 kernel, the XLA row take and the W2 kernel, K4)
and ``build_permute_cells`` (the uniform-cell W1/W2 pair, K5). Both compute
one static permutation, ``out[target[k]] = in[k]``. The TPU has no sublane
gather, so the JAX package builds that permutation from lane gathers and
transposes, with edge colourings and half-block budgets planned on the host.
The card has a gather, so the port composes the inverse map on the host,
``src[target[k]] = k``, and moves each output with one read:
``out[j] = in[src[j]]``, and 0 where no input lands (``src[j] = -1``; the
JAX route leaves those positions unspecified). With no budget to meet, the
layouts that fed it (the megablock reorder, the cells quota deal) are not
needed either.

The wrapper takes the device from its tensors: on CUDA tensors it launches
the kernel or raises, and on CPU tensors it runs the plain version. Nothing
falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ellspmv_tpu_torch.ops import _build
from ellspmv_tpu_torch.ops.ell_cuda import check_tensors

#: Kernel launches made by `apply_permute` in this process.
launches = 0

# Elements per block of the JAX router (128 x 128); the stream format pads
# its product stream to a multiple of it, as the JAX package does.
BLOCK = 128 * 128

_VALUE_TAGS = {torch.float64: "f64", torch.float32: "f32"}
_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) + (ctypes.c_void_p,)


def gather_from_targets(target: np.ndarray, n_out: int,
                        validate: bool = True) -> np.ndarray:
    """The gather map of the permutation ``out[target[k]] = in[k]``
    (``target[k] < 0``: element k is dropped): an int32 array `src` of
    length `n_out` with ``src[target[k]] = k``, and -1 where no element
    lands.

    Real targets must be distinct positions in [0, n_out), as for
    ``ellspmv_tpu.ops.permute.build_permute``; distinctness is checked
    unless `validate` is False (callers whose targets are distinct by
    construction)."""
    target = np.asarray(target, np.int64)
    if len(target) > np.iinfo(np.int32).max:
        raise ValueError("permutation input exceeds int32 positions")
    k = np.flatnonzero(target >= 0)
    tr = target[k]
    if len(tr):
        if tr.max() >= n_out:
            raise ValueError(
                "targets must be distinct positions in [0, n_out)")
        if validate:
            seen = np.zeros(n_out, bool)
            seen[tr] = True
            if int(seen.sum()) != len(tr):
                raise ValueError(
                    "targets must be distinct positions in [0, n_out)")
    src = np.full(n_out, -1, np.int32)
    src[tr] = k
    return src


def apply_permute_torch(src: torch.Tensor,
                        payload: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: ``payload[src]`` with 0 where src < 0."""
    padded = torch.cat([payload.new_zeros(1), payload])
    return padded[src.long() + 1]


def _check(src: torch.Tensor, payload: torch.Tensor):
    if payload.dtype not in _VALUE_TAGS:
        raise TypeError(f"apply_permute: unsupported payload dtype "
                        f"{payload.dtype}")
    if src.dim() != 1 or payload.dim() != 1:
        raise ValueError("apply_permute: src and payload must be vectors")
    check_tensors("apply_permute", src.device,
                  [("src", src, tuple(src.shape), torch.int32),
                   ("payload", payload, tuple(payload.shape),
                    payload.dtype)])


def apply_permute(src: torch.Tensor, payload: torch.Tensor) -> torch.Tensor:
    """``out[j] = payload[src[j]]`` (0 where ``src[j] < 0``), a new vector of
    src's length in the payload's type (float64 or float32). Every src entry
    must index inside the payload: `gather_from_targets` builds such maps,
    and the caller checks the payload's length against its plan."""
    global launches
    _check(src, payload)
    if src.device.type == "cpu":
        return apply_permute_torch(src, payload)
    if src.device.type != "cuda":
        raise ValueError(f"apply_permute: no kernel for tensors on "
                         f"{src.device}")
    out = torch.empty(src.shape[0], dtype=payload.dtype, device=src.device)
    if src.shape[0] == 0:
        return out
    fn, error_string = _build.entry(
        f"permute_{_VALUE_TAGS[payload.dtype]}", _ARGS)
    err = fn(src.data_ptr(), payload.data_ptr(), out.data_ptr(),
             src.shape[0], torch.cuda.current_stream(src.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"apply_permute kernel launch failed: "
                           f"{error_string(err).decode()} (error {err})")
    launches += 1
    return out
