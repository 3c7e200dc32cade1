"""Sparse matrix containers: COO and ELLPACK, and the span every format's
copy to the card shares."""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch.utils import timing


def tensor_bytes(obj) -> int:
    """Bytes of the arrays a format holds: `obj`'s own where it is a tensor
    or a numpy array, else those of its fields, lists and tuples, all the
    way down."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, np.ndarray):
        return obj.nbytes
    if dataclasses.is_dataclass(obj):
        return sum(tensor_bytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    if isinstance(obj, (list, tuple)):
        return sum(map(tensor_bytes, obj))
    return 0


def upload(device, fmt: str, *held):
    """The span of a copy of format `fmt`'s arrays, those `held` holds, to
    `device`: ``formats.upload`` with their bytes on a card, counted only
    where the span is kept (``utils/timing.py``: inside a set-up entry or a
    recording), and the card waited for before it closes. Nothing on the
    host, where the copy is part of the build, nor inside another upload,
    which the copy is part of."""
    names = timing.open_spans()
    if (names is None or "formats.upload" in names
            or torch.device(device).type == "cpu"):
        return timing.NOTHING
    return _kept_upload(torch.device(device), fmt, tensor_bytes(held))


@contextlib.contextmanager
def _kept_upload(device: torch.device, fmt: str, nbytes: int):
    with timing.span("formats.upload", fmt=fmt, bytes=nbytes):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
