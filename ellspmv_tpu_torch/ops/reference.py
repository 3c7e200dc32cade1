"""Host-side NumPy oracles in exact IEEE fp64, for tests and the smoke run:
the cross-implementation check the reference performs by diffing
ellspmv/csrspmv stdout (SURVEY §4)."""

from __future__ import annotations

import numpy as np


def coo_spmv_numpy(coo, x: np.ndarray, y: np.ndarray | None = None
                   ) -> np.ndarray:
    """y := A*x + y on the expanded COO triplets."""
    coo = coo.expand_symmetry()
    out = np.zeros(coo.num_rows, np.float64) if y is None \
        else np.asarray(y, np.float64).copy()
    np.add.at(out, coo.rowidx,
              coo.values.astype(np.float64) * x.astype(np.float64)[coo.colidx])
    return out


def ell_spmv_numpy(ell, x: np.ndarray, y: np.ndarray | None = None
                   ) -> np.ndarray:
    """ellgemv/ellgemvsd semantics (ellspmv.c:1129-1180) on the port's
    slot-major EllMatrix, whatever device its tensors lie on (a sliced one
    laid back into the padded layout)."""
    ell = ell.padded()
    n = ell.num_rows
    colidx = ell.colidx[:, :n].cpu().numpy()
    vals = ell.values[:, :n].cpu().double().numpy()
    xx = np.asarray(x, np.float64)
    out = np.zeros(n, np.float64) if y is None \
        else np.asarray(y, np.float64).copy()
    if ell.rowsize:
        out += (vals * xx[colidx]).sum(axis=0)
    if ell.diag is not None:
        d = ell.diag[:n].cpu().double().numpy()
        k = min(n, len(xx))
        out[:k] += d[:k] * xx[:k]
    return out
