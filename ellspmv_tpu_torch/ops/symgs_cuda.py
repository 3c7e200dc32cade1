"""One colour of a Gauss-Seidel sweep on DIA storage: the wrapper of the
hand-written CUDA kernel K8 (``csrc/dia_symgs.cu``) and its plain PyTorch
version.

K8 has no counterpart in the JAX package. HPCG's multigrid
(``models/multigrid.py``) runs it for every SymGS sweep: the rows of one
colour of an nx×ny×nz grid in natural order, those whose coordinates have
the parities `PARITIES[colour]`, take ``x_i ← (r_i - Σ_{j≠i} a_ij·x_j) /
a_ii`` in place, from the level's one DIA matrix (``data[k, i]``
multiplies ``x[i + offsets[k]]``), whose slot `diag_slot` holds the
diagonal. The wrapper takes the device from its tensors: on CUDA tensors it
launches the kernel or raises, and on CPU tensors it runs the plain
version. Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.ops import _build, ell_cuda

#: Kernel launches made by `dia_symgs` in this process: one a colour.
launches = 0
#: The most diagonals the kernel takes (its offsets travel by value).
MAX_DIAGS = 64
#: Colour c's parities (px, py, pz) of (ix, iy, iz): colour 7 is the
#: points whose coordinates are all even, the coarse grid's points.
PARITIES = tuple((1 - (c & 1), 1 - (c >> 1 & 1), 1 - (c >> 2 & 1))
                 for c in range(8))

_ARGS = (ctypes.c_void_p,) * 3 + (ctypes.c_int64,) * 8 \
    + (ctypes.POINTER(ctypes.c_int64), ctypes.c_void_p)


def colour_of(grid, device="cpu") -> torch.Tensor:
    """Each row's colour on the nx×ny×nz `grid`, int64."""
    nx, ny, nz = grid
    i = torch.arange(nx * ny * nz, device=device)
    ix, iy, iz = i % nx, (i // nx) % ny, i // (nx * ny)
    return (1 - ix % 2) + 2 * (1 - iy % 2) + 4 * (1 - iz % 2)


def colour_rows(grid, colour: int, device="cpu") -> torch.Tensor:
    """The rows of `colour`, in the order of K8's threads."""
    nx, ny, nz = grid
    px, py, pz = PARITIES[colour]
    ix = torch.arange(px, nx, 2, device=device)
    iy = torch.arange(py, ny, 2, device=device)
    iz = torch.arange(pz, nz, 2, device=device)
    return ((iz[:, None, None] * ny + iy[None, :, None]) * nx
            + ix[None, None, :]).flatten()


def dia_symgs_torch(dia: DiaMatrix, r: torch.Tensor, x: torch.Tensor, grid,
                    colour: int, diag_slot: int) -> None:
    """The plain PyTorch version: the colour's off-diagonal products of
    every slot at once, their sum, then the division."""
    n = dia.num_rows
    rows = colour_rows(grid, colour, x.device)
    j = rows + torch.tensor(dia.offsets, device=x.device)[:, None]
    inside = (j >= 0) & (j < n)
    inside[diag_slot] = False
    products = dia.data[:, rows] * x[j.clamp(0, n - 1)]
    acc = torch.where(inside, products, 0.0).sum(0)
    x[rows] = (r[rows] - acc) / dia.data[diag_slot, rows]


def _check(dia: DiaMatrix, r, x, grid, colour, diag_slot):
    if dia.data.dtype != torch.float64:
        raise TypeError(f"dia_symgs: unsupported value dtype "
                        f"{dia.data.dtype}; the kernel is fp64")
    nx, ny, nz = grid
    n = dia.num_rows
    if nx * ny * nz != n or dia.num_columns != n:
        raise ValueError(f"dia_symgs: a {nx}x{ny}x{nz} grid for a "
                         f"{n}x{dia.num_columns} matrix")
    if not 0 < dia.num_diags <= MAX_DIAGS:
        raise ValueError(f"dia_symgs: {dia.num_diags} diagonals; the kernel "
                         f"takes 1 to {MAX_DIAGS}")
    if not 0 <= colour < 8:
        raise ValueError(f"dia_symgs: colour {colour} is not in 0..7")
    if not (0 <= diag_slot < dia.num_diags
            and dia.offsets[diag_slot] == 0):
        raise ValueError(f"dia_symgs: slot {diag_slot} is not the diagonal")
    if r.data_ptr() == x.data_ptr():
        raise ValueError("dia_symgs: r and x are one buffer")
    ell_cuda.check_tensors("dia_symgs", dia.data.device, [
        ("data", dia.data, (dia.num_diags, n), torch.float64),
        ("r", r, (n,), torch.float64), ("x", x, (n,), torch.float64)])


def dia_symgs(dia: DiaMatrix, r: torch.Tensor, x: torch.Tensor, grid,
              colour: int, diag_slot: int) -> None:
    """Update x in place on the rows of `colour` of the nx×ny×nz `grid`
    (natural order), from `r` and the matrix `dia`, whose slot `diag_slot`
    is the diagonal. x, r and the matrix share one device; fp64."""
    global launches
    _check(dia, r, x, grid, colour, diag_slot)
    if x.device.type == "cpu":
        return dia_symgs_torch(dia, r, x, grid, colour, diag_slot)
    if x.device.type != "cuda":
        raise ValueError(f"dia_symgs: no kernel for tensors on {x.device}")
    if not ell_cuda.fma_contraction_available(x.device):
        raise RuntimeError(
            f"dia_symgs: the fused multiply-add on {x.device} does not round "
            "once (fma_probe disagrees with the exact residual)")
    fn, error_string = _build.entry("dia_symgs_f64", _ARGS)
    offsets = (ctypes.c_int64 * dia.num_diags)(*dia.offsets)
    err = fn(dia.data.data_ptr(), r.data_ptr(), x.data_ptr(), *grid,
             *PARITIES[colour], dia.num_diags, diag_slot, offsets,
             torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dia_symgs kernel launch failed: "
                           f"{error_string(err).decode()} (error {err})")
    launches += 1
