"""One colour of a Gauss-Seidel sweep on a level's colour-major stencil
values: the wrapper of the hand-written CUDA kernel K8
(``csrc/dia_symgs.cu``) and its plain PyTorch version.

K8 has no counterpart in the JAX package. HPCG's multigrid
(``models/multigrid.py``) runs it for every SymGS sweep: the rows of one
colour of an nx×ny×nz grid in natural order, those whose coordinates have
the parities `PARITIES[colour]`, take ``x_i ← (r_i - Σ_{j≠i} a_ij·x_j) /
a_ii`` in place. x and r stay in natural order.

The values come from `ColourMajor`, a copy of the level's DIA values
(``data[k, i]`` multiplies ``x[i + offsets[k]]``) in K8's thread order:
colour c's block ``(num_diags, count_c)``, whose column t is ``data[:,
colour_rows(grid, c)[t]]``, so that consecutive threads read consecutive
values. The eight blocks lie end to end in one buffer of the DIA array's
size; `colour_major` fills it with one gather a colour. The natural-order
DIA array stays beside it, since K2 multiplies it: the copy costs the
level's DIA storage once more (3.62 GB at 256³ in fp64).

The wrapper takes the device from its tensors: on CUDA tensors it launches
the kernel or raises, and on CPU tensors it runs the plain version.
Nothing falls back from one to the other.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math

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


def colour_count(grid, colour: int) -> int:
    """The number of rows of `colour` on the grid."""
    return math.prod((g - p + 1) // 2 for g, p in zip(grid, PARITIES[colour]))


def colour_starts(grid, num_diags: int) -> tuple:
    """Where each colour's block starts in a `ColourMajor` buffer."""
    starts, at = [], 0
    for c in range(8):
        starts.append(at)
        at += num_diags * colour_count(grid, c)
    return tuple(starts)


@dataclasses.dataclass
class ColourMajor:
    """A level's stencil values in colour order: colour c's block, from
    ``values[starts[c]]``, is (num_diags, count_c), and its column t holds
    the DIA column of the colour's row t (`colour_rows`). Slot `diag_slot`
    of `offsets` is the diagonal."""

    values: torch.Tensor
    starts: tuple
    offsets: tuple
    grid: tuple
    diag_slot: int

    @property
    def num_diags(self) -> int:
        return len(self.offsets)

    @property
    def num_rows(self) -> int:
        return math.prod(self.grid)

    def block(self, colour: int) -> torch.Tensor:
        """Colour `colour`'s values, a (num_diags, count) view."""
        count = colour_count(self.grid, colour)
        start = self.starts[colour]
        return self.values[start:start + self.num_diags * count].view(
            self.num_diags, count)


def colour_major(dia: DiaMatrix, grid, diag_slot: int) -> ColourMajor:
    """The colour-major copy of `dia`'s values on the nx×ny×nz `grid`
    (natural order), on dia's device: one gather a colour."""
    grid = tuple(int(g) for g in grid)
    if math.prod(grid) != dia.num_rows:
        raise ValueError(f"colour_major: a {'x'.join(map(str, grid))} grid "
                         f"for a {dia.num_rows}-row matrix")
    values = torch.empty(dia.num_diags * dia.num_rows, dtype=dia.data.dtype,
                         device=dia.device)
    cm = ColourMajor(values, colour_starts(grid, dia.num_diags), dia.offsets,
                     grid, diag_slot)
    for c in range(8):
        torch.index_select(dia.data, 1, colour_rows(grid, c, dia.device),
                           out=cm.block(c))
    return cm


def dia_symgs_torch(cm: ColourMajor, r: torch.Tensor, x: torch.Tensor,
                    colour: int) -> None:
    """The plain PyTorch version: the colour's off-diagonal products of
    every slot at once, their sum, then the division."""
    n = cm.num_rows
    values = cm.block(colour)
    rows = colour_rows(cm.grid, colour, x.device)
    j = rows + torch.tensor(cm.offsets, device=x.device)[:, None]
    inside = (j >= 0) & (j < n)
    inside[cm.diag_slot] = False
    products = values * x[j.clamp(0, n - 1)]
    acc = torch.where(inside, products, 0.0).sum(0)
    x[rows] = (r[rows] - acc) / values[cm.diag_slot]


def _check(cm: ColourMajor, r, x, colour):
    if cm.values.dtype != torch.float64:
        raise TypeError(f"dia_symgs: unsupported value dtype "
                        f"{cm.values.dtype}; the kernel is fp64")
    if not 0 < cm.num_diags <= MAX_DIAGS:
        raise ValueError(f"dia_symgs: {cm.num_diags} diagonals; the kernel "
                         f"takes 1 to {MAX_DIAGS}")
    grid = "x".join(map(str, cm.grid))
    n = cm.num_rows
    if cm.values.numel() != cm.num_diags * n:
        raise ValueError(f"dia_symgs: {cm.values.numel()} values for a {grid} "
                         f"grid of {cm.num_diags} diagonals")
    if tuple(cm.starts) != colour_starts(cm.grid, cm.num_diags):
        raise ValueError(f"dia_symgs: the colours' starts {cm.starts} are not "
                         f"those of a {grid} grid")
    if not 0 <= colour < 8:
        raise ValueError(f"dia_symgs: colour {colour} is not in 0..7")
    if not (0 <= cm.diag_slot < cm.num_diags
            and cm.offsets[cm.diag_slot] == 0):
        raise ValueError(f"dia_symgs: slot {cm.diag_slot} is not the "
                         "diagonal")
    if r.data_ptr() == x.data_ptr():
        raise ValueError("dia_symgs: r and x are one buffer")
    ell_cuda.check_tensors("dia_symgs", cm.values.device, [
        ("values", cm.values, (cm.num_diags * n,), torch.float64),
        ("r", r, (n,), torch.float64), ("x", x, (n,), torch.float64)])


def dia_symgs(cm: ColourMajor, r: torch.Tensor, x: torch.Tensor,
              colour: int) -> None:
    """Update x in place on the rows of `colour` of cm's grid (natural
    order), from `r` and the colour-major values `cm`. x, r and the values
    share one device; fp64."""
    global launches
    _check(cm, r, x, colour)
    if x.device.type == "cpu":
        return dia_symgs_torch(cm, r, x, colour)
    if x.device.type != "cuda":
        raise ValueError(f"dia_symgs: no kernel for tensors on {x.device}")
    if not ell_cuda.fma_contraction_available(x.device):
        raise RuntimeError(
            f"dia_symgs: the fused multiply-add on {x.device} does not round "
            "once (fma_probe disagrees with the exact residual)")
    fn, error_string = _build.entry("dia_symgs_f64", _ARGS)
    offsets = (ctypes.c_int64 * cm.num_diags)(*cm.offsets)
    err = fn(cm.block(colour).data_ptr(), r.data_ptr(), x.data_ptr(),
             *cm.grid, *PARITIES[colour], cm.num_diags, cm.diag_slot,
             offsets, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dia_symgs kernel launch failed: "
                           f"{error_string(err).decode()} (error {err})")
    launches += 1
