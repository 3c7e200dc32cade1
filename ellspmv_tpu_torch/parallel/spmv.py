"""Row-sharded SpMV over ranks: A row-sharded, x allgathered before each
multiply, y kept sharded.

Counterpart of ``ellspmv_tpu.parallel.spmv``, with its three row
partitions (SURVEY §2.4), their boundaries and error texts:

- ``partition='rows'``: equal row blocks (csrspmv.c:2834-2837);
- ``partition='nonzeros'``: boundaries that give each rank about equal
  nonzeros (csrgemvnz's intent, csrspmv.c:1681-1761), rows kept whole;
- ``rows_per_device=[N, ...]``: explicit row counts (csrgemvrp,
  ``--rows-per-thread``, csrspmv.c:2022-2053).

The parent (``launch.RankPool``'s caller) cuts the matrix into one `Shard`
per rank, on the host; each rank moves its shard to its device and runs
`sharded_spmv`: the allgather of x, then the rank's local kernels on its
rows, which are the one-device kernels (K1 for ELL; ``ops/csr.csr_spmv``,
the SELL repack on K1, for CSR).

The layout (the JAX package's ``x_layout="physical"``, kept for every
matrix): every rank's y block has `block` rows, its own rows first and
zeros after, because a collective needs equal sizes. x is split into
blocks of `x_block` entries the same way, and the allgathered x is the
blocks side by side, padding and all. On a square matrix x's blocks are
y's (`x_block` = `block`), so a rank's y block is its x block for the next
multiply (the chained protocol, CG); on a rectangular one x's blocks are
equal chunks of its entries. Each shard's columns are remapped once, on
the host, into that gathered layout, so no call unpads x.

Each row is summed whole on one rank, in the order of its slots, so the
sharded y equals the one-device port's bit for bit. The split diagonal
keeps that order: an ELL shard carries it as the last slot of each row (K1
adds the diagonal after the slots with one fused multiply-add, and so does
a last slot); CSR and stream shards add it after their kernels, against
the rank's own x entries, as the one-device path does.
"""

from __future__ import annotations

import dataclasses
import time
import uuid

import numpy as np
import torch

from ellspmv_tpu_torch.formats.csr import CsrMatrix
from ellspmv_tpu_torch.formats.ell import (ROW_TILE, EllMatrix,
                                          ell_from_row_major)
from ellspmv_tpu_torch.formats.stream import StreamMatrix
from ellspmv_tpu_torch.parallel.launch import Rank, RankPool, kernel_launches


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def boundaries_from_counts(row_counts: np.ndarray, n_dev: int,
                           partition: str = "rows",
                           rows_per_device=None) -> np.ndarray:
    """Row-block boundaries (n_dev + 1,) over the rows, given each row's
    nonzeros (used by the nonzeros partition only), with the JAX package's
    rule (``_partition_boundaries``, ``parallel/spmv.py:40-68``) and its
    error texts."""
    n = len(row_counts)
    if rows_per_device is not None:
        if len(rows_per_device) != n_dev:
            raise ValueError(f"rows-per-device list has "
                             f"{len(rows_per_device)} entries for {n_dev} "
                             "devices")
        if sum(rows_per_device) != n:
            # same check as csrspmv.c:2041-2053
            raise ValueError(f"rows-per-device sums to "
                             f"{sum(rows_per_device)}, expected {n}")
        return np.concatenate([[0], np.cumsum(rows_per_device)]).astype(
            np.int64)
    if partition == "nonzeros":
        # the precomputed variant of csrgemvnz's startrow scan
        # (csrspmv.c:2054-2071): the row-count prefix sum, cut at equal
        # shares
        rowptr = np.concatenate([[0], np.cumsum(row_counts, dtype=np.int64)])
        targets = (np.arange(1, n_dev) * rowptr[-1]) // n_dev
        inner = np.searchsorted(rowptr, targets, side="left")
        return np.concatenate([[0], inner, [n]]).astype(np.int64)
    b = -(-n // n_dev)
    return np.minimum(np.arange(n_dev + 1) * b, n).astype(np.int64)


def row_nonzeros(mat) -> np.ndarray:
    """Each row's nonzeros as the JAX package counts them for the nonzeros
    partition: a CSR's stored entries (its rowptr), an ELL's stored values
    that are not zero (the split diagonal not counted)."""
    if isinstance(mat, CsrMatrix):
        return np.diff(mat.rowptr.cpu().numpy().astype(np.int64))
    if isinstance(mat, EllMatrix):
        return (mat.values[:, :mat.num_rows] != 0).sum(0).cpu().numpy()
    raise TypeError(f"unsupported matrix type {type(mat)}")


def partition_boundaries(mat, n_dev: int, partition: str = "rows",
                         rows_per_device=None) -> np.ndarray:
    """Row-block boundaries (n_dev + 1,) of an ELL or CSR matrix, equal to
    the JAX package's ``_partition_boundaries`` on the same matrix."""
    return boundaries_from_counts(row_nonzeros(mat), n_dev, partition,
                                  rows_per_device)


@dataclasses.dataclass
class Shard:
    """One rank's rows of a row-sharded matrix, in the gathered x layout.

    `matrix` has `block` rows, this rank's own first (the rest are empty),
    and ``ranks * x_block`` columns. `diag` is the split diagonal of
    the first ``len(diag)`` rows for CSR and stream shards (None
    otherwise), multiplied against the gathered x from position
    `diag_x`. `key` names the shard, so that a rank keeps it on its device
    across tasks (`placed`)."""

    matrix: EllMatrix | CsrMatrix | StreamMatrix
    block: int
    x_block: int
    diag: torch.Tensor | None = None
    diag_x: int = 0
    key: str = dataclasses.field(default_factory=lambda: uuid.uuid4().hex)

    def to(self, device) -> "Shard":
        return dataclasses.replace(
            self, matrix=self.matrix.to(device),
            diag=None if self.diag is None else self.diag.to(device))


def placed(rank: Rank, shard: Shard) -> Shard:
    """`shard` on the rank's device, moved once for consecutive tasks on
    it."""
    return rank.keep(shard.key, lambda: shard.to(rank.device))


@dataclasses.dataclass
class ShardedMatrix:
    """A matrix cut into one `Shard` per rank, on the host, with the row
    boundaries and the maps between the logical vectors and the ranks'
    blocks. `unpermute` is each logical row's position in the ranks' y
    blocks side by side; `nonzeros_per_device` is what the workload report
    counts."""

    shards: list[Shard]
    boundaries: np.ndarray
    x_boundaries: np.ndarray
    block: int
    x_block: int
    num_rows: int
    num_columns: int
    num_nonzeros: int
    nonzeros_per_device: np.ndarray
    dtype: torch.dtype
    unpermute: np.ndarray

    @property
    def world(self) -> int:
        return len(self.shards)

    def workload_report(self) -> list[str]:
        """The per-device rows and nonzeros table, the ``-vv`` workload
        report (csrspmv.c:2289-2338), in the JAX package's format."""
        lines = ["device  rows       nonzeros"]
        rows_per = np.diff(self.boundaries)
        for d in range(self.world):
            lines.append(f"{d:<7d} {rows_per[d]:<10d} "
                         f"{int(self.nonzeros_per_device[d])}")
        return lines

    def split_x(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x (logical, on the host) as the ranks' x blocks, zero-padded."""
        return _split(x, self.x_boundaries, self.x_block, self.dtype)

    def split_y(self, y: torch.Tensor | None) -> list:
        """y (logical, on the host) as the ranks' y blocks; None stays
        None for every rank."""
        if y is None:
            return [None] * self.world
        return _split(y, self.boundaries, self.block, self.dtype)

    def join_y(self, blocks: list[np.ndarray]) -> torch.Tensor:
        """The logical vector from the ranks' y blocks (fp64 NumPy, as the
        tasks return them), in the values' type, on the host."""
        return torch.from_numpy(np.concatenate(blocks)[self.unpermute]).to(
            self.dtype)


def _split(v: torch.Tensor, bounds: np.ndarray, block: int,
           dtype: torch.dtype) -> list[torch.Tensor]:
    v = v.to("cpu", dtype)
    out = []
    for d in range(len(bounds) - 1):
        blk = torch.zeros(block, dtype=dtype)
        blk[:bounds[d + 1] - bounds[d]] = v[bounds[d]:bounds[d + 1]]
        out.append(blk)
    return out


def positions(bounds: np.ndarray, block: int) -> np.ndarray:
    """Each entry's place in the ranks' blocks of `block` side by side,
    rank d holding entries ``bounds[d]:bounds[d + 1]`` at the head of its
    block: the map from a logical vector to the blocks (``unpermute`` for
    y)."""
    out = np.empty(bounds[-1], np.int64)
    for d in range(len(bounds) - 1):
        out[bounds[d]:bounds[d + 1]] = d * block + np.arange(
            bounds[d + 1] - bounds[d])
    return out


def x_layout(n: int, m: int, bounds: np.ndarray, block: int):
    """The gathered x layout: ``(x_boundaries, x_block, position)``, where
    position[c] is column c's place in the gathered x. A square matrix's x
    is split by its row boundaries into blocks of `block`; a rectangular
    one's into equal chunks."""
    n_dev = len(bounds) - 1
    if n == m:
        xb, x_block = bounds, block
    else:
        x_block = max(-(-m // n_dev), 1)
        xb = np.minimum(np.arange(n_dev + 1) * x_block, m).astype(np.int64)
    return xb, x_block, positions(xb, x_block)


def _block_rows(bounds: np.ndarray) -> int:
    return max(_round_up(int(np.diff(bounds).max()), ROW_TILE), ROW_TILE)


def _host_values(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as NumPy: bfloat16 widened to float32 (exact), so
    that the shard narrows them back to the same bits."""
    t = t.cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _ell_shards(mat: EllMatrix, bounds, block, x_block, position):
    n_dev = len(bounds) - 1
    m, s = mat.num_columns, mat.rowsize
    cols = mat.colidx.cpu().numpy()
    vals = _host_values(mat.values)
    diag = None if mat.diag is None else _host_values(mat.diag)
    width = s + (diag is not None)
    x_len = n_dev * x_block
    shards, nnz = [], []
    for d in range(n_dev):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        rows = hi - lo
        # x of row g, clamped to the last column, as K1 reads the diagonal
        # and as the one-device matrix pads
        own = position[np.minimum(np.arange(lo, lo + block), max(m - 1, 0))] \
            if m else np.zeros(block, np.int64)
        c = np.broadcast_to(own[:, None], (block, width)).copy()
        v = np.zeros((block, width), vals.dtype)
        c[:rows, :s] = position[cols[:, lo:hi].T] if m else 0
        v[:rows, :s] = vals[:, lo:hi].T
        if diag is not None:
            v[:rows, s] = diag[lo:hi]
        nnz.append(int((vals[:, lo:hi] != 0).sum()))
        local = ell_from_row_major(c.astype(cols.dtype), v, None, block,
                                   x_len, nnz[-1], mat.values.dtype, "cpu")
        shards.append(Shard(local, block, x_block))
    return shards, np.array(nnz, np.int64)


def _csr_shards(mat: CsrMatrix, bounds, block, x_block, position):
    n_dev = len(bounds) - 1
    rowptr = mat.rowptr.cpu().numpy().astype(np.int64)
    idx_dt = mat.rowptr.cpu().numpy().dtype
    colidx = mat.colidx.cpu().numpy()
    rowids = mat.rowids.cpu().numpy()
    values = mat.values.cpu()
    x_len = n_dev * x_block
    shards = []
    for d in range(n_dev):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        e_lo, e_hi = int(rowptr[lo]), int(rowptr[hi])
        lrp = np.full(block + 1, e_hi - e_lo, np.int64)
        lrp[:hi - lo + 1] = rowptr[lo:hi + 1] - e_lo
        local = CsrMatrix(
            rowptr=torch.from_numpy(lrp.astype(idx_dt)),
            colidx=torch.from_numpy(position[colidx[e_lo:e_hi]].astype(
                colidx.dtype)),
            values=values[e_lo:e_hi].clone(),
            rowids=torch.from_numpy((rowids[e_lo:e_hi] - lo).astype(
                rowids.dtype)),
            diag=None, num_rows=block, num_columns=x_len,
            num_nonzeros=e_hi - e_lo)
        diag = None
        if mat.diag is not None:     # split on square matrices only
            diag = mat.diag.cpu()[lo:hi].clone()
        shards.append(Shard(local, block, x_block, diag,
                            int(position[lo]) if diag is not None and hi > lo
                            else 0))
    return shards, np.diff(rowptr[bounds])


def shard_matrix(mat, n_devices: int, partition: str = "rows",
                 rows_per_device=None) -> ShardedMatrix:
    """Cut an `EllMatrix` or `CsrMatrix` (on any device; the shards are
    built on the host) into `n_devices` row shards under the partition.
    Other formats raise TypeError, as the JAX package's ``shard_matrix``
    does; a bad ``rows_per_device`` list raises its ValueError."""
    if not isinstance(mat, (EllMatrix, CsrMatrix)):
        raise TypeError(f"unsupported matrix type {type(mat)}")
    bounds = partition_boundaries(mat, n_devices, partition, rows_per_device)
    block = _block_rows(bounds)
    n, m = mat.num_rows, mat.num_columns
    xb, x_block, position = x_layout(n, m, bounds, block)
    build = _ell_shards if isinstance(mat, EllMatrix) else _csr_shards
    shards, nnz = build(mat, bounds, block, x_block, position)
    return ShardedMatrix(shards, bounds, xb, block, x_block, n, m,
                         mat.num_nonzeros, nnz, mat.values.dtype,
                         positions(bounds, block))


# -- in a rank --------------------------------------------------------------

def allgather(x_block: torch.Tensor) -> torch.Tensor:
    """Every rank's x block side by side, on this rank's device: NCCL
    gathers into one tensor; gloo into the blocks' views of it."""
    import torch.distributed as dist
    world = dist.get_world_size()
    out = x_block.new_empty(world * x_block.shape[0])
    if dist.get_backend() == "nccl":
        dist.all_gather_into_tensor(out, x_block)
    else:
        dist.all_gather(list(out.view(world, -1).unbind(0)), x_block)
    return out


def max_over_ranks(values: list[float]) -> list[float]:
    """Each value's maximum over the ranks (an all_reduce)."""
    import torch.distributed as dist
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else "cpu")
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def collectives_task(rank: Rank, length: int = 8, rounds: int = 1) -> dict:
    """A task: the group's collectives on this rank's device, `rounds`
    times: the allgather of x blocks of `length` entries (each rank's
    holding its rank) and an all_reduce of the ranks. Returns whether every
    gathered block held its rank, and the reduced sum."""
    import torch.distributed as dist
    x = torch.full((length,), float(rank.rank), dtype=torch.float64,
                   device=rank.device)
    ok, total = True, 0.0
    for _ in range(rounds):
        got = allgather(x).view(rank.world, length).cpu()
        want = torch.arange(rank.world, dtype=torch.float64)[:, None]
        ok = ok and bool((got == want).all())
        s = torch.full((1,), float(rank.rank), dtype=torch.float64,
                       device=rank.device)
        dist.all_reduce(s)
        total = float(s)
    return {"gathered": ok, "reduced": total}


def _own_diagonal(shard: Shard, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Add a CSR or stream shard's split diagonal against the rank's own x
    entries, in place, as the one-device path adds it."""
    if shard.diag is None:
        return out
    k = shard.diag.shape[0]
    xs = x[shard.diag_x:shard.diag_x + k].to(out.dtype)
    if isinstance(shard.matrix, StreamMatrix):
        out[:k] = torch.addcmul(out[:k], shard.diag, xs)
    else:
        out[:k] += shard.diag * xs
    return out


def local_spmv(shard: Shard, x: torch.Tensor, y: torch.Tensor | None = None,
               backend: str = "auto") -> torch.Tensor:
    """The rank's rows of A*x + y from the gathered x: K1 on an ELL shard,
    the CSR path on a CSR shard (its SELL repack on K1), the stream
    pipeline on a stream shard, each then the split diagonal and y in the
    one-device order; ``backend="xla"`` runs the ELL and CSR plain
    versions on the device, as the one-device program does."""
    from ellspmv_tpu_torch.formats.sell import sell_spmv
    from ellspmv_tpu_torch.formats.stream import stream_spmv
    from ellspmv_tpu_torch.ops import ell_cuda
    from ellspmv_tpu_torch.ops.csr import csr_spmv_segment, to_sell

    mat = shard.matrix
    if isinstance(mat, EllMatrix):
        fn = ell_cuda.ell_spmv_torch if backend == "xla" else \
            ell_cuda.ell_spmv
        return fn(mat, x, y)
    if isinstance(mat, CsrMatrix):
        x = x.to(mat.values.dtype)
        if backend == "xla":
            return _own_diagonal(shard, x, csr_spmv_segment(mat, x, y))
        out = _own_diagonal(shard, x, sell_spmv(to_sell(mat), x))
        return out if y is None else out + y.to(out.dtype)
    out = _own_diagonal(shard, x, stream_spmv(mat, x))
    return out if y is None else out + y.to(out.dtype)


def sharded_spmv(shard: Shard, x_block: torch.Tensor,
                 y_block: torch.Tensor | None = None,
                 backend: str = "auto") -> torch.Tensor:
    """In a rank: allgather x, then `local_spmv`. Returns this rank's y
    block (`block` entries, its own rows first)."""
    return local_spmv(shard, allgather(x_block), y_block, backend)


def spmv_task(rank: Rank, shard: Shard, x_block, y_block,
              backend: str = "auto") -> dict:
    """A task: one `sharded_spmv` on this rank's device; its y block (fp64
    NumPy, exact for every value type) and the kernels' launches."""
    shard = placed(rank, shard)
    y = None if y_block is None else y_block.to(rank.device)
    before = kernel_launches()
    out = sharded_spmv(shard, x_block.to(rank.device), y, backend)
    after = kernel_launches()
    return {"y": out.double().cpu().numpy(),
            "launches": {k: after[k] - before[k] for k in after}}


def gather_seconds_task(rank: Rank, x_block, calls: int = 20) -> float:
    """A task: seconds per allgather of x blocks like `x_block`, averaged
    over `calls` after a barrier (CUDA events on a card), the most of any
    rank."""
    import torch.distributed as dist
    x = x_block.to(rank.device)
    for _ in range(3):
        allgather(x)
    dist.barrier()
    if rank.device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            allgather(x)
        end.record()
        torch.cuda.synchronize(rank.device)
        seconds = start.elapsed_time(end) * 1e-3 / calls
    else:
        t0 = time.perf_counter()
        for _ in range(calls):
            allgather(x)
        seconds = (time.perf_counter() - t0) / calls
    return max_over_ranks([seconds])[0]


def run_spmv(pool: RankPool, sm: ShardedMatrix, x: torch.Tensor,
             y: torch.Tensor | None = None, backend: str = "auto",
             launches: list | None = None) -> torch.Tensor:
    """y := A*x + y over the pool's ranks, one `sharded_spmv` each: the
    logical y on the host, in the values' type. Appends each rank's kernel
    launches to `launches` when given."""
    xs, ys = sm.split_x(x), sm.split_y(y)
    outs = pool.run(spmv_task, [(sm.shards[r], xs[r], ys[r], backend)
                                for r in range(sm.world)])
    if launches is not None:
        launches.extend(o["launches"] for o in outs)
    return sm.join_y([o["y"] for o in outs])
