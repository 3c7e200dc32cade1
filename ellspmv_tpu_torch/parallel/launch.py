"""The ranks: spawned processes, each in the process group, that run tasks
sent by the process that started them.

The JAX package runs one program over its mesh from one controller, so it
has no counterpart of this module. Here the calling process (the parent)
does the host work once (reading the file, converting it, the row
boundaries, the shards) and starts one process per rank with the
``spawn`` method, never ``fork``, since the parent may have touched CUDA.
Each rank joins the group (``mesh.init_group``) and then runs the tasks it
is sent, in order, until the pool is closed:

    with RankPool(["cpu"] * 4) as pool:
        ys = pool.run(task, [(shard_0, x_0), (shard_1, x_1), ...])

A task is a function of this package, taken by its qualified name (spawn
pickles functions by reference), called in rank r as ``task(rank, *args_r)``
where `rank` is a `Rank`. Its arguments travel through
``torch.multiprocessing``, which hands CPU tensors over in shared memory;
its result comes back pickled. A pool serves many tasks, so a test module
pays for its ranks once.

Nothing hangs and nothing is retried: a rank that raises, dies, or does
not finish by the deadline `run` was given (none by default) makes `run`
raise `RankFailure` with the rank's traceback, after the pool has stopped
every rank (the others may be waiting in a collective for it). A rank left
waiting in a collective raises there once the group's timeout has passed,
so a task of any length runs to its end while a stuck one fails. The pool
is then closed for good.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable

import torch

from ellspmv_tpu_torch.parallel.mesh import (GROUP_TIMEOUT, backend_for,
                                             destroy_group, init_group)


class RankFailure(RuntimeError):
    """A rank raised, died or ran out of time."""


@dataclasses.dataclass(frozen=True)
class Rank:
    """What a task knows of the rank it runs in, and the one object it
    keeps on its device from task to task (`keep`)."""
    rank: int
    world: int
    device: torch.device
    backend: str
    kept: dict = dataclasses.field(default_factory=dict)

    def keep(self, key: str, make: Callable):
        """`make()`'s result, made once while consecutive tasks ask for the
        same `key` (a shard on the device, and what its kernels cache on
        it, such as a CSR's SELL repack); a new key drops the old one."""
        if self.kept.get("key") != key:
            self.kept.clear()
            self.kept.update(key=key, value=make())
        return self.kept["value"]


def kernel_launches() -> dict[str, int]:
    """The launch counts of every kernel wrapper in this process."""
    from ellspmv_tpu_torch.ops import (dia_cuda, dot_cuda, ell_cuda, permute,
                                       stream_sum)
    return {"ell_spmv": ell_cuda.launches, "dia_spmv": dia_cuda.launches,
            "fma_probe": ell_cuda.probe_launches, "dot": dot_cuda.launches,
            "permute": permute.launches, "stream_sum": stream_sum.launches,
            "stream_sum_src": stream_sum.src_launches}


def loaded_modules(rank: Rank) -> list[str]:
    """A task: the names of the modules loaded in this rank's process."""
    import sys
    return sorted(sys.modules)


def _rank_main(rank: int, devices: list[str], store_path: str,
               timeout: float, tasks, results) -> None:
    try:
        device = init_group(rank, devices, store_path, timeout)
        me = Rank(rank, len(devices), device, backend_for(devices))
    except BaseException:
        results.put((rank, -1, False, traceback.format_exc()))
        return
    try:
        while True:
            item = tasks.get()
            if item is None:
                break
            task_id, fn, args = item
            try:
                out = fn(me, *args)
                pickle.dumps(out)       # fail here, not in the queue's thread
                results.put((rank, task_id, True, out))
            except Exception:
                results.put((rank, task_id, False, traceback.format_exc()))
    finally:
        destroy_group()


class RankPool:
    """One spawned process per entry of `devices` (``"cpu"``, ``"cuda:0"``,
    ...), joined in one process group; `timeout` bounds each collective
    inside the ranks."""

    def __init__(self, devices: list[str], timeout: float = GROUP_TIMEOUT):
        import torch.multiprocessing as mp

        self.devices = list(devices)
        self.backend = backend_for(self.devices)
        self._dir = tempfile.mkdtemp(prefix="ellspmv-ranks-")
        ctx = mp.get_context("spawn")
        self._results = ctx.Queue()
        self._tasks = [ctx.SimpleQueue() for _ in self.devices]
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, self.devices,
                              os.path.join(self._dir, "store"), timeout,
                              self._tasks[r], self._results))
            for r in range(len(self.devices))]
        self._next_task = 0
        self._closed = False
        for p in self._procs:
            p.start()

    @property
    def world(self) -> int:
        return len(self.devices)

    def run(self, fn: Callable, args: list[tuple],
            timeout: float | None = None) -> list:
        """Run ``fn(rank, *args[r])`` in every rank r and return the results
        in rank order. Raises `RankFailure` (and closes the pool) when a
        rank raises or dies, or, where `timeout` is given, when one is not
        done after `timeout` seconds."""
        if self._closed:
            raise RankFailure("the rank pool is closed")
        if len(args) != self.world:
            raise ValueError(f"{len(args)} argument tuples for "
                             f"{self.world} ranks")
        task_id = self._next_task
        self._next_task += 1
        for r, a in enumerate(args):
            self._tasks[r].put((task_id, fn, tuple(a)))
        out = [None] * self.world
        pending = set(range(self.world))
        deadline = None if timeout is None else time.monotonic() + timeout
        while pending:
            try:
                rank, tid, ok, payload = self._results.get(timeout=0.2)
            except queue.Empty:
                dead = [r for r in sorted(pending)
                        if not self._procs[r].is_alive()]
                if dead:
                    code = self._procs[dead[0]].exitcode
                    self._fail(f"rank {dead[0]} exited with code {code} "
                               f"during {fn.__name__}")
                if deadline is not None and time.monotonic() > deadline:
                    self._fail(f"ranks {sorted(pending)} did not finish "
                               f"{fn.__name__} within {timeout:g} s")
                continue
            if not ok:
                self._fail(f"rank {rank} raised in "
                           f"{fn.__name__ if tid >= 0 else 'its set-up'}:\n"
                           f"{payload}")
            if tid == task_id:
                out[rank] = payload
                pending.discard(rank)
        return out

    def _fail(self, what: str):
        self.close(graceful=False)
        raise RankFailure(what)

    def close(self, graceful: bool = True) -> None:
        """Stop the ranks (asking them to leave the group first when
        `graceful`) and remove the rendezvous directory."""
        if self._closed:
            return
        self._closed = True
        if graceful:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=30)
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        self._results.cancel_join_thread()
        self._results.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close(graceful=exc[0] is None)
