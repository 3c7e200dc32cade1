"""Where the ranks run, and their process group.

Counterpart of ``ellspmv_tpu.parallel.mesh``. The JAX package builds one
1-D mesh over the chips and runs one program over it; PyTorch runs one
process per rank under ``torch.distributed``. This module holds the rule
that places the ranks and picks the group's backend, and the group's
set-up and tear-down inside a rank:

- ``device="cpu"`` places N ranks on the CPU, any N, over gloo;
- ``device="cuda"`` puts rank r on card r, over NCCL, and refuses more
  ranks than there are cards with the JAX package's words ("requested N
  devices, have M"), as ``make_mesh`` does;
- a placement given outright (the launcher's, ``launch.RankPool``) may put
  several ranks on one card, as the tests and the smoke run do. Those ranks
  use gloo, because NCCL refuses two ranks on one card: the port's
  counterpart of the JAX package's forced host devices.

Rendezvous goes through a ``FileStore`` in a directory the launcher makes
(no network and no port to collide), and every group carries an explicit
timeout, so that a rank left waiting in a collective fails instead of
hanging.
"""

from __future__ import annotations

import datetime

import torch

#: Seconds a collective may wait before its rank fails, by default.
GROUP_TIMEOUT = 300.0


def placement(n_devices: int, device: str = "cuda") -> list[str]:
    """The devices of `n_devices` ranks under the programs' rule: all on
    the CPU, or rank r on card r. Raises ValueError when there are fewer
    cards than ranks."""
    if n_devices < 1:
        raise ValueError(f"requested {n_devices} devices, need at least 1")
    if torch.device(device).type == "cpu":
        return ["cpu"] * n_devices
    have = torch.cuda.device_count()
    if n_devices > have:
        raise ValueError(f"requested {n_devices} devices, have {have} "
                         "(each rank takes a card of its own; --device=cpu "
                         "runs any number of ranks on the CPU)")
    return [f"cuda:{r}" for r in range(n_devices)]


def backend_for(devices: list[str]) -> str:
    """``nccl`` where every rank has a card of its own, else ``gloo`` (CPU
    ranks, or ranks that share a card). Raises ValueError for a placement
    that mixes the CPU and cards."""
    devs = [torch.device(d) for d in devices]
    kinds = {d.type for d in devs}
    if kinds - {"cpu", "cuda"} or len(kinds) > 1:
        raise ValueError(f"placement {devices} mixes device types")
    if kinds == {"cuda"}:
        cards = [d.index if d.index is not None else 0 for d in devs]
        if len(set(cards)) == len(cards):
            return "nccl"
    return "gloo"


def describe(devices: list[str]) -> str:
    """One line for ``-v``: the ranks, their backend and their devices."""
    backend = backend_for(devices)
    shared = ("" if backend == "nccl" or devices[0] == "cpu"
              else ", ranks sharing a card")
    return (f"{len(devices)} ranks over {backend}{shared}: "
            f"{', '.join(devices)}")


def traceable_loops(device) -> bool:
    """In a rank of the group: whether its loops (the chained protocol's
    blocks, CG's masked step) run through the traceable form
    (``parallel/spmv.sharded_spmv_fn``): as replays of CUDA graphs that
    hold the collectives on a card over NCCL, and as the same blocks and
    steps launched eagerly on the CPU. Gloo ranks that share a card cannot
    be captured (gloo stages a card's tensors through the host and waits
    for them), so they keep the loops that launch every iteration eagerly.
    Decided by the group's backend and the device, never by a capture that
    failed."""
    import torch.distributed as dist
    return torch.device(device).type == "cpu" or dist.get_backend() == "nccl"


def init_group(rank: int, devices: list[str], store_path: str,
               timeout: float = GROUP_TIMEOUT) -> torch.device:
    """Join this process to the group as `rank` of ``len(devices)`` and
    return its device (made current where it is a card)."""
    import torch.distributed as dist

    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    else:
        torch.set_num_threads(1)
    backend = backend_for(devices)
    store = dist.FileStore(store_path, len(devices))
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=len(devices),
                            timeout=datetime.timedelta(seconds=timeout),
                            **kwargs)
    return device


def destroy_group() -> None:
    """Leave the group, if this process is in one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
