#!/usr/bin/env python3
"""Can a CUDA graph hold NCCL collectives while the group's watchdog runs?

Run from the repository root on a machine with a CUDA card:

    python3 scripts/nccl_capture_probe.py [--iters N] [--trials T]

Each case runs in a process of its own (a failed capture can leave the
CUDA context unusable), as one rank at world size 1 on card 0. Before each
of T captures the rank leaves 20 eager all_reduces pending for
ProcessGroupNCCL's watchdog, which polls its pending works from another
thread; optionally it drains them first (a synchronise, a barrier, a
synchronise). It then captures N iterations of an allgather of 8 MB, a
small add and an all_reduce, replays the graph once, and holds the result
against the same body launched eagerly. The cases: NCCL under the capture
modes ``global`` (PyTorch's default) without and with the drain, and
``thread_local``; gloo on the card under ``global`` and ``thread_local``
(expected to fail: gloo stages a card's tensors through the host). Prints
one JSON line per case: the trials that captured and matched, the last
capture's milliseconds, or the error of the first capture that failed.
"""
import argparse
import datetime
import json
import os
import subprocess
import sys
import tempfile
import time


def case(backend, mode, drain, trials, iters):
    import torch
    import torch.distributed as dist
    torch.cuda.set_device(0)
    kw = {"device_id": torch.device("cuda:0")} if backend == "nccl" else {}
    store = dist.FileStore(os.path.join(tempfile.mkdtemp(), "store"), 1)
    dist.init_process_group(backend, store=store, rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60), **kw)
    x = torch.randn(1 << 20, dtype=torch.float64, device="cuda")
    out = torch.empty_like(x)
    acc = torch.zeros(1, dtype=torch.float64, device="cuda")

    def body():
        for _ in range(iters):
            if backend == "nccl":
                dist.all_gather_into_tensor(out, x)
            else:
                dist.all_gather([out], x)
            acc.add_(out[:1])
            dist.all_reduce(acc)

    ok, capture_ms = 0, None
    line = {"backend": backend, "mode": mode, "drain": drain,
            "iters": iters, "trials": trials}
    for t in range(trials):
        for _ in range(20):
            dist.all_reduce(acc)
        if drain:
            torch.cuda.synchronize()
            dist.barrier()
            torch.cuda.synchronize()
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, capture_error_mode=mode):
                body()
        except Exception as e:
            line.update(failed_at=t, error=str(e).splitlines()[0][:300])
            break
        capture_ms = (time.perf_counter() - t0) * 1e3
        acc.zero_()
        graph.replay()
        torch.cuda.synchronize()
        replayed = acc.clone()
        acc.zero_()
        body()
        torch.cuda.synchronize()
        ok += bool(torch.equal(acc, replayed))
        graph.reset()
        time.sleep(0.03 * t)
    line.update(matched=ok, capture_ms_last=capture_ms)
    print(json.dumps(line), flush=True)
    dist.destroy_process_group()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=3000)
    ap.add_argument("--trials", type=int, default=8)
    ap.add_argument("--case", nargs=3, metavar=("BACKEND", "MODE", "DRAIN"))
    args = ap.parse_args()
    if args.case:
        backend, mode, drain = args.case
        case(backend, mode, drain == "1", args.trials, args.iters)
        return 0
    import torch
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, NCCL {torch.cuda.nccl.version()}, "
          f"{torch.cuda.get_device_name(0)}", flush=True)
    cases = [("nccl", "global", "0"), ("nccl", "global", "1"),
             ("nccl", "thread_local", "0"), ("gloo", "global", "0"),
             ("gloo", "thread_local", "0")]
    for backend, mode, drain in cases:
        gloo = backend == "gloo"
        cmd = [sys.executable, os.path.abspath(__file__), "--case", backend,
               mode, drain, "--trials", str(1 if gloo else args.trials),
               "--iters", str(2 if gloo else args.iters)]
        try:
            p = subprocess.run(cmd, capture_output=True, text=True,
                               timeout=300)
        except subprocess.TimeoutExpired:
            print(json.dumps({"backend": backend, "mode": mode,
                              "timeout_s": 300}), flush=True)
            continue
        print(p.stdout.strip() or p.stderr.strip()[-1000:], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
