#!/usr/bin/env python3
"""Kernel times of two checkouts of the repository, in turns, on one card.

    python3 scripts/timing_turns.py PARENT CHANGE [--log-dir DIR]

PARENT and CHANGE are directories that each hold a checkout (for example
``git archive <commit> | tar -x -C DIR``). In each, in the order PARENT,
CHANGE, CHANGE, PARENT, a process of its own runs that checkout's
``chip_smoke.py`` timing phases: the ELL and headline paths and their
timing at fem_mesh_2d(1440) (K1, K2, K6, K7), then the stream path and its
timing at config3, power_law(1,000,000, 8) (K3 in place and through its
maps, the gather, the stream path). Each run prints one JSON line,
``{"tree": ..., "turn": i, "ms": {"<kernel> <precision>": ms}}``, and
keeps its whole log in DIR (default: chiprun_out). Each checkout builds
its own kernels. Two cards differ: compare two versions only within one
run of this script.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json
import numpy as np
import chip_smoke as cs
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.models.generators import fem_mesh_2d, power_law
from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy

cs.phase_device()
cs.phase_build()
coo = fem_mesh_2d(1440)
rng = np.random.RandomState(1)
x64 = rng.rand(coo.num_rows)
sample = np.sort(rng.choice(coo.num_rows, 1000, replace=False))
ell_runs, _ = cs.phase_ell_path(coo, x64, sample)
dia_runs, _ = cs.phase_headline_path(coo, x64, sample)
timing = cs.phase_timing(coo, ell_runs, dia_runs, 3.35e12)
del ell_runs, dia_runs, coo
pl = power_law(*cs.CONFIG3, seed=0)
x = np.random.RandomState(2).rand(pl.num_columns)
want = coo_spmv_numpy(pl, x)
scale = coo_spmv_numpy(CooMatrix(pl.num_rows, pl.num_columns, pl.rowidx,
                                 pl.colidx, np.abs(pl.values)), x)
runs, _ = cs.phase_stream_path(pl, x, want, scale)
timing.update(cs.phase_stream_timing(pl, runs, 3.35e12))
print("TIMES " + json.dumps({f"{k[0]} {k[1]}": v["ms"]
                             for k, v in timing.items() if "ms" in v}))
"""


def run_tree(tree: str, turn: int, log_dir: str) -> dict:
    """One run of the timing phases in the checkout `tree`; its times."""
    log_path = os.path.join(log_dir, f"timing_turns_{turn}.log")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(tree))
    with open(log_path, "w") as log:
        proc = subprocess.run([sys.executable, "-c", CHILD],
                              cwd=os.path.abspath(tree), env=env,
                              stdout=subprocess.PIPE, stderr=log, text=True,
                              timeout=1800)
        log.write(proc.stdout)
    times = [line[len("TIMES "):] for line in proc.stdout.splitlines()
             if line.startswith("TIMES ")]
    if proc.returncode != 0 or not times:
        raise SystemExit(f"timing_turns: {tree} (turn {turn}) exited "
                         f"{proc.returncode}; see {log_path}")
    return json.loads(times[-1])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--log-dir", default="chiprun_out")
    args = ap.parse_args(argv)
    os.makedirs(args.log_dir, exist_ok=True)
    for turn, tree in enumerate((args.parent, args.change, args.change,
                                 args.parent)):
        ms = run_tree(tree, turn, args.log_dir)
        print(json.dumps({"tree": tree, "turn": turn, "ms": ms}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
