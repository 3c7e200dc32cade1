#!/usr/bin/env python3
"""One-device CG step times of two checkouts, in turns, on one card.

    python3 scripts/cg_turns.py PARENT CHANGE [--log-dir DIR]

PARENT and CHANGE are directories that each hold a checkout (for example
``git archive <commit> | tar -x -C DIR``). In each, in the order PARENT,
CHANGE, CHANGE, PARENT, a process of its own runs that checkout's
``chip_smoke.phase_cg_path`` at fem_mesh_2d(1440): the fp64 and f32
solves, then the fp64 step captured and launched eagerly (the slope of
solves of 20 and 220 steps that never converge) and the captured loop
under ``torch.profiler`` (device time a step, busy share). Each run
prints one JSON line, ``{"tree": ..., "turn": i, "captured_ms": ...,
"eager_ms": ..., "device_ms": ..., "busy": ...}``, and keeps its whole log
in DIR (default: build/cg_turns). Each checkout builds its own kernels.
Compare two versions only within one run of this script.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

CHILD = r"""
import chip_smoke as cs
from ellspmv_tpu_torch.models.generators import fem_mesh_2d
cs.phase_device()
cs.phase_build()
cs.phase_cg_path(fem_mesh_2d(1440), 3.35e12)
"""

SLOPE = re.compile(r"captured ([\d.]+) ms, launched eagerly ([\d.]+) ms")
DEVICE = re.compile(r"device ([\d.]+) ms \(busy ([\d.]+)%")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("change")
    ap.add_argument("--log-dir", default=os.path.join("build", "cg_turns"))
    args = ap.parse_args()
    os.makedirs(args.log_dir, exist_ok=True)
    failed = False
    for turn, (name, tree) in enumerate([("parent", args.parent),
                                         ("change", args.change),
                                         ("change", args.change),
                                         ("parent", args.parent)]):
        proc = subprocess.run([sys.executable, "-c", CHILD], cwd=tree,
                              capture_output=True, text=True, timeout=900)
        log = proc.stdout + proc.stderr
        path = os.path.join(args.log_dir, f"cg_turns_{turn}.log")
        with open(path, "w") as f:
            f.write(log)
        slope, device = SLOPE.search(log), DEVICE.search(log)
        if proc.returncode or not (slope and device):
            print(json.dumps({"tree": name, "turn": turn,
                              "rc": proc.returncode, "log": path}),
                  flush=True)
            failed = True
            continue
        print(json.dumps({"tree": name, "turn": turn,
                          "captured_ms": float(slope.group(1)),
                          "eager_ms": float(slope.group(2)),
                          "device_ms": float(device.group(1)),
                          "busy": float(device.group(2))}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
