"""The readings that a cell's limits are set from, in one process: the
program's compared numbers on many seeds, and the control's, the plain
reference in the program's place in float32, the precision below the
configuration's fp64, which has to come out not correct.

    python3 spmv_bench/readings.py --workload <cell> --seconds <s> \
        --seeds 1,2,... --control-seeds 101,102,103

One JSON line per run, then one summary line: the largest reading of
each compared number over the program's seeds and the smallest over the
control's. The benchmark's own runs do not run this.
"""

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=seeds, default=[])
    parser.add_argument("--control-seeds", type=seeds, default=[])
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from spmv_bench import harness

    if args.device == "cuda" and not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 1
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    high, low = {}, {}
    runs = [(s, "port", harness.Port()) for s in args.seeds] + [
        (s, "control_float32", harness.Reference(torch.float32))
        for s in args.control_seeds]
    for seed, side, program in runs:
        out = harness.run_cell(bench, args.workload, seed, args.seconds,
                               False, device=args.device, program=program)
        line = {"seed": seed, "side": side, "correct": out["correct"],
                "attempted": out["attempted"], "failed": out["failed"],
                "checks": {k: v["value"] for k, v in out["checks"].items()},
                "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        print(json.dumps(line), flush=True)
        for name, value in line["checks"].items():
            if side == "port":
                high[name] = max(high.get(name, value), value)
            else:
                low[name] = min(low.get(name, value), value)
    print(json.dumps({"workload": args.workload, "port_highest": high,
                      "control_lowest": low}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
