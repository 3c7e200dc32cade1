"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 spmv_bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout. Exits 1, printing no result, without a CUDA
card (or with fewer than the cell asks for) or without the program. The
last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit;
the last lines of standard error repeat the checks.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() \
        else "not read"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    from spmv_bench import harness, least_bytes

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.find(bench, args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"spmv_bench: {args.workload} needs {cell['chips']} CUDA "
              "card(s); none or too few here", file=sys.stderr)
        return 1
    result = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    # read once the run is over, so that set-up does not wait for it
    card = result["device"]["kind"]
    harness.note(f"card {card}; power limit {power_limit()}; roofline "
                 f"against {least_bytes.peak_bytes_per_s(card)} bytes/s "
                 "(the data sheet's)")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
