#!/usr/bin/env python3
"""Split a benchmark cell's set-up by the program's spans.

Run from the root of the repository, one process a run (so that each
first call loads the kernels' library, as a run of the benchmark does):

    python3 scripts/setup_spans.py --workload lynx68.spmv --seed 7 \\
        [--seconds 2] [--params '{"nx": 64, ...}'] [--device cuda]

The cell runs as a traced run of the benchmark, through
``spmv_bench/harness.run_cell``, its `setup_s` from the process's start
as ``spmv_bench/run.py`` takes it. The port keeps the span tree of each of
its set-up entries (``utils/timing.setup_log``); no span opens in the
window, the check or the reference. The script reads the trees the run
logged and prints a line for each span name (calls, total seconds, self
seconds, and the last call's attributes, among them the padding of the
ELL and of the SELL split), then the run's set-up split as the
benchmark's readers give it (``spmv_bench/setup_split.py``), the share of
each parent span its children cover (`covers`), and the cost of one span
in this process, kept nowhere, in an entry's tree, in a recording, and in
both (`span_ns`). The last line of standard output is one JSON object.
"""

from __future__ import annotations

import time

#: The process's start, as ``spmv_bench/run.py`` takes it for `setup_s`.
T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: The benchmark's readings of the set-up split.
READINGS = ("convert_discarded_s", "convert_build_s", "upload_s",
            "first_call_s", "setup_unspanned_s")
#: The spans whose children's cover the script reports.
PARENTS = ("formats.auto_from_coo", "formats.build.ell", "formats.build.dia",
           "formats.price.sell", "stream.sum_plan", "formats.upload")


def span_table(trees) -> list[tuple[str, int, float, float]]:
    """(name, calls, total seconds, self seconds) for each span name in
    `trees`, in the order the names first opened."""
    names = list(dict.fromkeys(s.name for t in trees for s in t.spans))
    return [(n, sum(len(t.find(n)) for t in trees),
             sum(t.total_s(n) for t in trees),
             sum(t.self_s(n) for t in trees)) for n in names]


def covers(trees) -> dict:
    """For each name of `PARENTS` in `trees`: its spans' seconds and the
    share of them their children cover."""
    out = {}
    for name in PARENTS:
        own = kids = 0.0
        for t in trees:
            for i, s in enumerate(t.spans):
                if s.name == name:
                    own += s.seconds
                    kids += sum(c.seconds for c in t.children(i))
        if own > 0:
            out[name] = {"s": own, "cover": kids / own}
    return out


def span_ns(calls: int = 20000, repeats: int = 5) -> dict:
    """Nanoseconds one set-up span costs in this process: kept nowhere
    (`off`), in an entry's tree (`log`), in a recording (`on`) and in both
    (`both`); the least over `repeats` loops of `calls` spans around
    nothing, less the loop's own time. The entry's trees join the log."""
    from ellspmv_tpu_torch.utils import timing

    def each(body):
        best = float("inf")
        for _ in range(repeats):
            t = time.perf_counter_ns()
            body()
            best = min(best, time.perf_counter_ns() - t)
        return best / calls

    def bare():
        for _ in range(calls):
            pass

    def spans():
        for _ in range(calls):
            with timing.span("formats.counts"):
                pass

    def in_entry():
        with timing.span("dispatch.first_call"):
            spans()

    loop = each(bare)
    out = {"off": each(spans) - loop, "log": each(in_entry) - loop}
    with timing.recording():
        out["on"] = each(spans) - loop
        out["both"] = each(in_entry) - loop
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the window after the set-up")
    ap.add_argument("--params", help="JSON: the configuration's sizes "
                    "replaced (small runs on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ellspmv_tpu_torch.utils import timing
    from spmv_bench import harness, setup_split

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    params = json.loads(args.params) if args.params else None
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("setup_spans: no CUDA card", file=sys.stderr)
        return 1

    before = timing.setup_log()
    line = harness.run_cell(bench, args.workload, args.seed, args.seconds,
                            True, device=args.device, t_start=T_START,
                            params=params)
    trees = [t for t in timing.setup_log()
             if not any(t is b for b in before)]
    metrics = line["metrics"]
    out = {"workload": args.workload, "seed": args.seed,
           "device": line["device"]["kind"], "correct": line["correct"],
           "convert_s": metrics["convert_s"]["value"]}
    out.update({k: metrics[k]["value"] for k in READINGS if k in metrics})
    for name, calls, total, own in span_table(trees):
        attrs = next(t.find(name)[-1] for t in reversed(trees)
                     if t.find(name)).attrs
        print(f"span {name}: {calls} calls, {total:.6f} s, self "
              f"{own:.6f} s" + (f", last {attrs}" if attrs else ""),
              flush=True)
    chooser = next((t for t in trees if t.spans
                    and t.spans[0].name == setup_split.ROOT), None)
    if chooser is not None:
        root = chooser.spans[0]
        out.update(root_s=root.seconds, root_cover=sum(
            c.seconds for c in chooser.children(0)) / root.seconds,
            format=root.attrs["choice"])
    out.update(trees=[t.spans[0].name for t in trees if t.spans],
               trees_s=sum(t.spans[0].seconds for t in trees if t.spans),
               spans=sum(len(t.spans) for t in trees), covers=covers(trees),
               span_ns=span_ns())
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
