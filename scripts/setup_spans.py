#!/usr/bin/env python3
"""Split a benchmark cell's set-up by the program's spans.

Run from the root of the repository, one process a run (so that each
first call loads the kernels' library, as a run of the benchmark does):

    python3 scripts/setup_spans.py --workload lynx68.spmv --seed 7 \\
        --record 1 [--seconds 2] [--params '{"nx": 64, ...}'] \\
        [--device cuda]

The cell runs as a traced run of the benchmark, through
``spmv_bench/harness.run_cell``. With ``--record 1`` the run is inside
``utils/timing.recording()``: no span opens in the window, the check or
the reference, so the spans are those of the set-up. The script prints a
line for each span name (calls, total seconds, self seconds, and the
last call's attributes, among them the padding of the ELL and of the SELL
split), the split of the set-up (`convert_split`), and how much of the
root span its children cover. With ``--record 0`` nothing is recorded:
the runs of both kinds give the cost of recording. Either way it times
one span in this process, with recording off and on (`span_ns`). The
last line of standard output is one JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

#: The chooser's work on one candidate: pricing it, building it on the
#: host.
CANDIDATE = ("formats.price.", "formats.build.")


def convert_split(rec) -> dict | None:
    """The set-up's parts in a recording of `auto_from_coo` and
    `traceable_spmv`: the candidates' work on the formats the chooser did
    not keep (`convert_discarded_s`) and on the one it kept
    (`convert_build_s`), each candidate span counted once with what it
    holds; the copies to the card (`upload_s`); the first call
    (`first_call_s`). None without the root span."""
    roots = rec.find("formats.auto_from_coo")
    if not roots:
        return None
    choice = roots[-1].attrs.get("choice")
    kept = discarded = 0.0
    for i, s in enumerate(rec.spans):
        if s.name.startswith(CANDIDATE) and not any(
                rec.within(i, p) for p in CANDIDATE):
            if s.name.rsplit(".", 1)[1] == choice:
                kept += s.seconds
            else:
                discarded += s.seconds
    return {"convert_discarded_s": discarded, "convert_build_s": kept,
            "upload_s": rec.total_s("formats.upload"),
            "first_call_s": rec.total_s("dispatch.first_call")}


def root_cover(rec) -> tuple[float, float]:
    """The root span's seconds and the share of them its children cover."""
    i = next(i for i, s in enumerate(rec.spans)
             if s.name == "formats.auto_from_coo")
    root = rec.spans[i].seconds
    return root, sum(c.seconds for c in rec.children(i)) / root


def span_table(rec) -> list[tuple[str, int, float, float]]:
    """(name, calls, total seconds, self seconds) for each span name, in
    the order the names first opened."""
    names = list(dict.fromkeys(s.name for s in rec.spans))
    return [(n, len(rec.find(n)), rec.total_s(n), rec.self_s(n))
            for n in names]


def span_ns(calls: int = 20000, repeats: int = 5) -> dict:
    """Nanoseconds one set-up span costs in this process, with recording off
    and on: the least over `repeats` loops of `calls` spans around nothing,
    less the loop's own time."""
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

    loop = each(bare)
    off = each(spans) - loop
    with timing.recording():
        on = each(spans) - loop
    return {"off": off, "on": on}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--record", type=int, choices=(0, 1), required=True)
    ap.add_argument("--seconds", type=float, default=2.0,
                    help="the window after the set-up")
    ap.add_argument("--params", help="JSON: the configuration's sizes "
                    "replaced (small runs on the CPU)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from ellspmv_tpu_torch.utils import timing
    from spmv_bench import harness

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    params = json.loads(args.params) if args.params else None
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("setup_spans: no CUDA card", file=sys.stderr)
        return 1

    with (timing.recording() if args.record
          else contextlib.nullcontext()) as rec:
        line = harness.run_cell(bench, args.workload, args.seed,
                                args.seconds, True, device=args.device,
                                params=params)
    out = {"workload": args.workload, "seed": args.seed,
           "record": args.record, "device": line["device"]["kind"],
           "correct": line["correct"],
           "convert_s": line["metrics"]["convert_s"]["value"],
           "span_ns": span_ns()}
    if rec is not None:
        for name, calls, total, own in span_table(rec):
            attrs = rec.find(name)[-1].attrs
            print(f"span {name}: {calls} calls, {total:.6f} s, self "
                  f"{own:.6f} s" + (f", last {attrs}" if attrs else ""),
                  flush=True)
        root, cover = root_cover(rec)
        out.update(convert_split(rec), root_s=root, root_cover=cover,
                   spans=len(rec.spans),
                   format=rec.find("formats.auto_from_coo")[-1]
                   .attrs["choice"])
    print(json.dumps(out), flush=True)
    return 0

if __name__ == "__main__":
    sys.exit(main())
