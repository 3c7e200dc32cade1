#!/usr/bin/env python3
"""Time the format chooser's host work where it must lay the stream format
out to price it.

Run from the root of the repository:

    python3 scripts/chooser_time.py [--rows N] [--repeat R]

Two matrices, made from seed 0, in f32 on the host (no card is needed):

- ELL wins after the layout: N rows of 16 entries and one row of 32, the
  columns drawn from N at random. ELLPACK pads 2x and keeps 4-byte columns;
  the stream's least price (2-byte product columns) beats it, so
  ``formats/auto.auto_from_coo`` lays the stream format out
  (``formats/stream.stream_layout``), finds its products' columns wide, and
  builds the ELL.
- The stream wins: ``power_law(N, 8)``, where the padding blows up; the
  chooser lays the stream format out once and finishes it.

For each, the chooser's whole time and, beside it, the parts it is made of
timed alone: the layout, `products_narrow`, and `ell_from_coo` or
`stream_from_layout`. Each time is the least of `repeat` runs on the host's
clock. Prints one line per timing and the host's CPU count first.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def least_seconds(fn, repeat: int):
    """The least wall time of `repeat` calls of fn, and its last result."""
    best, out = float("inf"), None
    for _ in range(repeat):
        t = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t)
    return best, out


def rows_of_16_and_one_of_32(n: int):
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    rng = np.random.RandomState(0)
    rows = np.concatenate([np.repeat(np.arange(n), 16), np.zeros(16)])
    cols = rng.randint(0, n, len(rows))
    return CooMatrix(n, n, rows.astype(np.int32), cols.astype(np.int32),
                     rng.randn(len(rows)))


def main() -> int:
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.formats.stream import (stream_from_layout,
                                                  stream_layout)
    from ellspmv_tpu_torch.models.generators import power_law

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args()
    print(f"host: {os.cpu_count()} CPUs; rows {args.rows:,}; least of "
          f"{args.repeat}", flush=True)
    cases = {"rows of 16 and one of 32": rows_of_16_and_one_of_32,
             f"power_law({args.rows:,}, 8)":
             lambda n: power_law(n, 8, seed=0)}
    for name, make in cases.items():
        coo = make(args.rows)
        whole, got = least_seconds(
            lambda: auto_from_coo(coo, value_dtype="float32"), args.repeat)
        layout_s, layout = least_seconds(lambda: stream_layout(coo),
                                         args.repeat)
        narrow_s, narrow = least_seconds(layout.products_narrow, args.repeat)
        if got._auto_choice == "ell":
            rest = "ell_from_coo"
            rest_s, _ = least_seconds(
                lambda: ell_from_coo(coo, sort_rows=True,
                                     value_dtype="float32"), args.repeat)
        else:
            rest = "stream_from_layout"
            rest_s, _ = least_seconds(
                lambda: stream_from_layout(layout, value_dtype="float32"),
                args.repeat)
        print(f"{name}: {coo.num_nonzeros:,} nonzeros, chooser took "
              f"{got._auto_choice} in {whole:.3f} s; alone: stream_layout "
              f"{layout_s:.3f} s, products_narrow {narrow_s:.3f} s "
              f"(narrow {narrow}), {rest} {rest_s:.3f} s", flush=True)
        print(f"  reason: {got._auto_reason}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
