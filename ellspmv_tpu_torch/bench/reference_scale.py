"""The run at the reference's own matrix scale, the counterpart of
``benchmarks/reference_scale.py``.

Writes a Lynx68_reordered-class matrix (README:130: 6,810,586 rows,
115,779,962 nonzeros, about 17 a row, an RCM-ordered FEM mesh) as a real
Matrix Market file, ``fem_mesh_2d(nx, nx, extras=5, seed=1)`` through the
native writer, then runs the ``ellspmv`` program on it in a process of its
own, as a user would:

    python -m ellspmv_tpu_torch.cli.ellspmv -q -v --protocol=chained \\
        --repeat=4 --warmup=2 FILE

and prints the phases the reference publishes (``mtxfile_read``,
``ell_from_coo`` and the ``gemv`` slope), the effective GB/s against the
reference's 148, the host's cores (the parser runs on all of them) and the
card's name and power limit. The reference's numbers (BASELINE.md, two
Xeon Gold 6130, 32 threads): read 32.03 s (99.7 MB/s), convert 0.773 s,
SpMV 148 GB/s.

Usage:

    python -m ellspmv_tpu_torch.bench.reference_scale [--nx 2610] \\
        [--dir DIR] [--keep] [--gen-only | --run-only] [--device=cuda|cpu]

The file (about 4 GB at ``--nx 2610``) goes to DIR (default: the build
directory beside the package) and is removed after the run unless
``--keep``.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
import time

from ellspmv_tpu_torch.bench.headline import REFERENCE_GBPS
from ellspmv_tpu_torch.ops._build import BUILD_DIR

DEFAULT_NX = 2610
#: The ``ellspmv`` options of the run (beside ``-q``, ``--device`` and the
#: file).
RUN_ARGS = ("-v", "--protocol=chained", "--repeat=4", "--warmup=2")


def matrix_path(directory, nx: int) -> str:
    return os.path.join(os.fspath(directory), f"refscale_{nx}.mtx")


def host_line() -> str:
    """The host's cores: those the machine has and those this process may
    run on."""
    return (f"host: {os.cpu_count()} cores, {len(os.sched_getaffinity(0))} "
            "usable by this process")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=120)
    except OSError as e:
        return f"card: nvidia-smi not run ({e.strerror})"
    lines = smi.stdout.strip().splitlines() or [smi.stderr.strip()]
    return f"card: {lines[0]}"


def generate(path: str, nx: int, out=None):
    """Write ``fem_mesh_2d(nx, nx, extras=5, seed=1)`` to `path` with the
    native writer, reporting to `out` (default stdout); returns the COO."""
    from ellspmv_tpu_torch.io import native
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d

    out = out or sys.stdout
    t0 = time.perf_counter()
    coo = fem_mesh_2d(nx, nx, extras=5, seed=1)
    t_gen = time.perf_counter() - t0
    out.write(f"fem_mesh_2d({nx}, extras=5, seed=1): {coo.num_rows:,} rows, "
              f"{coo.num_nonzeros:,} nonzeros ({t_gen:.1f} s)\n")
    t0 = time.perf_counter()
    native.write_coo(path, coo.num_rows, coo.num_columns, coo.rowidx,
                     coo.colidx, coo.values,
                     symmetric=coo.symmetry == "symmetric")
    t_w = time.perf_counter() - t0
    mb = os.path.getsize(path) / 1e6
    out.write(f"write: {mb:.1f} MB in {t_w:.2f} s ({mb / t_w:.1f} MB/s, the "
              "native writer)\n")
    out.flush()
    return coo


def summary(stderr: str) -> str | None:
    """The run's phases in one line from the program's ``-v`` lines:
    read seconds, convert seconds, the gemv slope and its effective GB/s
    against the reference's; None where a line is missing."""
    read = re.search(r"^mtxfile_read: ([\d.]+) seconds \(([\d.]+) MB/s\)",
                     stderr, re.M)
    conv = re.search(r"^ell_from_coo: ([\d.]+) seconds", stderr, re.M)
    gemv = re.search(r"^gemv: ([\d.]+) seconds/iteration .*?; .*?([\d.]+) "
                     r"to [\d.]+ GB/s\)", stderr, re.M)
    if not (read and conv and gemv):
        return None
    gbps = float(gemv.group(2))
    return (f"reference scale: read {read.group(1)} s ({read.group(2)} MB/s), "
            f"ell_from_coo {conv.group(1)} s, gemv {gemv.group(1)} "
            f"s/iteration, {gbps:.1f} GB/s effective = "
            f"{gbps / REFERENCE_GBPS:.2f}x the reference's "
            f"{REFERENCE_GBPS:.0f} GB/s")


def run(path: str, device: str = "cuda", out=None) -> int:
    """Run ``ellspmv -q`` with `RUN_ARGS` on `path` in a process of its
    own; print its stderr and the summary to `out` (default stdout);
    return its exit code."""
    out = out or sys.stdout
    cmd = [sys.executable, "-u", "-m", "ellspmv_tpu_torch.cli.ellspmv", "-q",
           *RUN_ARGS, f"--device={device}", path]
    out.write(f"run: {' '.join(cmd[1:])}\n")
    out.flush()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=7200)
    out.write(f"ellspmv: {time.perf_counter() - t0:.1f} s in its process, "
              f"exit {proc.returncode}\n")
    for line in proc.stderr.splitlines():
        out.write(f"  {line}\n")
    line = summary(proc.stderr)
    if proc.returncode == 0 and line is None:
        out.write("reference scale: the program printed no read, convert "
                  "or gemv line\n")
        return 1
    if line:
        out.write(line + "\n")
    out.flush()
    return proc.returncode


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ellspmv_tpu_torch.bench.reference_scale",
        description="ellspmv on a Matrix Market file at the reference's "
                    "matrix scale")
    ap.add_argument("--nx", type=int, default=DEFAULT_NX,
                    help="mesh side: nx*nx rows (2610: 6,812,100)")
    ap.add_argument("--dir", default=str(BUILD_DIR),
                    help="where the file is written")
    ap.add_argument("--gen-only", action="store_true")
    ap.add_argument("--run-only", action="store_true")
    ap.add_argument("--keep", action="store_true",
                    help="keep the file after the run")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    if args.nx <= 0:
        ap.error("--nx must be positive")
    path = matrix_path(args.dir, args.nx)
    print(host_line())
    if args.device == "cuda":
        print(card_line())
    if not args.run_only:
        os.makedirs(args.dir, exist_ok=True)
        free = shutil.disk_usage(args.dir).free
        print(f"disk: {free / 1e9:.1f} GB free in {args.dir}")
        generate(path, args.nx)
    if args.gen_only:
        return 0
    try:
        return run(path, args.device)
    finally:
        if not args.keep and os.path.exists(path):
            os.unlink(path)


if __name__ == "__main__":
    raise SystemExit(main())
