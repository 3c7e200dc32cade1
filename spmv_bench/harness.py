"""One run of one cell: the matrix made on the device from the seed and
handed to the program as a host COO, the program's set-up timed, the
window driven, the result checked against the plain reference, and the
cell's metrics read.

Everything is found by name from ``BENCHMARK.json``: the cell's
configuration in ``configs/<config>.json`` (its generator in
``generators/<generator>.py``), its traffic mix in ``traffic/<mix>.json``
(its driver in ``drivers/<driver>.py``), and each metric's reader in
``metrics/<metric>.py``, whose ``read(run)`` returns the metric's value
or None where the run holds nothing to read.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import pathlib
import sys
import time

import torch

from spmv_bench import least_bytes, reference, tracing
from spmv_bench.drivers import derive

HERE = pathlib.Path(__file__).resolve().parent


def note(*parts) -> None:
    """An earlier line of the run's standard output."""
    print("spmv_bench:", *parts, flush=True)


# -- the system under test ---------------------------------------------------

class Port:
    """The port's entries that a run drives: the chooser and the
    traceable SpMV."""
    dtype = torch.float64

    def convert(self, host, device):
        from ellspmv_tpu_torch.formats.auto import auto_from_coo
        from ellspmv_tpu_torch.formats.coo import CooMatrix
        n, rows, cols, values = host
        matrix = auto_from_coo(CooMatrix(n, n, rows, cols, values),
                               device=device)
        return matrix, f"{matrix._auto_choice}: {matrix._auto_reason}"

    def traceable(self, matrix):
        from ellspmv_tpu_torch.ops.dispatch import traceable_spmv
        return traceable_spmv(matrix)


class Reference:
    """The plain reference in the program's place, in `dtype`: the
    control that has to come out not correct below fp64."""

    def __init__(self, dtype=torch.float32):
        self.dtype = dtype

    def convert(self, host, device):
        n, rows, cols, values = host
        coo = reference.Coo(n, torch.from_numpy(rows).to(device).long(),
                            torch.from_numpy(cols).to(device).long(),
                            torch.from_numpy(values).to(device), self.dtype)
        return coo, f"the plain reference in {self.dtype}"

    def traceable(self, matrix):
        return matrix, lambda operand, x, y=None: operand.matvec(x, y)


# -- what a run measured -----------------------------------------------------

@dataclasses.dataclass
class Run:
    """What the metrics read."""
    workload: str
    card: str
    n: int = 0
    nnz: int = 0
    distinct_values: int = 0
    referenced_columns: int = 0
    value_bytes: int = 8
    peak_bytes_per_s: float | None = None
    setup_s: float = 0.0
    convert_s: float = 0.0
    window_s: float = 0.0
    iterations: int = 0          # chained multiplies in the window
    attempted: int = 0
    failed: int = 0
    trace: tracing.TraceSummary | None = None


@dataclasses.dataclass
class Cell:
    """One cell's run: what the drivers read and write. `chips` is the
    cell's, from ``BENCHMARK.json``; a driver that cannot use that many
    raises."""
    mix: dict
    seed: int
    device: str
    chips: int
    program: object
    run: Run
    n: int = 0
    dtype: torch.dtype = torch.float64


# -- discovery by name -------------------------------------------------------

def load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def find(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(cell: dict) -> dict:
    return load_json(HERE / "configs" / f"{cell['config']}.json")


def mix_of(cell: dict) -> dict:
    return load_json(HERE / "traffic" / f"{cell['traffic']}.json")


def generator(config: dict):
    return importlib.import_module(
        f"spmv_bench.generators.{config['generator']}")


def driver(mix: dict):
    return importlib.import_module(f"spmv_bench.drivers.{mix['driver']}")


def reader(metric: str):
    """``metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"spmv_bench.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with `trace` its per-layer ones:
    those that list the cell, or that list no cells."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group
            if workload in m.get("workloads", [workload])]


# -- a run -------------------------------------------------------------------

def make_matrix(config: dict, params: dict, seed: int, device: str):
    return generator(config).generate(params, derive(seed, "matrix"),
                                      device)


def _free(device: str) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             program=None, params: dict | None = None) -> dict:
    """One run; returns the result line's object. `program` replaces the
    port (the control, the planted faults); `params` replaces the
    configuration's sizes (the CPU self-checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    entry = find(bench, workload)
    config, mix = config_of(entry), mix_of(entry)
    params = params or config["params"]
    program = program or Port()
    cuda = torch.device(device).type == "cuda"
    card = torch.cuda.get_device_name(device) if cuda else "cpu"
    run = Run(workload, card, peak_bytes_per_s=(
        least_bytes.peak_bytes_per_s(card) if cuda else None))
    cell = Cell(mix, seed, device, int(entry["chips"]), program, run,
                dtype=program.dtype)

    # 1. the matrix, made on the device, handed over as a host COO
    m = make_matrix(config, params, seed, device)
    cell.n = run.n = m.num_rows
    run.nnz, run.distinct_values = m.num_nonzeros, m.distinct_values
    run.referenced_columns = m.referenced_columns
    run.value_bytes = torch.empty(0, dtype=program.dtype).element_size()
    index = torch.int32 if m.num_rows < 2**31 else torch.int64
    host = (m.num_rows, m.rows.to(index).cpu().numpy(),
            m.cols.to(index).cpu().numpy(), m.values.cpu().numpy())
    note(f"{workload}: {entry['config']} seed {seed}: made and on the host "
         f"at {time.perf_counter() - t_start:.4f} s: {m.num_rows:,} rows, "
         f"{m.num_nonzeros:,} nonzeros, {m.distinct_values:,} distinct "
         f"values, {m.referenced_columns:,} columns referenced")
    del m
    _free(device)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    # 2. the program's set-up
    t = time.perf_counter()
    matrix, choice = program.convert(host, device)
    if cuda:
        torch.cuda.synchronize(device)
    run.convert_s = time.perf_counter() - t
    del host
    note(f"format {choice}")
    operand, fn = program.traceable(matrix)
    t = time.perf_counter()
    drive = driver(mix)
    state = drive.prepare(cell, operand, fn)
    run.setup_s = time.perf_counter() - t_start
    note(f"setup_s {run.setup_s:.4f} (convert_s {run.convert_s:.4f}, "
         f"the traffic's warm-up {run.setup_s - (t - t_start):.4f})")

    # 3. the window, the collector's work on set-up's objects done
    gc.collect()
    gc.freeze()
    with tracing.record(trace) as events:
        drive.window(state, seconds)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # 4. the check, once the program's state is freed
    gc.unfreeze()
    drive.release(state)
    del matrix, operand, fn
    _free(device)
    m = make_matrix(config, params, seed, device)
    ref = reference.Coo(m.num_rows, m.rows, m.cols, m.values)
    del m
    checks = drive.check(state, ref)
    del ref, state
    _free(device)
    run.trace = tracing.reduce(events) if trace else None
    del events

    metrics = {}
    for metric in metrics_of(bench, workload, trace):
        value = reader(metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value,
                                       "unit": metric["unit"]}
    correct = run.failed == 0 and all(v <= limit
                                      for v, limit in checks.values())
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics,
           "device": {"platform": "gpu" if cuda else "cpu", "kind": card,
                      "count": cell.chips,
                      "memory_peak_bytes": int(peak)}}
    if run.trace is not None:
        out["device"]["busy_s"] = run.trace.busy_s
        out["device"]["window_s"] = run.trace.window_s
        out["breakdown"] = {"device_ops": run.trace.device_ops,
                            "idle_gaps": run.trace.idle_gaps}
    out["checks"] = {name: {"value": v, "limit": limit}
                     for name, (v, limit) in checks.items()}
    for name, (v, limit) in checks.items():
        print(f"check {name} {v!r} limit {limit!r}", file=sys.stderr,
              flush=True)
    return out
