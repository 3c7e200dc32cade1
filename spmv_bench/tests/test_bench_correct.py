"""The comparison that decides ``correct``, driven through a whole run on
the CPU at a small size (past the harness's look for a card): the port
comes out correct, and the control, the plain reference in float32 in the
port's place, and each fault planted under the timed path come out not
correct."""

import json
import pathlib

import pytest
import torch

from spmv_bench import harness

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SMALL = {"lynx68": {"nx": 24, "extras": 5, "diagonal": 24.0},
         "graph500_s21": {"scale": 11, "edgefactor": 16, "a": 0.57,
                          "b": 0.19, "c": 0.19}}
CELLS = [c["name"] for c in BENCH["workloads"]]


def _run(workload, program=None, seed=2**33 + 5):
    config = harness.find(BENCH, workload)["config"]
    return harness.run_cell(BENCH, workload, seed, 0.3, False, device="cpu",
                            program=program, params=SMALL[config])


@pytest.mark.parametrize("workload", CELLS)
def test_port_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] > 0


@pytest.mark.parametrize("workload", CELLS)
def test_control_float32_is_not_correct(workload):
    out = _run(workload, harness.Reference(torch.float32))
    assert not out["correct"], out["checks"]
    name, check = next(iter(out["checks"].items()))
    assert check["value"] > 3 * check["limit"]


class Faulty(harness.Port):
    """The port with one fault planted where an answer is made."""

    def __init__(self, fault):
        self.fault = fault

    def traceable(self, matrix):
        operand, fn = super().traceable(matrix)
        n = matrix.num_rows

        def unchanged(op, x, y=None):           # a step that does nothing
            return torch.zeros_like(x) if y is None else y.clone()

        def half(op, x, y=None):                # half the rows left out
            out = fn(op, x, y)
            out[n // 2:] = 0 if y is None else y[n // 2:]
            return out

        def altered(op, x, y=None):             # one answer altered
            out = fn(op, x, y)
            out[3] += 1e-6 * (out[3].abs() + 1)
            return out

        faults = {"unchanged": unchanged, "half": half, "altered": altered}
        return operand, faults[self.fault]


@pytest.mark.parametrize("workload,fault", [
    (w, f) for w in CELLS for f in ("unchanged", "half", "altered")])
def test_fault_is_not_correct(workload, fault):
    out = _run(workload, Faulty(fault))
    assert not out["correct"], (fault, out["checks"])
