"""``hpcg_256.pcg``'s parts on the CPU: the generator against HPCG's
counts, `pcg_mg`'s grid, the least bytes, the readers, and whole runs
at 32³ (the smallest cube whose four levels are all DIA): the port
correct, the float32 control and faults planted in the V-cycle not.

At 32³ a set of 50 iterations takes the residual to rounding, where a
weaker preconditioner still reaches the same x, so the planted faults run
sets of 10 iterations (the port beside them, correct), where x is still on
its way and a wrong sweep shows in every row."""

import json
import pathlib

import pytest
import torch

from spmv_bench import harness, least_bytes_hpcg, tracing
from spmv_bench.drivers import pcg_mg
from spmv_bench.generators import hpcg_27pt

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "hpcg_256.pcg"
SMALL = {"nx": 32}
SEED = 2**40 + 9


@pytest.mark.parametrize("grid", [(8, 8, 8), (4, 6, 10), (3, 5, 7)])
def test_generator_is_hpcgs_stencil(grid):
    nx, ny, nz = grid
    m = hpcg_27pt.generate({"nx": nx, "ny": ny, "nz": nz}, SEED, "cpu")
    n = nx * ny * nz
    assert m.num_rows == n
    assert m.num_nonzeros == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    assert m.num_nonzeros == least_bytes_hpcg.nonzeros(grid)
    assert m.distinct_values == least_bytes_hpcg.distinct_values(grid)
    assert m.referenced_columns == n
    key = m.rows * n + m.cols
    assert bool((key[1:] > key[:-1]).all())            # sorted, no duplicates
    a = torch.zeros(n, n, dtype=torch.float64)
    a[m.rows, m.cols] = m.values
    assert torch.equal(a, a.T)
    assert torch.equal(torch.diagonal(a), torch.full((n,), 26.0,
                                                     dtype=torch.float64))
    assert set(m.values.tolist()) == {26.0, -1.0}
    other = hpcg_27pt.generate({"nx": nx, "ny": ny, "nz": nz}, 1, "cpu")
    assert torch.equal(other.values, m.values)         # the seed changes nothing


def test_grid_is_a_cube_that_halves():
    assert pcg_mg.grid_of(256 ** 3, 4) == (256, 256, 256)
    assert pcg_mg.grid_of(32 ** 3, 4) == (32, 32, 32)
    for n in (32 ** 3 + 1, 16 * 24 * 32, 12 ** 3):
        with pytest.raises(ValueError, match="cube"):
            pcg_mg.grid_of(n, 4)


def test_least_bytes_at_256():
    levels = least_bytes_hpcg.grids((256, 256, 256), 4)
    assert levels == [(256,) * 3, (128,) * 3, (64,) * 3, (32,) * 3]
    assert [least_bytes_hpcg.nonzeros(g) for g in levels] == [
        449_455_096, 55_742_968, 6_859_000, 830_584]
    n = 256 ** 3
    sweep = least_bytes_hpcg.sweep_bytes(levels[0])
    assert sweep == 8 * ((449_455_096 + n) // 2 + 3 * n)
    per_iter = least_bytes_hpcg.pcg_iteration_bytes(levels)
    # the fine level's four sweeps are most of it, and all of it is more
    assert 4 * sweep < per_iter < 8 * sweep


def _run(program=None, iterations=None, monkeypatch=None, trace=False):
    if iterations is not None:
        mix = dict(harness.mix_of(harness.find(BENCH, CELL)),
                   iterations=iterations)
        monkeypatch.setattr(harness, "mix_of", lambda cell: mix)
    return harness.run_cell(BENCH, CELL, SEED, 0.1, trace, device="cpu",
                            program=program, params=SMALL)


def test_the_port_is_correct_at_32():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 50 and out["attempted"] % 50 == 0
    assert out["metrics"]["spmv_gnz_s"]["value"] > 0
    assert out["metrics"]["setup_s"]["value"] > 0
    assert out["checks"]["x_gap"]["limit"] == 1e-9


def test_the_float32_control_is_not_correct():
    out = _run(harness.Reference(torch.float32))
    assert not out["correct"]
    check = out["checks"]["x_gap"]
    assert check["value"] > 100 * check["limit"]


def _skip_colour(monkeypatch, multigrid):
    monkeypatch.setattr(multigrid, "FORWARD", (0, 1, 2, 4, 5, 6, 7))
    monkeypatch.setattr(multigrid, "BACKWARD", (7, 6, 5, 4, 2, 1, 0))


def _backward_forward(monkeypatch, multigrid):
    monkeypatch.setattr(multigrid, "BACKWARD", multigrid.FORWARD)


def _no_prolongation_at_1(monkeypatch, multigrid):
    prolong = multigrid.Hierarchy.prolong
    monkeypatch.setattr(multigrid.Hierarchy, "prolong",
                        lambda self, k: None if k == 1 else prolong(self, k))


def _none(monkeypatch, multigrid):
    pass


@pytest.mark.parametrize("fault,correct", [
    (_none, True), (_skip_colour, False), (_backward_forward, False),
    (_no_prolongation_at_1, False)])
def test_a_fault_in_the_vcycle_fails_x_gap(monkeypatch, fault, correct):
    from ellspmv_tpu_torch.models import multigrid
    fault(monkeypatch, multigrid)
    out = _run(iterations=10, monkeypatch=monkeypatch)
    assert out["correct"] is correct, out["checks"]
    if not correct:
        check = out["checks"]["x_gap"]
        assert check["value"] > 100 * check["limit"]


def test_a_traced_run_reports_what_the_cpu_has():
    """Off a card only the host's and the program's numbers: the device
    metrics read nothing and say so with None, not an error."""
    out = _run(trace=True)
    assert out["correct"]
    assert set(out["metrics"]) == {"convert_s", "mg_setup_s"}
    assert 0 < out["metrics"]["mg_setup_s"]["value"] < 60


MS = 1_000_000


def _traced_run():
    run = harness.Run(CELL, "NVIDIA H100 80GB HBM3", n=256 ** 3,
                      nnz=449_455_096, peak_bytes_per_s=3.35e12,
                      window_s=10.0, iterations=600)
    run.trace = tracing.reduce([
        tracing.Event(tracing.WINDOW, 0, 10_000 * MS, False),
        tracing.Event("(anonymous namespace)::dia_symgs_kernel(double "
                      "const*)", 0, 6_000 * MS, True, True),
        tracing.Event("void dia_spmv_kernel<double>", 6_000 * MS,
                      9_000 * MS, True, True),
    ])
    run.mg_grids = least_bytes_hpcg.grids((256,) * 3, 4)
    run.mg_sweeps = [4, 4, 4, 2]
    run.symgs_launches = 600 * 8 * 14
    return run


def test_the_readers():
    run = _traced_run()
    read = {m: harness.reader(m)(run) for m in (
        "symgs_roofline_pct", "pcg_roofline_pct", "launches_per_pcg_iter",
        "device_idle_pct.pcg", "mg_setup_s")}
    sweeps = sum(k * least_bytes_hpcg.sweep_bytes(g)
                 for k, g in zip(run.mg_sweeps, run.mg_grids))
    assert read["symgs_roofline_pct"] == pytest.approx(
        100 * 600 * sweeps / 3.35e12 / 6.0)
    assert read["pcg_roofline_pct"] == pytest.approx(
        100 * 600 * least_bytes_hpcg.pcg_iteration_bytes(run.mg_grids)
        / 3.35e12 / 9.0)
    assert read["launches_per_pcg_iter"] == pytest.approx(2 / 600)
    assert read["device_idle_pct.pcg"] == pytest.approx(10.0)
    assert read["mg_setup_s"] is None          # no recording: no span


def test_a_parent_without_the_hierarchy_reads_nothing():
    """The readers on a run that holds none of what the driver adds."""
    run = _traced_run()
    for name in ("mg_grids", "mg_sweeps", "symgs_launches"):
        delattr(run, name)
    for m in ("symgs_roofline_pct", "pcg_roofline_pct", "mg_setup_s"):
        assert harness.reader(m)(run) is None
