"""``npb_cg_c.cg``'s parts on the CPU: the least bytes of an outer step on
a hand count, its three readers on a made-up trace, and whole runs at
NPB's class S: the port correct, the float32 control not.

``test_bench_correct.py`` runs every cell at the small size that its
table ``SMALL``, or ``spmv_bench/conftest.py``'s ``LATER_CELLS``, gives
its configuration. ``npb_cg_c`` came later than both, so this module adds
its size to ``LATER_CELLS`` as it is collected: NPB's class S (1,400 rows,
78,148 nonzeros), with class S's SHIFT, NITER and published ζ. So the
self-check runs as one directory, ``python -m pytest spmv_bench/tests``."""

import json
import pathlib

import pytest
import torch

from spmv_bench import conftest, harness, least_bytes_npb, tracing
from spmv_bench.tracing import Event

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELL = "npb_cg_c.cg"
SMALL = {"na": 1400, "nonzer": 7, "rcond": 0.1, "shift": 10.0, "niter": 15,
         "zeta_verify": 8.5971775078648}
conftest.LATER_CELLS.setdefault("npb_cg_c", SMALL)
SEED = 2**41 + 17


def test_least_bytes_on_a_hand_count():
    # 10 rows, 50 nonzeros, 9 columns referenced, 2 iterations: 3
    # multiplies of 8·(50 + 9 + 10) bytes, and 6 + 2·12 + 7 = 37 passes
    # of 10 values
    assert least_bytes_npb.multiply_bytes(50, 9, 10) == 552
    assert least_bytes_npb.step_bytes(50, 9, 10, 2) == 3 * 552 + 8 * 37 * 10
    # class C: 26 multiplies of the 36.1M values, and 313 vector passes
    c = least_bytes_npb.step_bytes(36_121_058, 150_000, 150_000, 25)
    assert c == 26 * 8 * (36_121_058 + 300_000) + 8 * 313 * 150_000
    assert 7.9e9 < c < 8.0e9


def _run_with_trace():
    ms = 1_000_000
    events = [Event(tracing.WINDOW, 0, 10 * ms, False),
              Event("ell_spmv_kernel", 0, 6 * ms, True, True),
              Event("dot_partial_kernel", 6 * ms, 7 * ms, True, True),
              Event("dot_final_kernel", 7 * ms, 8 * ms, True, True)]
    run = harness.Run(CELL, "NVIDIA H100 80GB HBM3", n=1000, nnz=20000,
                      distinct_values=20000, referenced_columns=990,
                      value_bytes=8, peak_bytes_per_s=3.35e12, window_s=0.01,
                      iterations=26 * 4)
    run.trace = tracing.reduce(events)
    run.npb_steps, run.npb_iterations = 4, 25
    return run


def test_readers_on_a_made_up_trace():
    from ellspmv_tpu_torch.utils import timing
    run = _run_with_trace()
    least = least_bytes_npb.step_bytes(20000, 990, 1000, 25) * 4
    roofline = harness.reader("npb_roofline_pct")
    launches = harness.reader("launches_per_npb_step")
    capture = harness.reader("npb_capture_s")
    assert roofline(run) == pytest.approx(100 * least / 3.35e12 / 0.008)
    assert launches(run) == 3 / 4
    assert capture(run) is None                  # no span recorded
    with timing.recording() as rec:
        with timing.span("solvers.power_step.capture"):
            pass
        with timing.span("solvers.power_step.warmup"):
            pass
    run.npb_spans = rec
    assert capture(run) == rec.find("solvers.power_step.capture")[0].seconds
    # a run that counted no step, or has no trace, or no peak: nothing
    # (the parent's program, which has no power step, leaves these unset)
    bare = harness.Run(CELL, "cpu")
    for read in (roofline, launches, capture):
        assert read(bare) is None
    run.trace = None
    assert roofline(run) is None and launches(run) is None
    run = _run_with_trace()
    run.peak_bytes_per_s = None
    assert roofline(run) is None


def _run(program=None):
    return harness.run_cell(BENCH, CELL, SEED, 0.3, False, device="cpu",
                            program=program, params=SMALL)


def test_the_port_is_correct_at_class_s():
    out = _run()
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["attempted"] % (26 * 15) == 0
    assert out["checks"]["x_gap"]["value"] < 1e-13
    assert out["checks"]["zeta_gap"]["value"] < 1e-13
    assert "spmv_gnz_s" in out["metrics"] and "setup_s" in out["metrics"]


def test_the_float32_control_is_not_correct_at_class_s():
    out = _run(harness.Reference(torch.float32))
    assert not out["correct"]
    assert out["checks"]["x_gap"]["value"] > 100 * \
        out["checks"]["x_gap"]["limit"]
    assert out["checks"]["zeta_gap"]["value"] > \
        out["checks"]["zeta_gap"]["limit"]


def test_a_lost_step_is_not_correct(monkeypatch):
    """A driver that drops one step of a run: x is a step short of the
    reference's, and ζ too."""
    from spmv_bench.drivers import npb_cg
    prepare = npb_cg.prepare

    def short(cell, operand, fn):
        state = prepare(cell, operand, fn)
        state.niter -= 1
        return state
    monkeypatch.setattr(npb_cg, "prepare", short)
    real_check = npb_cg.check

    def check(state, ref):
        state.niter += 1                         # the reference's full run
        return real_check(state, ref)
    monkeypatch.setattr(npb_cg, "check", check)
    out = _run()
    assert not out["correct"], out["checks"]
