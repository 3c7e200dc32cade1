"""The port's set-up log (``ellspmv_tpu_torch/utils/timing.setup_log``) on
the CPU: the entries that keep a tree whether or not a recording is open,
the outermost entry only, the bound, the spans an open recording still
gets, no tensor or array in a logged attribute; the child spans of the
chooser's longest steps; and the benchmark's five readers of the log
(``spmv_bench/metrics``, ``spmv_bench/setup_split.py``) on small runs of
every cell, and of the float32 control after them."""

import json
import pathlib

import numpy as np
import pytest
import torch

from ellspmv_tpu_torch.formats import tensor_bytes
from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.dia import dia_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.formats.sell import sell_shape
from ellspmv_tpu_torch.formats.stream import stream_layout
from ellspmv_tpu_torch.models import multigrid
from ellspmv_tpu_torch.models.generators import (banded_random, dense_rows,
                                                 poisson2d, power_law)
from ellspmv_tpu_torch.ops.dispatch import traceable_spmv
from ellspmv_tpu_torch.utils import timing
from spmv_bench import harness, setup_split
from torch_cases import geometric_coo, random_coo

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
READINGS = ("convert_discarded_s", "convert_build_s", "upload_s",
            "first_call_s", "setup_unspanned_s")


def _new_trees(before):
    return [t for t in timing.setup_log()
            if not any(t is b for b in before)]


def _names(tree):
    return [s.name for s in tree.spans]


def _children(tree, name):
    """The names of the children of each span `name` in `tree`."""
    return [[c.name for c in tree.children(i)]
            for i, s in enumerate(tree.spans) if s.name == name]


# -- the log ------------------------------------------------------------------

def test_an_entry_keeps_its_tree_with_no_recording_open():
    assert timing._active is None and timing._tree is None
    before = timing.setup_log()
    assert timing.span("formats.counts") is timing.NOTHING
    with timing.span("formats.auto_from_coo", rows=4) as root:
        with timing.span("formats.counts"):
            with timing.span("formats.price.ell"):
                pass
        assert timing.open_spans() == ["formats.auto_from_coo"]
        root.set(choice="ell")
    assert timing._tree is None and timing.open_spans() is None
    assert timing.span("formats.counts") is timing.NOTHING
    (tree,) = _new_trees(before)
    assert _names(tree) == ["formats.auto_from_coo", "formats.counts",
                            "formats.price.ell"]
    assert [s.parent for s in tree.spans] == [-1, 0, 1]
    assert tree.spans[0].attrs == {"rows": 4, "choice": "ell"}
    assert tree.spans[0].seconds >= tree.spans[1].seconds > 0


@pytest.mark.parametrize("outer", sorted(timing.ENTRIES))
def test_only_the_outermost_entry_keeps_a_tree(outer):
    before = timing.setup_log()
    with timing.span(outer):
        for inner in sorted(timing.ENTRIES):
            with timing.span(inner):
                with timing.span("formats.counts"):
                    pass
    (tree,) = _new_trees(before)
    assert tree.spans[0].name == outer
    assert len(tree.spans) == 1 + 2 * len(timing.ENTRIES)
    assert all(s.parent >= 0 for s in tree.spans[1:])


def test_an_hpcg_build_logs_one_tree():
    """HPCG's coarse levels are chosen and called inside
    ``multigrid.build``: their trees nest in its tree; the fine level's
    chooser, called before, keeps its own."""
    before = timing.setup_log()
    multigrid.hpcg(16, 24, 32, depth=3)
    chooser, build = _new_trees(before)
    assert _names(chooser)[0] == "formats.auto_from_coo"
    assert _names(build)[0] == "multigrid.build"
    assert _names(build).count("formats.auto_from_coo") == 2
    assert _names(build).count("dispatch.first_call") == 3
    for i, s in enumerate(build.spans):
        if s.name == "formats.auto_from_coo":
            assert build.spans[s.parent].name == "multigrid.level"


def test_the_log_keeps_the_last_16_trees():
    assert timing.LOG_TREES == 16
    for k in range(20):
        with timing.span("dispatch.first_call", k=k):
            pass
    log = timing.setup_log()
    assert len(log) == 16
    assert [t.spans[0].attrs["k"] for t in log] == list(range(4, 20))


def test_an_error_closes_the_tree():
    before = timing.setup_log()
    with pytest.raises(ValueError):
        with timing.span("multigrid.build"):
            with timing.span("multigrid.level"):
                raise ValueError
    (tree,) = _new_trees(before)
    assert [s.error for s in tree.spans] == ["ValueError", "ValueError"]
    assert timing._tree is None


def test_spans_still_reach_an_open_recording():
    """The recording keeps every span, its own outer ones too, with the
    same names, attributes and nesting as the tree; the drivers' readers
    of a recording (``mg_setup_s``) read the same as before."""
    before = timing.setup_log()
    with timing.recording() as rec:
        with timing.span("solvers.power_step.warmup"):
            hierarchy = multigrid.hpcg(16, 16, 16, depth=2)
    assert len(hierarchy.levels) == 2
    trees = _new_trees(before)
    assert [t.spans[0].name for t in trees] == ["formats.auto_from_coo",
                                                "multigrid.build"]
    assert _names(rec)[0] == "solvers.power_step.warmup"
    assert _names(rec)[1:] == [n for t in trees for n in _names(t)]
    offset = 1
    for t in trees:
        for s, r in zip(t.spans, rec.spans[offset:]):
            assert r.attrs == s.attrs
            assert r.parent == (0 if s.parent < 0 else s.parent + offset)
            assert abs(r.seconds - s.seconds) < 1e-6
        offset += len(t.spans)

    class Run:
        mg_spans = rec
    read = harness.reader("mg_setup_s")
    assert read(Run()) == rec.total_s("multigrid.build")
    assert read(Run()) == pytest.approx(trees[1].spans[0].seconds, abs=1e-6)


def _walk(value):
    if isinstance(value, (tuple, list)):
        for v in value:
            yield from _walk(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from _walk(v)
    else:
        yield value


@pytest.mark.parametrize("build", [
    lambda: (auto_from_coo(poisson2d(20), device="meta"),
             traceable_spmv(auto_from_coo(poisson2d(20)))),
    lambda: auto_from_coo(banded_random(4000, 8, 1500, seed=1),
                          device="meta"),
    lambda: traceable_spmv(auto_from_coo(power_law(20000, 8, seed=0))),
    lambda: auto_from_coo(dense_rows(20_000, 8, num_dense=8,
                                     dense_nnz=3_000, seed=0),
                          device="meta"),
    lambda: multigrid.hpcg(16, 16, 16, depth=2),
], ids=["dia", "ell", "stream", "sell-priced", "hpcg"])
def test_no_tensor_or_array_in_a_logged_attribute(build):
    before = timing.setup_log()
    build()
    trees = _new_trees(before)
    assert trees
    for tree in trees:
        for s in tree.spans:
            for v in _walk(s.attrs):
                assert not isinstance(v, (torch.Tensor, np.ndarray)), \
                    (s.name, v)


def test_uploads_count_bytes_in_an_entry():
    """With no recording open, the chooser's copy to a device is a kept
    ``formats.upload`` with the bytes of the matrix it made."""
    before = timing.setup_log()
    matrix = auto_from_coo(poisson2d(30), device="meta")
    (tree,) = _new_trees(before)
    (up,) = tree.find("formats.upload")
    assert up.attrs == {"fmt": "dia", "bytes": tensor_bytes(matrix)}
    assert tree.spans[up.parent].name == "formats.auto_from_coo"


# -- the child spans ----------------------------------------------------------

def test_the_ell_build_and_upload_children():
    """Padded, to a device: the build's steps, then the upload's copy."""
    with timing.recording() as rec:
        ell_from_coo(geometric_coo(12), sort_rows=True, device="meta")
    assert _children(rec, "formats.build.ell") == [[
        "ell.expand_symmetry", "ell.counts", "ell.fill",
        "ell.narrow_columns"]]
    assert _children(rec, "formats.upload") == [["ell.copy"]]
    assert rec.find("formats.upload")[0].attrs["fmt"] == "ell"


def test_the_sliced_ell_build_children(monkeypatch):
    """Sliced (as on a card; here by making the CPU take the layout): the
    slice plan in the build, then the copy and the slices laid out, side
    by side after it (the upload's children on a card)."""
    from ellspmv_tpu_torch.formats import ell as ell_mod
    monkeypatch.setattr(ell_mod, "_slices_on", lambda device: True)
    with timing.recording() as rec:
        ell = ell_from_coo(geometric_coo(12), sort_rows=True)
    assert ell.slices is not None
    assert _names(rec) == ["formats.build.ell", "ell.expand_symmetry",
                           "ell.counts", "ell.fill", "ell.slice_plan",
                           "ell.copy", "ell.slices"]
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 0, 0, -1, -1]


def test_the_ell_build_on_the_host_copies_outside_its_build():
    with timing.recording() as rec:
        ell_from_coo(banded_random(3000, 8, 500, seed=4),
                     separate_diagonal=True)
    assert _names(rec) == ["formats.build.ell", "ell.expand_symmetry",
                           "ell.counts", "ell.fill", "ell.narrow_columns",
                           "ell.copy"]
    assert rec.spans[-1].parent == -1


@pytest.mark.parametrize("case", ["dia", "too_many"])
def test_the_dia_build_children(case):
    coo = {"dia": poisson2d(20),
           "too_many": random_coo(np.random.RandomState(1), 300, 300,
                                  3000)}[case]
    with timing.recording() as rec:
        dia = dia_from_coo(coo)
    want = (["dia.offsets", "dia.scatter", "dia.mirrored"] if case == "dia"
            else ["dia.offsets"])
    assert (dia is None) is (case == "too_many")
    assert _children(rec, "formats.build.dia") == [want]


@pytest.mark.parametrize("chunks", [None, 3])
def test_the_stream_sum_plan_children(chunks):
    coo = (power_law(3000, 6, seed=2) if chunks is None
           else random_coo(np.random.RandomState(7), 600, 900, 6000))
    with timing.recording() as rec:
        layout = stream_layout(coo, n_chunks=chunks)
    levels = layout.plan.levels
    (plan,) = _children(rec, "stream.sum_plan")
    want = []
    if chunks:
        want += ["stream.chunk_counts"] + ["stream.level"] * chunks + [
            "stream.chunk_splice", "stream.fold"]
        want += ["stream.level", "stream.fold"] * (len(levels) - 1)
    else:
        want += ["stream.level", "stream.fold"] * len(levels)
    assert plan == want + ["stream.attach_maps"]
    i = rec.spans.index(rec.find("stream.sum_plan")[0])
    kids = rec.children(i)
    built = [s.attrs for s in kids if s.name == "stream.level"]
    if chunks:
        assert built[:chunks] == [{"level": 1, "chunk": c}
                                  for c in range(chunks)]
        built = [{"level": 1}] + built[chunks:]
    assert built == [{"level": k + 1} for k in range(len(levels))]
    assert [s.attrs for s in kids if s.name == "stream.fold"] == [
        {"level": k + 1} for k in range(len(levels))]
    assert _children(rec, "stream.attach_maps") == [
        ["stream.tables", "stream.check_sources"] * len(levels)]
    assert _children(rec, "stream.tables") == [
        ["stream.block_schedule"]] * len(levels)


@pytest.mark.parametrize("split", [True, False])
def test_the_sell_price_children(split):
    coo = dense_rows(20_000, 8, num_dense=8, dense_nnz=3_000, seed=0)
    with timing.recording() as rec:
        with timing.span("formats.price.sell"):
            sell_shape(coo, length_sort=True, split_rows=split)
    assert _children(rec, "formats.price.sell") == [
        ["sell_shape.extremes",
         "sell_shape.split" if split else "sell_shape.tail",
         "sell_shape.rows"]]


def test_the_chooser_prices_sell_in_its_children():
    before = timing.setup_log()
    auto_from_coo(power_law(20000, 8, seed=0), value_dtype="float64")
    (tree,) = _new_trees(before)
    (kids,) = _children(tree, "formats.price.sell")
    assert kids[0] == "sell_shape.extremes" and kids[-1] == "sell_shape.rows"
    (plan,) = _children(tree, "stream.sum_plan")
    assert plan[0] == "stream.level" and plan[-1] == "stream.attach_maps"


# -- the benchmark's readers --------------------------------------------------

SMALL = {"lynx68.spmv": {"nx": 16, "extras": 5, "diagonal": 24.0},
         "graph500_s21.spmv": {"scale": 11, "edgefactor": 16, "a": 0.57,
                               "b": 0.19, "c": 0.19},
         "rgg_n_2_24.spmv": {"scale": 12, "radius_factor": 0.55},
         "hpcg_256.pcg": {"nx": 32},
         "npb_cg_c.cg": {"na": 1400, "nonzer": 7, "rcond": 0.1,
                         "shift": 10.0, "niter": 15,
                         "zeta_verify": 8.5971775078648}}
FORMAT = {"lynx68.spmv": "dia", "graph500_s21.spmv": "stream",
          "rgg_n_2_24.spmv": "ell", "hpcg_256.pcg": "dia",
          "npb_cg_c.cg": "ell"}
CELLS = sorted(SMALL)


def _run(workload, program=None, trace=True):
    """A small run of `workload`: its result line, the `Run` its readers
    read, and the run's trees and split as the readers found them (later
    runs log more trees)."""
    seen = []
    real = harness.reader

    def spy(metric):
        read = real(metric)

        def wrapped(run):
            if not seen:
                seen.extend([run, setup_split.run_trees(run),
                             setup_split.split(run)])
            return read(run)
        return wrapped
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(harness, "reader", spy)
        line = harness.run_cell(BENCH, workload, 2**41 + 3, 0.1, trace,
                                device="cpu", program=program,
                                params=SMALL[workload])
    return (line, *seen)


@pytest.fixture(scope="module")
def port_runs():
    return {w: _run(w) for w in CELLS}


@pytest.mark.parametrize("workload", CELLS)
def test_a_traced_run_reports_the_five(workload, port_runs):
    line, _, _, split = port_runs[workload]
    assert line["correct"]
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    assert set(READINGS) <= metrics.keys()
    assert all(line["metrics"][k]["unit"] == "s" for k in READINGS)
    assert {k: metrics[k] for k in READINGS} == split
    assert all(metrics[k] >= 0 for k in READINGS)
    assert metrics["first_call_s"] > 0 and metrics["convert_build_s"] > 0
    assert metrics["upload_s"] == 0.0               # no card: no copy


@pytest.mark.parametrize("workload", CELLS)
def test_the_split_lies_inside_convert_s_and_setup_s(workload, port_runs):
    _, run, trees, split = port_runs[workload]
    root = trees[0].spans[0]
    assert root.name == "formats.auto_from_coo"
    assert root.attrs["choice"] == FORMAT[workload]
    assert (root.attrs["rows"], root.attrs["nonzeros"]) == (run.n, run.nnz)
    parts = (split["convert_build_s"] + split["convert_discarded_s"]
             + split["upload_s"])
    assert parts <= root.seconds <= run.convert_s
    assert split["first_call_s"] == next(
        t.spans[0].seconds for t in trees[1:]
        if t.spans[0].name == "dispatch.first_call")
    spanned = sum(t.spans[0].seconds for t in trees)
    assert split["setup_unspanned_s"] + spanned == pytest.approx(
        run.setup_s, abs=1e-9)
    assert 0 < spanned < run.setup_s
    names = [t.spans[0].name for t in trees]
    want = ["formats.auto_from_coo", "dispatch.first_call"]
    if workload == "hpcg_256.pcg":
        want.append("multigrid.build")
    assert names == want


@pytest.mark.parametrize("workload", CELLS)
def test_the_float32_control_reads_nothing(workload, port_runs):
    """After a port run of the same cell in this process: the control's
    chooser is not the port's, so no tree is the run's."""
    line, run, trees, split = _run(workload,
                                   harness.Reference(torch.float32), False)
    assert not line["correct"]
    assert trees is None and split is None
    for name in READINGS:
        assert harness.reader(name)(run) is None


def test_a_tree_read_by_one_run_is_no_other_runs():
    """Two runs in one process with the same rows and nonzeros: the
    trees go to the run that reads them first, and again to it alone."""
    with timing.span("formats.auto_from_coo", rows=7, nonzeros=9):
        pass

    class Run:
        n, nnz, convert_s, setup_s = 7, 9, 1.0, 2.0
    first, second = Run(), Run()
    trees = setup_split.run_trees(first)
    assert trees == [timing.setup_log()[-1]]
    assert setup_split.run_trees(first) == trees
    assert setup_split.run_trees(second) is None
    assert setup_split.split(second) is None


def test_a_program_without_a_log_reads_nothing(port_runs, monkeypatch):
    """The parent's port, which keeps no log: every reader gives None and
    none raises."""
    run = port_runs["lynx68.spmv"][1]
    assert harness.reader("convert_build_s")(run) is not None
    monkeypatch.delattr(timing, "setup_log")
    for name in READINGS:
        assert harness.reader(name)(run) is None
