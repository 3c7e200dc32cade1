"""The port's span recorder (``ellspmv_tpu_torch/utils/timing.py``) and the
spans of its set-up, on the CPU: what is kept with recording on and off,
nesting and self time, the profiler's clock, the chooser's candidates, the
copies to a device (the meta device stands in for a card), the first
call, and the programs' phase lines."""

import importlib.util
import json
import os
import re
import time

import pytest
import torch

from ellspmv_tpu.cli import ellspmv as jax_ellspmv
from ellspmv_tpu_torch.cli import ellspmv
from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.dia import dia_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.formats.sell import sell_from_coo
from ellspmv_tpu_torch.formats.stream import stream_from_coo
from ellspmv_tpu_torch.models.generators import (banded_random, poisson2d,
                                                 power_law)
from ellspmv_tpu_torch.ops.dispatch import spmv, traceable_spmv
from ellspmv_tpu_torch.utils import timing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "setup_spans", os.path.join(REPO, "scripts", "setup_spans.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _names(rec):
    return {s.name for s in rec.spans}


@pytest.fixture(scope="module")
def skewed():
    """A power-law matrix whose ELL padding blows up (the SELL split
    against the stream format)."""
    return power_law(20000, 8, seed=0)


def test_off_returns_one_shared_object_and_keeps_nothing():
    assert timing._active is None
    first = timing.span("formats.counts", rows=3)
    assert first is timing.span("other") is timing.NOTHING
    with first as s:
        s.set(bytes=1)
    with timing.recording() as rec:
        pass
    with timing.span("after"):
        pass
    assert rec.spans == [] and timing._active is None


def test_nesting_parents_self_time_and_errors(monkeypatch):
    ticks = iter(range(0, 10**6, 10))
    monkeypatch.setattr(time, "perf_counter_ns", lambda: next(ticks))
    with timing.recording() as rec:
        with timing.span("a.root", k=1) as root:          # 10 .. 80
            with timing.span("a.child"):                   # 20 .. 30
                pass
            with pytest.raises(KeyError):
                with timing.span("b.fails"):               # 40 .. 70
                    with timing.span("a.inner"):           # 50 .. 60
                        raise KeyError
            root.set(choice="x")
    names = [s.name for s in rec.spans]
    assert names == ["a.root", "a.child", "b.fails", "a.inner"]
    assert [s.parent for s in rec.spans] == [-1, 0, 0, 2]
    assert rec.spans[0].attrs == {"k": 1, "choice": "x"}
    assert [s.error for s in rec.spans] == [None, None, "KeyError",
                                            "KeyError"]
    assert rec.spans[0].seconds == pytest.approx(70e-9)
    assert rec.self_s("a.root") == pytest.approx(30e-9)
    assert rec.self_s("b.fails") == pytest.approx(20e-9)
    # a.inner lies inside b.fails, not inside another a. span
    assert rec.total_s("a.") == pytest.approx(70e-9)
    assert rec.total_s("b.") == pytest.approx(30e-9)
    assert rec.total_s("none") == 0.0
    assert rec.children(0) == rec.spans[1:3]
    assert rec.within(3, "b.") and not rec.within(1, "b.")


def test_spans_are_on_the_epoch_clock():
    with timing.recording() as rec:
        with timing.span("a.step"):
            now = time.time_ns()
    assert abs(rec.spans[0].start_ns - now) < 50_000_000


def test_a_span_shows_in_the_profilers_trace():
    from torch.profiler import ProfilerActivity, profile, record_function
    with timing.recording() as rec:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("warm-up"):
                pass
            with timing.span("formats.price.ell"):
                sum(range(10000))
    (span,) = rec.spans
    (event,) = [e for e in prof.profiler.kineto_results.events()
                if e.name() == "formats.price.ell"]
    assert abs(event.start_ns() - span.start_ns) < 1_000_000
    # outside a profiler no function is recorded for the profiler
    with timing.recording() as rec:
        with timing.span("formats.price.ell") as s:
            assert s.profiled is None


def test_phase_timer_phases_are_spans():
    timer = timing.PhaseTimer()
    with timing.recording() as rec:
        with timer.phase("mtxfile_read"):
            with timing.span("formats.counts"):
                pass
    assert [s.name for s in rec.spans] == ["mtxfile_read", "formats.counts"]
    assert rec.spans[1].parent == 0
    assert timer.times["mtxfile_read"] >= rec.spans[0].seconds


def test_skewed_matrix_records_both_candidates(skewed):
    """Both candidates are priced; the SELL split is priced by its shape
    and built (its build spans recorded) only where it is chosen."""
    with timing.recording() as rec:
        matrix = auto_from_coo(skewed, value_dtype="float64")
        traceable_spmv(matrix)
    (root,) = rec.find("formats.auto_from_coo")
    choice = root.attrs["choice"]
    assert choice == matrix._auto_choice in ("sell", "stream")
    assert root.attrs["rows"] == 20000
    assert root.attrs["nonzeros"] == skewed.num_nonzeros
    assert {"formats.counts", "formats.build.stream", "formats.price.sell",
            "formats.price.stream", "stream.argsort", "stream.sum_plan",
            "stream.position_order", "dispatch.first_call"} <= _names(rec)
    (price,) = rec.find("formats.price.sell")
    assert price.attrs["built"] is False
    assert price.attrs["buckets"] > 0 and price.attrs["slots"] > 0
    sell_build = {"formats.build.sell", "sell.row_sort", "sell.pack"}
    if choice == "sell":
        assert sell_build <= _names(rec)
    else:
        assert not sell_build & _names(rec)
    assert "formats.upload" not in _names(rec)      # the host builds it
    assert all(s.parent == 0 for s in rec.spans
               if s.name.startswith(("formats.price", "formats.counts")))
    for name in ("stream.argsort", "stream.sum_plan",
                 "stream.position_order"):
        (s,) = rec.find(name)
        assert rec.spans[s.parent].name == "formats.build.stream"
    split = _script().convert_split(rec)
    other = "sell" if choice == "stream" else "stream"
    assert split["convert_discarded_s"] == pytest.approx(
        rec.total_s(f"formats.build.{other}")
        + rec.total_s(f"formats.price.{other}"))
    if choice == "stream":
        # what is discarded is the SELL price alone
        assert split["convert_discarded_s"] == pytest.approx(price.seconds)
    assert split["convert_build_s"] > 0 and split["upload_s"] == 0.0
    assert split["first_call_s"] == rec.find("dispatch.first_call")[0].seconds
    children = sum(c.seconds for c in rec.children(0))
    assert children <= root.seconds


def test_banded_matrix_records_the_dia_build_and_the_ell_price():
    with timing.recording() as rec:
        matrix = auto_from_coo(poisson2d(30), value_dtype="float64")
    assert matrix._auto_choice == "dia"
    assert rec.find("formats.auto_from_coo")[0].attrs["choice"] == "dia"
    assert {"formats.build.dia", "formats.price.ell",
            "formats.price.dia"} <= _names(rec)
    assert not any(s.name.startswith("formats.build.")
                   and s.name != "formats.build.dia" for s in rec.spans)
    split = _script().convert_split(rec)
    assert split["convert_discarded_s"] == pytest.approx(
        rec.total_s("formats.price.ell") + rec.total_s("formats.price.stream"))


@pytest.mark.parametrize("case", ["dia", "stream", "ell"])
def test_copies_to_a_device_are_uploads(case, skewed):
    coo = {"dia": poisson2d(30), "stream": skewed,
           "ell": banded_random(5000, 8, 2000, seed=1)}[case]
    with timing.recording() as rec:
        matrix = auto_from_coo(coo, value_dtype="float64", device="meta")
    assert matrix._auto_choice == case and matrix.device.type == "meta"
    uploads = rec.find("formats.upload")
    assert uploads and {s.attrs["fmt"] for s in uploads} == {case}
    # every upload follows the candidates' host work, outside it
    assert not any(rec.within(rec.spans.index(s), "formats.build.")
                   for s in uploads)
    from ellspmv_tpu_torch.formats import tensor_bytes
    assert sum(s.attrs["bytes"] for s in uploads) == tensor_bytes(matrix)


def test_moving_a_built_format_is_an_upload():
    sell = sell_from_coo(power_law(3000, 8, seed=2), length_sort=True)
    with timing.recording() as rec:
        sell.to("meta")
        sell.to("cpu")
    # the buckets' copies are part of the SELL upload, not uploads of ELL
    (s,) = rec.spans
    assert s.name == "formats.upload" and s.attrs["fmt"] == "sell"
    from ellspmv_tpu_torch.formats import tensor_bytes
    assert s.attrs["bytes"] == tensor_bytes(sell)


def test_no_bytes_are_counted_outside_a_recording(monkeypatch):
    import ellspmv_tpu_torch.formats as formats

    def counted(obj):
        raise AssertionError("bytes counted with recording off")
    sell = sell_from_coo(power_law(3000, 8, seed=2), length_sort=True)
    monkeypatch.setattr(formats, "tensor_bytes", counted)
    assert timing.open_spans() is None
    sell.to("meta")
    auto_from_coo(poisson2d(30), value_dtype="float64", device="meta")


def _tensors(obj, prefix=""):
    """(path, tensor) for each tensor a format holds."""
    if isinstance(obj, torch.Tensor):
        yield prefix, obj
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            yield from _tensors(getattr(obj, name), f"{prefix}.{name}")
    elif isinstance(obj, (list, tuple)):
        for i, item in enumerate(obj):
            yield from _tensors(item, f"{prefix}[{i}]")


@pytest.mark.parametrize("build", [
    lambda: auto_from_coo(poisson2d(20), value_dtype="float64"),
    lambda: auto_from_coo(power_law(20000, 8, seed=0)),
    lambda: auto_from_coo(banded_random(4000, 8, 1500, seed=1),
                          value_dtype="float32"),
    lambda: dia_from_coo(poisson2d(12), value_dtype="bfloat16"),
    lambda: ell_from_coo(power_law(3000, 8, seed=3), sort_rows=True),
    lambda: sell_from_coo(power_law(3000, 8, seed=4), length_sort=True),
    lambda: stream_from_coo(power_law(3000, 8, seed=5),
                            separate_diagonal=True),
], ids=["auto-dia", "auto-skewed", "auto-ell-f32", "dia-bf16", "ell",
        "sell", "stream-diagonal"])
def test_formats_are_the_same_with_recording_on_and_off(build):
    off = build()
    with timing.recording() as rec:
        on = build()
    assert rec.spans
    a, b = dict(_tensors(off)), dict(_tensors(on))
    assert a.keys() == b.keys() and a
    for path in a:
        assert a[path].dtype == b[path].dtype, path
        assert torch.equal(a[path], b[path]), path


def test_no_span_per_multiply():
    matrix = auto_from_coo(poisson2d(10), value_dtype="float64")
    operand, fn = traceable_spmv(matrix)
    x = torch.ones(100, dtype=torch.float64)
    with timing.recording() as rec:
        for _ in range(3):
            fn(operand, x)
            spmv(operand, x, x)
    assert rec.spans == []


def test_the_first_call_is_a_span():
    matrix = auto_from_coo(power_law(3000, 8, seed=6))
    with timing.recording() as rec:
        operand, fn = traceable_spmv(matrix)
    (s,) = rec.spans
    assert s.name == "dispatch.first_call" and s.error is None


def test_the_script_splits_a_run_of_the_harness(capsys):
    """`scripts/setup_spans.py` on a small lynx68 cell: with recording on,
    the split of the set-up and the root span inside `convert_s`; with it
    off, the run alone. Either way the cost of a span."""
    keys = {"convert_discarded_s", "convert_build_s", "upload_s",
            "first_call_s", "root_s", "root_cover", "spans", "format"}
    for record in (1, 0):
        assert _script().main([
            "--workload", "lynx68.spmv", "--seed", str(2**35 + record),
            "--record", str(record), "--seconds", "0.2", "--device", "cpu",
            "--params", '{"nx": 16, "extras": 5, "diagonal": 24.0}']) == 0
        lines = capsys.readouterr().out.splitlines()
        out = json.loads(lines[-1])
        assert out["correct"] and out["device"] == "cpu"
        assert out["span_ns"]["on"] > 0 and out["span_ns"]["off"] < 10**5
        tabled = any(line.startswith("span formats.auto_from_coo: 1 calls")
                     for line in lines)
        if record:
            assert keys <= out.keys() and tabled
            assert out["format"] == "dia" and out["spans"] >= 5
            assert 0 < out["root_s"] <= out["convert_s"]
            assert out["convert_build_s"] > 0 and out["upload_s"] == 0.0
        else:
            assert not keys & out.keys() and not tabled


def _phase_lines(err):
    """The four phase lines, numbers masked."""
    keep = ("mtxfile_read:", "reorder_rcm:", "ell_from_coo:",
            "mtxfile_write:")
    return [re.sub(r"\d+(\.\d+)?", "N", line)
            for line in err.splitlines() if line.startswith(keep)]


def test_cli_phase_lines_are_the_jax_programs(capsys):
    argv = ["-v", "--reorder=rcm", "examples/test_spd.mtx"]
    assert jax_ellspmv.main(argv) == 0
    want = _phase_lines(capsys.readouterr().err)
    assert ellspmv.main(["--device=cpu"] + argv) == 0
    got = _phase_lines(capsys.readouterr().err)
    assert len(want) == 4 and got == want
