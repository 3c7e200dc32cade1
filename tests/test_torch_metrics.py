"""The port's derived-metric files (``bench/metrics.py``), its roofline
summary and its trace against the JAX package's: the parser, the formula
trees and both printers on ``examples/tpu_membw.metrics`` and on the
malformed inputs of tests/test_metrics.py, and ``ellspmv`` with
``--papi-event-file``, ``--papi-event-summary``, ``--papi-event-format``,
``--papi-event-per-thread`` and ``--trace=DIR`` against the JAX program:
stdout identical, stderr the same lines but where the two differ by design
(the times; the CPU has no device memory, so the port's roofline fields
read "not measured" where the JAX program divides by a TPU's peak)."""

import io
import math
import os

import pytest

from ellspmv_tpu.bench import metrics as jax_metrics
from ellspmv_tpu.cli import ellspmv as jax_ellspmv
from ellspmv_tpu_torch.bench import metrics
from ellspmv_tpu_torch.cli import ellspmv
from ellspmv_tpu_torch.utils.timing import PhaseTimer
from ellspmv_tpu_torch.utils.trace import device_trace

EXAMPLE = "examples/tpu_membw.metrics"
TEST_MTX = "examples/test.mtx"

GOOD = [
    "A = 1 + 2 * 3",
    "B [u] = (1 + 2) * 3",
    "C = -nnz / time",
    "D [GB/s] = min_bytes / TIME / 1e9",
    "E = 2 - 3 - 4",
    "F = 8 / 4 / 2",
    "G = .5e1 * flops",
    "H = nnz / 0",
]
BAD = ["X = )broken(", "X = 1 +", "X = (1 + 2", "noequals", "X = 1 $ 2",
       "X = 1 2"]
EVENTS = {"time": 0.5, "nnz": 9.0, "flops": 18.0, "min_bytes": 2e9,
          "max_bytes": 3e9, "iterations": 3.0, "devices": 1.0,
          "hbm_peak_bytes": 3.35e12}


@pytest.mark.parametrize("line", GOOD)
def test_formulas_evaluate_as_jax(line):
    want = jax_metrics.parse_formula(line)
    got = metrics.parse_formula(line)
    assert (got.name, got.unit) == (want.name, want.unit)
    a, b = got.expr.evaluate(EVENTS), want.expr.evaluate(EVENTS)
    assert a == b or (math.isinf(a) and math.isinf(b))


@pytest.mark.parametrize("line", BAD)
def test_malformed_formulas_refused_as_jax(line):
    with pytest.raises(jax_metrics.MetricsError) as want:
        jax_metrics.parse_formula(line)
    with pytest.raises(metrics.MetricsError) as got:
        metrics.parse_formula(line)
    assert str(got.value) == str(want.value)


def test_unknown_event_refused_as_jax():
    want = jax_metrics.parse_formula("X = bogus * 2")
    got = metrics.parse_formula("X = bogus * 2")
    with pytest.raises(jax_metrics.MetricsError) as e_want:
        want.expr.evaluate(EVENTS)
    with pytest.raises(metrics.MetricsError) as e_got:
        got.expr.evaluate(EVENTS)
    assert str(e_got.value) == str(e_want.value)


@pytest.mark.parametrize("text", [
    None,                                  # the shipped example file
    "# comment\nnnz\nflops\nFormulas:\nT [Gnz/s] = nnz / time / 1e9\n",
    "nnz  # trailing comment\n\nFORMULAS\nX = 1\n",
    "Formulas:\n",
])
@pytest.mark.parametrize("fmt", ["plain", "csv"])
def test_files_read_and_report_as_jax(text, fmt):
    def read(mod):
        if text is None:
            return mod.read_metrics_file(EXAMPLE)
        return mod.read_metrics_file(io.StringIO(text))
    want, got = read(jax_metrics), read(metrics)
    assert got.events == want.events
    assert [(f.name, f.unit) for f in got.formulas] == \
        [(f.name, f.unit) for f in want.formulas]
    out_j, out_p = io.StringIO(), io.StringIO()
    jax_metrics.report(want, dict(EVENTS), out_j, fmt=fmt, region="gemv")
    metrics.report(got, dict(EVENTS), out_p, fmt=fmt, region="gemv")
    assert out_p.getvalue() == out_j.getvalue()


def test_malformed_file_refused_as_jax(tmp_path):
    bad = tmp_path / "bad.metrics"
    bad.write_text("Formulas:\nX = )broken(\n")
    with pytest.raises(jax_metrics.MetricsError) as want:
        jax_metrics.read_metrics_file(str(bad))
    with pytest.raises(metrics.MetricsError) as got:
        metrics.read_metrics_file(str(bad))
    assert str(got.value) == str(want.value)


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _labels(err):
    """Each stderr line up to its first number: what the line reports."""
    out = []
    for line in err.splitlines():
        cut = len(line)
        for i, ch in enumerate(line):
            if ch.isdigit() or ch == "-" and line[i + 1:i + 2].isdigit():
                cut = i
                break
        out.append(line[:cut])
    return out


@pytest.mark.parametrize("flags", [
    ["--papi-event-file=" + EXAMPLE],
    ["--papi-event-file=" + EXAMPLE, "--papi-event-format=csv"],
    ["--papi-event-summary"],
    ["--papi-event-summary", "--papi-event-format=csv"],
    ["--papi-event-per-thread", "--repeat=2"],
])
def test_papi_reports_as_jax(flags, capsys):
    rc_j, out_j, err_j = run(jax_ellspmv.main, flags + [TEST_MTX], capsys)
    rc_p, out_p, err_p = run(ellspmv.main, ["--device=cpu"] + flags
                             + [TEST_MTX], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j
    # the port counts its kernels' bytes on every format (bench/traffic);
    # the JAX program off the TPU has no plan to count them by
    lines_j, lines_p = err_j.splitlines(), err_p.splitlines()
    if "--papi-event-summary" in flags and \
            "--papi-event-format=csv" not in flags:
        assert any(line.startswith("  physical traffic: ")
                   for line in lines_p)
        lines_j, lines_p = ([line for line in lines
                             if not line.startswith("  physical traffic: ")]
                            for lines in (lines_j, lines_p))
    assert len(lines_p) == len(lines_j)
    if "--papi-event-format=csv" in flags:
        assert lines_p[0] == lines_j[0]           # the same header
        row_j, row_p = lines_j[1].split(","), lines_p[1].split(",")
        head = lines_j[0].split(",")
        # a field per column: the port has its bytes (JAX's row, without
        # them, ends short)
        assert len(row_p) == len(head)
        for name, a, b in zip(head, row_j, row_p):
            if name in ("region", "repeat", "nonzeros", "flops",
                        "min_bytes", "max_bytes"):
                assert a == b, name
            if name in ("hbm_peak_gb_per_s", "roofline_fraction",
                        "physical_roofline", "Roofline"):
                assert b in ("", "nan"), name      # not measured
        return
    got, want = _labels("\n".join(lines_p)), _labels("\n".join(lines_j))
    for g, w in zip(got, want):
        if w.strip().startswith(("HBM roofline:", "physical traffic:",
                                 "Roofline")):
            continue
        assert g == w
    if "--papi-event-summary" in flags:
        assert "  HBM roofline: not measured (no device memory on the " \
               "CPU)" in lines_p
    for line in lines_j:
        if line.strip().startswith(("nnz:", "flops:", "min_bytes:",
                                    "max_bytes:", "nonzeros:",
                                    "bytes/iter:", "Region:")):
            assert line in lines_p


def test_bad_metrics_file_exits_as_jax(tmp_path, capsys):
    bad = tmp_path / "bad.metrics"
    bad.write_text("Formulas:\nX = )broken(\n")
    argv = ["-q", f"--papi-event-file={bad}", TEST_MTX]
    rc_j, _, err_j = run(jax_ellspmv.main, argv, capsys)
    rc_p, _, err_p = run(ellspmv.main, ["--device=cpu"] + argv, capsys)
    assert rc_j == rc_p == 1
    assert err_p == err_j


def test_trace_writes_a_chrome_trace(tmp_path, capsys):
    trace = tmp_path / "trace"
    rc_j, out_j, _ = run(jax_ellspmv.main, ["--repeat=2", TEST_MTX], capsys)
    rc, out, err = run(ellspmv.main, ["--device=cpu", f"--trace={trace}",
                                      "--repeat=2", TEST_MTX], capsys)
    assert rc == rc_j == 0, err
    assert out == out_j
    files = os.listdir(trace)
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    text = (trace / files[0]).read_text()
    assert '"traceEvents"' in text and "aten::" in text


def test_device_trace_without_a_directory_is_a_no_op(tmp_path):
    with device_trace(None):
        pass
    with device_trace(""):
        pass
    assert os.listdir(tmp_path) == []


def test_phase_timer_as_jax():
    from ellspmv_tpu.utils.timing import PhaseTimer as JaxPhaseTimer
    logs = []
    for cls in (JaxPhaseTimer, PhaseTimer):
        out = io.StringIO()
        t = cls(verbose=True, stream=out)
        for _ in range(2):
            with t.phase("mtxfile_read", extra="x"):
                pass
        with pytest.raises(KeyError):
            with t.phase("fails"):
                raise KeyError
        logs.append((sorted(t.times), [line.split(":")[0] + line[-3:]
                                       for line in
                                       out.getvalue().splitlines()]))
    assert logs[0] == logs[1]
    assert logs[1][0] == ["fails", "mtxfile_read"]
