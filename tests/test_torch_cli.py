"""The port's `ellspmv` program (``--device=cpu``) against the JAX package's:
identical stdout, identical metrics, identical error texts, on one device
and over ranks (``--devices=N``)."""

import gzip
import io
import itertools
import json
import os
import time

import numpy as np
import pytest
import torch

from ellspmv_tpu.bench.harness import SpmvMetrics as JaxSpmvMetrics
from ellspmv_tpu.cli import ellspmv as jax_ellspmv
from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.io.mtx import read_vector, write_matrix, write_vector
from ellspmv_tpu.models.generators import fem_mesh_2d, poisson2d
from ellspmv_tpu.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.bench.harness import SpmvMetrics, benchmark_spmv
from ellspmv_tpu_torch.cli import ellspmv
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from tests.conftest import assert_fp64_close, random_coo

TEST_MTX = "examples/test.mtx"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def port(argv, capsys):
    return run(ellspmv.main, ["--device=cpu"] + argv, capsys)


@pytest.fixture
def vectors(tmp_path):
    xp, yp = str(tmp_path / "x.mtx"), str(tmp_path / "y.mtx")
    write_vector(xp, np.array([1.0, 2.0, 3.0, 4.0, 5.0]))
    write_vector(yp, np.array([100.0, 100.0, 100.0, 100.0]))
    gz = str(tmp_path / "test.mtx.gz")
    with open(TEST_MTX, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    return {"x": xp, "y": yp, "gz": gz}


@pytest.mark.parametrize("flags,accumulating_calls", [
    ([], 1),
    (["--sort-rows"], 1),
    (["--separate-diagonal"], 1),
    (["--sort-rows", "--separate-diagonal"], 1),
    (["--repeat=3", "--warmup=1"], 4),
    (["--repeat", "2", "--index-width=64"], 2),
    (["--precision=float32"], 1),
    (["-z"], 1),                      # gzip requested, plain file
])
def test_stdout_identical_to_jax(flags, accumulating_calls, capsys):
    rc_j, out_j, err_j = run(jax_ellspmv.main, flags + [TEST_MTX], capsys)
    rc_p, out_p, err_p = port(flags + [TEST_MTX], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j
    y = read_vector(io.BytesIO(out_p.encode()))
    np.testing.assert_array_equal(y, np.array([3, 1, 3, 6.])
                                  * accumulating_calls)


def test_backend_pallas(capsys):
    # the JAX program refuses --backend=pallas off the TPU; the port takes it
    # as the hand-written kernel's path, as --backend=auto
    rc, out, err = port(["--backend=pallas", TEST_MTX], capsys)
    assert rc == 0, err
    assert out == port([TEST_MTX], capsys)[1]


@pytest.mark.parametrize("which", ["xy", "xy_repeat", "gz"])
def test_vector_files_identical_to_jax(which, vectors, capsys):
    if which == "gz":
        argv, want = ["-z", vectors["gz"]], [3, 1, 3, 6]
    else:
        argv = [TEST_MTX, vectors["x"], vectors["y"]]
        want = [107.5, 102, 109, 116]
        if which == "xy_repeat":
            argv = ["--repeat=3", "--warmup=1"] + argv
            # y0 + 4 * A x
            want = [100 + 4 * 7.5, 100 + 4 * 2, 100 + 4 * 9, 100 + 4 * 16]
    rc_j, out_j, _ = run(jax_ellspmv.main, argv, capsys)
    rc_p, out_p, err = port(argv, capsys)
    assert rc_j == rc_p == 0, err
    assert out_p == out_j
    np.testing.assert_array_equal(read_vector(io.BytesIO(out_p.encode())),
                                  want)


def test_verbose_lines(capsys):
    rc, out, err = port(["-q", "-v", "--repeat=2", "--separate-diagonal",
                         TEST_MTX], capsys)
    assert rc == 0 and out == ""
    assert "mtxfile_read:" in err and "ell_from_coo:" in err
    assert "device: cpu" in err
    assert err.count("gemvsd:") == 2
    assert "Gnz/s" in err and "Gflop/s" in err and "GB/s" in err


@pytest.mark.parametrize("round_trip", [10.0, 0.0])
def test_dispatch_warning_as_jax(round_trip, monkeypatch, capsys):
    """With the launch round trip pinned, `-v` prints the JAX program's
    warning line (its `_dispatch_warning` text for the same best time and
    round trip) exactly when the best per_iter time is under 3x the round
    trip; without `-v` it prints none."""
    from ellspmv_tpu.bench.harness import _dispatch_warning as jax_warning
    from ellspmv_tpu_torch.bench import harness
    assert harness.dispatch_round_trip(torch.device("cpu")) > 0
    seen = []
    real = harness._dispatch_warning

    def spy(best, dispatch):
        seen.append((best, dispatch))
        return real(best, dispatch)
    monkeypatch.setattr(harness, "dispatch_round_trip",
                        lambda device: round_trip)
    monkeypatch.setattr(harness, "_dispatch_warning", spy)
    rc, out, err = port(["-v", "--repeat=2", TEST_MTX], capsys)
    assert rc == 0 and len(seen) == 1 and seen[0][1] == round_trip
    want = jax_warning(*seen[0])
    lines = [line for line in err.splitlines() if "warning" in line]
    if round_trip:
        assert want is not None
        assert lines == [f"ellspmv: warning: {want}"]
    else:
        assert want is None and lines == []
    rc, out, err = port(["--repeat=2", TEST_MTX], capsys)
    assert rc == 0 and "warning" not in err


def _with_devices(i, argv, shown, devices=2):
    """A case from before the option `shown` was ported, under its old id:
    it runs beside --devices=N."""
    return pytest.param(argv + [f"--devices={devices}"],
                        f"--devices={devices}", id=f"argv{i}-{shown}")


@pytest.mark.parametrize("argv,shown", [
    _with_devices(0, ["--format=hybrid", "--separate-diagonal"],
                  "--format=hybrid"),
    _with_devices(1, ["--format=hybrid"], "--format=hybrid", 3),
    _with_devices(2, ["--format=hybrid", "--protocol=chained"],
                  "--format=hybrid", 4),
    (["--devices=2", "--protocol=chained"], "--devices=2"),
    (["--devices=4"], "--devices=4"),
    (["--reorder=rcm", "--devices=2"], "--devices=2"),
    _with_devices(6, ["--papi-event-summary"], "--papi-event-summary"),
    _with_devices(7, ["--papi-event-per-thread"], "--papi-event-per-thread"),
    _with_devices(8, ["--papi-event-file=m.metrics"], "--papi-event-file"),
    _with_devices(9, ["--papi-event-format=csv"], "--papi-event-format"),
    _with_devices(10, ["--trace", "trace_dir"], "--trace"),
    _with_devices(11, ["--backend=xla"], "--backend=xla"),
])
def test_unported_options_refused(argv, shown, tmp_path, monkeypatch,
                                  capsys):
    """Each case runs over the ranks (--devices=N, gloo on the CPU; its id
    names the option it was first written for) and does what the JAX
    program does with the same arguments: the same exit code and stdout (exit 1 where JAX
    cannot shard the hybrid, needs a square matrix for the chained
    protocol or RCM, or cannot read the metrics file), the per-device
    report where asked, a trace from every rank."""
    monkeypatch.chdir(tmp_path)          # --trace writes ./trace_dir
    argv = argv + [os.path.join(REPO, TEST_MTX)]
    rc_j, out_j, err_j = run(jax_ellspmv.main, argv, capsys)
    rc_p, out_p, err_p = port(argv, capsys)
    assert shown in argv
    assert rc_p == rc_j, (err_j, err_p)
    assert out_p == out_j
    if "--format=hybrid" in argv:
        assert rc_p == 1 and "unsupported matrix type" in err_p
    if rc_p == 0:
        np.testing.assert_array_equal(
            read_vector(io.BytesIO(out_p.encode())), [3, 1, 3, 6])
    if "--papi-event-per-thread" in argv:
        assert "Per-device workload" in err_p and "Per-device" in err_j
    if "--trace" in argv:
        traces = os.listdir(tmp_path / "trace_dir")
        assert sum(t.endswith(".pt.trace.json") for t in traces) == 2


@pytest.mark.parametrize("argv", [
    ["--repeat=abc"], ["--warmup=x"], ["--precision=float16"],
    ["--index-width=16"], ["--backend=cuda"], ["--protocol=x"],
    ["--format=bogus"], ["--reorder=x"], ["--bogus"], ["--repeat"],
    ["--papi-event-format=xml"],
])
def test_malformed_values_match_jax_errors(argv, capsys):
    tail = [] if argv == ["--repeat"] else [TEST_MTX]
    rc_j, _, err_j = run(jax_ellspmv.main, argv + tail, capsys)
    rc_p, _, err_p = run(ellspmv.main, argv + tail, capsys)
    assert rc_j == rc_p == 1
    assert err_p == err_j


def test_bad_files_report_cleanly(tmp_path, vectors, capsys):
    rc, _, err = port([str(tmp_path / "missing.mtx")], capsys)
    assert rc == 1 and err.startswith("ellspmv: ")
    short = str(tmp_path / "short.mtx")
    write_vector(short, np.ones(3))
    rc, _, err = port([TEST_MTX, short], capsys)
    assert rc == 1 and "expected vector of length 5" in err
    rc, _, err = port([TEST_MTX, vectors["x"], short], capsys)
    assert rc == 1 and "expected vector of length 4" in err


def test_device_flag(monkeypatch, capsys):
    rc, _, err = port(["--device=tpu", TEST_MTX], capsys)
    assert rc == 1 and err == "ellspmv: --device must be cuda or cpu\n"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run(ellspmv.main, [TEST_MTX], capsys)
    assert rc == 1 and out == ""
    assert "--device=cuda: no CUDA device is available" in err


def test_help_usage_and_version(capsys):
    with pytest.raises(SystemExit) as e:
        ellspmv.main(["--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--device=D" in out and "--devices=N" in out
    assert "Not yet ported" not in out
    with pytest.raises(SystemExit) as e:
        ellspmv.main([])
    assert e.value.code == 1 and "Usage:" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        ellspmv.main(["--version"])
    assert "PyTorch port" in capsys.readouterr().out


@pytest.mark.parametrize("precision,separate_diagonal,index_dtype", [
    ("float64", False, "int32"), ("float64", True, "int64"),
    ("float32", True, "int32"), ("float32", False, "int64"),
])
def test_metrics_equal_jax(precision, separate_diagonal, index_dtype):
    coo = random_coo(np.random.RandomState(6), 50, 40, 300, with_dups=True)
    kw = dict(separate_diagonal=separate_diagonal, sort_rows=True,
              value_dtype=precision, index_dtype=index_dtype)
    want = JaxSpmvMetrics.for_matrix(jax_ell_from_coo(coo, **kw))
    got = SpmvMetrics.for_matrix(ell_from_coo(
        CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                  coo.values), **kw))
    assert vars(got) == vars(want)


def test_benchmark_protocol_accumulates():
    coo = random_coo(np.random.RandomState(8), 30, 30, 120)
    ell = ell_from_coo(CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx,
                                 coo.colidx, coo.values))
    x = torch.from_numpy(np.random.RandomState(1).rand(30))
    calls = []

    def counted(m, xv, yv):
        calls.append(yv is None)
        from ellspmv_tpu_torch.ops.dispatch import spmv
        return spmv(m, xv, yv)

    res = benchmark_spmv(counted, ell, x, None, repeat=3, warmup=2)
    # two discarded calls, then warmup + repeat calls that accumulate
    assert len(calls) == 2 + 2 + 3 and len(res.times) == 3
    assert res.device == "cpu" and len(res.iteration_lines()) == 3
    assert_fp64_close(res.y.numpy(), 5 * coo_spmv_numpy(coo, x.numpy()))


def test_slice_fem_mesh_through_both_programs(tmp_path, capsys):
    coo = fem_mesh_2d(24)
    path = str(tmp_path / "fem.mtx")
    write_matrix(path, coo)
    rc_j, out_j, err_j = run(jax_ellspmv.main, ["--sort-rows", path], capsys)
    rc_p, out_p, err_p = port(["--sort-rows", path], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    y_p = read_vector(io.BytesIO(out_p.encode()))
    y_j = read_vector(io.BytesIO(out_j.encode()))
    assert len(y_p) == coo.num_rows
    assert_fp64_close(y_p, y_j)
    assert_fp64_close(y_p, coo_spmv_numpy(coo, np.ones(coo.num_columns)))


@pytest.fixture
def stencil(tmp_path):
    """A 16-row 5-point stencil file: DIA takes it, and so does the
    chooser."""
    path = str(tmp_path / "poisson.mtx")
    write_matrix(path, poisson2d(4))
    return path


@pytest.mark.parametrize("flags", [
    ["--format=dia"],
    ["--format=auto"],
    ["--format=dia", "--repeat=3", "--warmup=1"],
    ["--format=dia", "--precision=float32"],
    ["--format=auto", "--separate-diagonal"],
    ["--format=auto", "-v"],
])
def test_dia_and_auto_stdout_identical_to_jax(flags, stencil, capsys):
    rc_j, out_j, err_j = run(jax_ellspmv.main, flags + [stencil], capsys)
    rc_p, out_p, err_p = port(flags + [stencil], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j
    coo = poisson2d(4)
    calls = 4 if "--repeat=3" in flags else 1
    assert_fp64_close(read_vector(io.BytesIO(out_p.encode())),
                      calls * coo_spmv_numpy(coo, np.ones(16)))


def test_format_dia_on_test_mtx(capsys):
    # the rectangular 4 x 5 example has 6 diagonals
    rc, out, err = port(["--format=dia", "-v", TEST_MTX], capsys)
    assert rc == 0, err
    assert out == run(jax_ellspmv.main, ["--format=dia", TEST_MTX],
                      capsys)[1]
    np.testing.assert_array_equal(read_vector(io.BytesIO(out.encode())),
                                  [3, 1, 3, 6])
    assert "dia_from_coo:" in err and ", 6 diagonals" in err
    assert err.count("gemv_dia:") == 1


def test_format_dia_refuses_too_many_diagonals(tmp_path, capsys):
    path = str(tmp_path / "wide.mtx")
    write_matrix(path, random_coo(np.random.RandomState(0), 60, 60, 600))
    rc_j, out_j, err_j = run(jax_ellspmv.main, ["--format=dia", path],
                             capsys)
    rc_p, out_p, err_p = port(["--format=dia", path], capsys)
    assert rc_j == rc_p == 1 and out_p == out_j == ""
    assert err_p == err_j == ("ellspmv: --format=dia: matrix has too many "
                              "distinct diagonals for DIA\n")


def test_auto_verbose_lines(stencil, capsys):
    rc, out, err = port(["-q", "-v", "--format=auto", stencil], capsys)
    assert rc == 0 and out == ""
    assert "note: --format=auto implies sorted rows" in err
    assert "auto_from_coo [dia]:" in err and "5 dense diagonals" in err
    assert err.count("gemv_dia:") == 1


@pytest.fixture
def clock(monkeypatch):
    """A host clock that advances one second per reading, so that both
    programs' chained protocols see a zero slope and take the same loop
    lengths (2 + 4096 iterations), whatever the machine's speed."""
    ticks = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))


@pytest.mark.parametrize("flags", [
    ["--format=dia"],
    ["--format=auto", "-v"],
    ["--sort-rows"],
])
def test_chained_stdout_identical_to_jax(flags, stencil, clock, capsys):
    argv = ["--protocol=chained"] + flags + [stencil]
    rc_j, out_j, err_j = run(jax_ellspmv.main, argv, capsys)
    rc_p, out_p, err_p = port(argv, capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j
    if "-v" in flags:
        assert ("seconds/iteration (slope over a 4096-iteration chained "
                "span;") in err_p
        assert err_p.count("gemv_dia:") == 1


def _counting(spmv_fn, seconds_per_call, monkeypatch):
    """`spmv_fn` with a host clock that reads `seconds_per_call` times the
    calls made so far: the chained slope then reads exactly that."""
    calls = [0]

    def counted(m, xv, yv):
        calls[0] += 1
        return spmv_fn(m, xv, yv)
    monkeypatch.setattr(time, "perf_counter",
                        lambda: calls[0] * seconds_per_call)
    return counted


@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_chained_y_is_the_numpy_recurrence(fmt, monkeypatch):
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.ops.dispatch import spmv
    coo = poisson2d(6)
    pcoo = CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     coo.values)
    mat = dia_from_coo(pcoo) if fmt == "dia" else ell_from_coo(pcoo)
    x0 = np.random.RandomState(1).rand(36)
    y0 = np.random.RandomState(2).randn(36)
    res = benchmark_spmv(_counting(spmv, 1.0, monkeypatch), mat,
                         torch.from_numpy(x0), torch.from_numpy(y0),
                         repeat=3, warmup=1, protocol="chained")
    # a one-second slope needs no rescale: loops of lo = 1 and lo + hi
    # = 1 + 8 iterations, the y of the last long one
    assert res.protocol == "chained" and res.span_iters == 8
    assert res.times == [1.0, 1.0, 1.0]
    assert len(res.iteration_lines()) == 1
    xk, yk = x0, y0
    for _ in range(1 + 8):
        yk = coo_spmv_numpy(coo, xk, yk)
        xk = 1e-6 * yk
    assert_fp64_close(res.y.numpy(), yk)
    assert res.y.dtype == torch.float64


def test_chained_rescales_towards_a_long_span(monkeypatch):
    ell = ell_from_coo(CooMatrix(4, 4, np.arange(4, dtype=np.int32),
                                 np.arange(4, dtype=np.int32), np.ones(4)),
                       value_dtype="float32")
    res = benchmark_spmv(
        _counting(lambda m, xv, yv: yv + xv, 1e-6, monkeypatch), ell,
        torch.ones(4, dtype=torch.float64), repeat=2, warmup=0,
        protocol="chained")
    # 1 us per iteration: the span grows to 0.3 s, capped at 4096
    assert res.span_iters == 4096
    assert res.times[0] == pytest.approx(1e-6)
    # the carry is in the values' type
    assert res.y.dtype == torch.float32
    # y_1 = x0, then y <- y + x with x <- 1e-6*y, in float32
    want = np.float32(1)
    for _ in range(4097):
        want = want + want * np.float32(1e-6)
    assert res.y[0].item() == pytest.approx(float(want), rel=1e-6)
    with pytest.raises(ValueError, match="square"):
        benchmark_spmv(None, ell_from_coo(random_coo(
            np.random.RandomState(0), 5, 4, 8)), torch.ones(4),
            protocol="chained")
    with pytest.raises(ValueError, match="unknown protocol"):
        benchmark_spmv(None, ell, torch.ones(4, dtype=torch.float32),
                       protocol="other")


def test_headline_on_the_cpu(monkeypatch, capsys):
    from ellspmv_tpu_torch.bench import headline
    monkeypatch.setenv("BENCH_ROWS", "4096")
    assert headline.main(["--device=cpu"]) == 0
    out = capsys.readouterr()
    lines = out.out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert sorted(got) == ["metric", "unit", "value", "vs_baseline"]
    assert got["metric"] == "spmv_fp64_effective_bandwidth"
    assert got["unit"] == "GB/s" and got["value"] > 0
    assert got["vs_baseline"] == round(got["value"] / 148.0, 3)
    assert "format=dia" in out.err and "4096 rows" in out.err
    assert "no device-memory peak known for cpu" in out.err


def test_headline_needs_a_card_or_the_cpu(monkeypatch, capsys):
    from ellspmv_tpu_torch.bench import headline
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert headline.main([]) == 1
    assert "no CUDA device is available" in capsys.readouterr().err
    assert headline.main(["--device=tpu"]) == 1
    assert headline.main(["--bogus"]) == 1


@pytest.fixture
def integer_matrix(tmp_path):
    """A 300 x 280 file with small-integer values: with x = ones every sum
    is exact, in the JAX package's double-double and f32 as in fp64."""
    rng = np.random.RandomState(21)
    coo = random_coo(rng, 300, 280, 3000)
    coo.values = rng.randint(-5, 6, coo.num_nonzeros).astype(np.float64)
    path = str(tmp_path / "integer.mtx")
    write_matrix(path, coo)
    return path, coo


@pytest.mark.parametrize("flags", [
    ["--format=stream"],
    ["--format=stream", "--separate-diagonal", "--repeat=2"],
    ["--format=stream", "--precision=float32"],
])
def test_stream_stdout_identical_to_jax(flags, integer_matrix, capsys):
    path, coo = integer_matrix
    rc_j, out_j, err_j = run(jax_ellspmv.main, flags + [path], capsys)
    rc_p, out_p, err_p = port(flags + ["-v", path], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j
    calls = 2 if "--repeat=2" in flags else 1
    np.testing.assert_array_equal(
        read_vector(io.BytesIO(out_p.encode())),
        calls * coo_spmv_numpy(coo, np.ones(coo.num_columns)))
    assert "stream_from_coo:" in err_p and " 1 sum levels" in err_p
    assert err_p.count("gemv_stream:") == calls


def test_auto_chooses_stream(tmp_path, capsys):
    # one row of 300 entries over 20,000 rows: ELLPACK padding blows up
    n = 20_000
    rows = np.concatenate([np.arange(n), np.zeros(299, np.int64)])
    cols = np.concatenate([np.arange(n), np.arange(1, 300)])
    coo = CooMatrix(n, n, rows.astype(np.int32), cols.astype(np.int32),
                    np.ones(len(rows)))
    path = str(tmp_path / "blowup.mtx")
    write_matrix(path, coo)
    rc, out, err = port(["--format=auto", "-v", path], capsys)
    assert rc == 0, err
    assert "auto_from_coo [stream]:" in err and "ELL padding blowup" in err
    assert err.count("gemv_stream:") == 1
    np.testing.assert_array_equal(read_vector(io.BytesIO(out.encode())),
                                  coo_spmv_numpy(coo, np.ones(n)))
