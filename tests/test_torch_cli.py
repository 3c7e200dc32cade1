"""The port's `ellspmv` program (``--device=cpu``) against the JAX package's:
identical stdout, identical metrics, identical error texts, and a clean
refusal of every option not yet ported."""

import gzip
import io

import numpy as np
import pytest
import torch

from ellspmv_tpu.bench.harness import SpmvMetrics as JaxSpmvMetrics
from ellspmv_tpu.cli import ellspmv as jax_ellspmv
from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.io.mtx import read_vector, write_matrix, write_vector
from ellspmv_tpu.models.generators import fem_mesh_2d
from ellspmv_tpu.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.bench.harness import SpmvMetrics, benchmark_spmv
from ellspmv_tpu_torch.cli import ellspmv
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from tests.conftest import assert_fp64_close, random_coo

TEST_MTX = "examples/test.mtx"


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


@pytest.mark.parametrize("argv,shown", [
    (["--format=dia"], "--format=dia"),
    (["--format=auto"], "--format=auto"),
    (["--format=stream"], "--format=stream"),
    (["--protocol=chained"], "--protocol=chained"),
    (["--devices=4"], "--devices=4"),
    (["--reorder=rcm"], "--reorder=rcm"),
    (["--papi-event-summary"], "--papi-event-summary"),
    (["--papi-event-per-thread"], "--papi-event-per-thread"),
    (["--papi-event-file=m.metrics"], "--papi-event-file"),
    (["--papi-event-format=csv"], "--papi-event-format"),
    (["--trace", "trace_dir"], "--trace"),
    (["--backend=xla"], "--backend=xla"),
])
def test_unported_options_refused(argv, shown, capsys):
    rc, out, err = port(argv + [TEST_MTX], capsys)
    assert rc == 1 and out == ""
    assert err == f"ellspmv: {shown} is not yet ported (see ROADMAP.md)\n"


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
    assert "--device=D" in out and "Not yet ported" in out
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
