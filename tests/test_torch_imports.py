"""The port's import boundary and its kernel wrapper's contract on the CPU.

`ellspmv_tpu_torch` must import neither jax, ml_dtypes nor the JAX package,
and importing it must build nothing. The wrapper runs the plain version for
CPU tensors only and refuses what the kernel does not take; the kernel itself
is checked on the card (the ``cuda`` test below, and ``chip_smoke.py``).
"""

import ast
import collections
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ellspmv_tpu_torch.formats.dia import dia_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.models.generators import banded_random, poisson2d
from ellspmv_tpu_torch.ops import _build, dia_cuda, ell_cuda
from torch_cases import diagonal_coo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# Imports every module of the port (and chip_smoke) in a fresh interpreter,
# with subprocesses forbidden, runs the CPU path once, and reports what was
# imported and whether anything was built.
_CHILD = r"""
import importlib, json, pkgutil, subprocess, sys

def _no_subprocess(*a, **k):
    raise AssertionError("a subprocess was started: %r" % (a,))

subprocess.run = subprocess.Popen = _no_subprocess
import ellspmv_tpu_torch
names = ["ellspmv_tpu_torch", "chip_smoke"] + [
    m.name for m in pkgutil.walk_packages(ellspmv_tpu_torch.__path__,
                                          "ellspmv_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from ellspmv_tpu_torch.io import native
native_after_import = sorted(native._state)

import torch
from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.models.generators import poisson2d
from ellspmv_tpu_torch.models.solvers import cg
from ellspmv_tpu_torch.formats.stream import stream_from_coo, stream_spmv
from ellspmv_tpu_torch.ops import (_build, dia_cuda, dot_cuda, ell_cuda,
                                   permute, stream_sum)
ell = ell_from_coo(poisson2d(4))
ell_cuda.ell_spmv(ell, torch.ones(16, dtype=torch.float64))
ell_cuda.fma_probe(*ell_cuda.probe_inputs("cpu"))
dia = auto_from_coo(poisson2d(4), value_dtype="float64")
dia_cuda.dia_spmv(dia, torch.ones(16, dtype=torch.float64))
solved = cg(lambda v: ell_cuda.ell_spmv(ell, v),
            torch.ones(16, dtype=torch.float64))
streamed = stream_spmv(stream_from_coo(poisson2d(4)),
                       torch.ones(16, dtype=torch.float64))
from ellspmv_tpu_torch.formats.csr import csr_from_coo
from ellspmv_tpu_torch.formats.sell import sell_from_coo, sell_spmv
from ellspmv_tpu_torch.ops.csr import csr_spmv
sold = sell_spmv(sell_from_coo(poisson2d(4), length_sort=True),
                 torch.ones(16, dtype=torch.float64))
csred = csr_spmv(csr_from_coo(poisson2d(4), separate_diagonal=True),
                 torch.ones(16, dtype=torch.float64))
from ellspmv_tpu_torch.formats.hybrid import hybrid_from_coo, hybrid_spmv
hub = hybrid_from_coo(poisson2d(4), hub_width=8)
hybrid = hybrid_spmv(hub, torch.ones(16, dtype=torch.float64))
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                    "ellspmv_tpu"))
print(json.dumps({"modules": names, "bad": bad,
                  "loaded": _build.load.cache_info().currsize,
                  "launches": ell_cuda.launches,
                  "dia_launches": dia_cuda.launches,
                  "dot_launches": dot_cuda.launches,
                  "cg_iterations": solved.iterations,
                  "streamed": streamed.tolist(),
                  "sold": sold.tolist(), "csred": csred.tolist(),
                  "hybrid": hybrid.tolist(), "hub": hub.hub is not None,
                  "stream_launches": (permute.launches + stream_sum.launches
                                      + stream_sum.product_launches),
                  "chosen": dia._auto_choice,
                  "probe_launches": ell_cuda.probe_launches,
                  "native_after_import": native_after_import,
                  "native_state": {k: repr(v)
                                   for k, v in native._state.items()},
                  "probed": len(ell_cuda.FMA_PROBE_RESULTS)}))
"""


@pytest.fixture(scope="module")
def child():
    """One fresh interpreter on a PATH without nvcc or g++ and a CUDA_HOME
    that does not exist, as on a machine without the CUDA toolkit and a
    C++ compiler."""
    env = dict(os.environ, CUDA_HOME=os.path.join(REPO, "no-such-cuda"),
               PATH=os.path.join(REPO, "no-such-bin"))
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_no_jax(child):
    assert child["bad"] == []
    expected = {"ellspmv_tpu_torch.cli.common", "ellspmv_tpu_torch.cli.ellspmv",
                "ellspmv_tpu_torch.ops.ell_cuda", "ellspmv_tpu_torch.ops._build",
                "ellspmv_tpu_torch.bench.harness",
                "ellspmv_tpu_torch.ops.dispatch",
                "ellspmv_tpu_torch.io.mtx", "ellspmv_tpu_torch.formats.ell",
                "ellspmv_tpu_torch.models.generators", "chip_smoke",
                "ellspmv_tpu_torch.config", "ellspmv_tpu_torch.formats.dia",
                "ellspmv_tpu_torch.formats.auto",
                "ellspmv_tpu_torch.ops.dia_cuda",
                "ellspmv_tpu_torch.bench.traffic",
                "ellspmv_tpu_torch.bench.headline",
                "ellspmv_tpu_torch.models.reorder",
                "ellspmv_tpu_torch.models.solvers",
                "ellspmv_tpu_torch.ops.dot_cuda",
                "ellspmv_tpu_torch.cli.cgsolve",
                "ellspmv_tpu_torch.formats.stream",
                "ellspmv_tpu_torch.ops.stream_sum",
                "ellspmv_tpu_torch.ops.permute",
                "ellspmv_tpu_torch.formats.csr",
                "ellspmv_tpu_torch.formats.sell",
                "ellspmv_tpu_torch.ops.csr",
                "ellspmv_tpu_torch.cli.csrspmv",
                "ellspmv_tpu_torch.formats.hybrid",
                "ellspmv_tpu_torch.bench.metrics",
                "ellspmv_tpu_torch.bench.stream",
                "ellspmv_tpu_torch.bench.suite",
                "ellspmv_tpu_torch.utils.trace",
                "ellspmv_tpu_torch.utils.timing",
                "ellspmv_tpu_torch.parallel",
                "ellspmv_tpu_torch.parallel.mesh",
                "ellspmv_tpu_torch.parallel.launch",
                "ellspmv_tpu_torch.parallel.spmv",
                "ellspmv_tpu_torch.parallel.stream",
                "ellspmv_tpu_torch.parallel.solver",
                "ellspmv_tpu_torch.parallel.dryrun",
                "ellspmv_tpu_torch.io.native",
                "ellspmv_tpu_torch.bench.calibrate",
                "ellspmv_tpu_torch.bench.reference_scale",
                "ellspmv_tpu_torch.utils.calibration"}
    assert expected <= set(child["modules"])


def test_spawned_rank_imports_no_jax():
    """A rank starts from a fresh interpreter (spawn) and loads the port
    and torch, never jax, ml_dtypes or the JAX package, though the process
    that spawned it may hold them."""
    from ellspmv_tpu_torch.parallel import launch
    with launch.RankPool(["cpu"] * 2, timeout=120) as pool:
        loaded = pool.run(launch.loaded_modules, [(), ()])
    for modules in loaded:
        assert "ellspmv_tpu_torch.parallel.launch" in modules
        assert [m for m in modules
                if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes",
                                       "ellspmv_tpu")] == []


def test_import_without_nvcc_builds_nothing(child):
    assert child["loaded"] == 0
    assert child["launches"] == 0
    assert child["chosen"] == "dia" and child["dia_launches"] == 0
    # a CG solve on the CPU takes the plain dot product
    assert child["cg_iterations"] > 0 and child["dot_launches"] == 0
    # the stream format on the CPU takes the plain gather and sums
    assert child["stream_launches"] == 0
    assert child["streamed"] == [2.0, 1.0, 1.0, 2.0, 1.0, 0.0, 0.0, 1.0,
                                 1.0, 0.0, 0.0, 1.0, 2.0, 1.0, 1.0, 2.0]
    # so do the SELL and CSR formats, through K1's plain version, and the
    # hybrid, its gather of x the plain one too
    assert child["sold"] == child["csred"] == child["streamed"]
    assert child["hub"] and child["hybrid"] == child["streamed"]
    # the fp64 path probes only a card; the CPU runs the plain versions
    assert child["probe_launches"] == 0 and child["probed"] == 0


def test_import_without_a_compiler_builds_no_host_library(child):
    """Importing runs no C++ compiler (a subprocess would have failed the
    child); without one the CPU paths above took their NumPy versions."""
    assert child["native_after_import"] == []
    assert child["native_state"] == {"lib": "None"}


def test_each_module_defines_a_name_once():
    """No module of the port, nor ``chip_smoke.py``, defines a function or
    class twice at its top level: the later one would silently replace the
    earlier for every caller, and most of ``chip_smoke.py`` runs only on
    the card."""
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        os.path.join(root, f)
        for root, _, files in os.walk(os.path.join(REPO, "ellspmv_tpu_torch"))
        for f in files if f.endswith(".py")]
    twice = {}
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        names = collections.Counter(
            node.name for node in tree.body
            if isinstance(node, (ast.FunctionDef, ast.ClassDef)))
        dup = sorted(n for n, k in names.items() if k > 1)
        if dup:
            twice[os.path.relpath(path, REPO)] = dup
    assert twice == {}


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "find_nvcc", lambda: None)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


# Stands in for nvcc: records its arguments, writes its -o file, and fails
# on a source named in $FAKE_NVCC_FAIL. Each compile marks its start in the
# directory $FAKE_NVCC_STARTED, then waits until $FAKE_NVCC_COMPILES
# compiles have started there, or 20 s have passed, and records whether it
# saw them all: a barrier, so that the test checks that the compiles ran
# together without racing a clock.
_FAKE_NVCC = r"""#!{python}
import json, os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
together = None
if "-c" in args:
    started = os.environ["FAKE_NVCC_STARTED"]
    open(os.path.join(started, str(os.getpid())), "w").close()
    want = int(os.environ["FAKE_NVCC_COMPILES"])
    deadline = time.monotonic() + 20
    while len(os.listdir(started)) < want and time.monotonic() < deadline:
        time.sleep(0.01)
    together = len(os.listdir(started)) >= want
    if os.environ.get("FAKE_NVCC_FAIL", "!") in args[-1]:
        sys.stderr.write("error: fake failure\n")
        sys.exit(2)
    sys.stderr.write("ptxas info    : Used 32 registers\n")
with open(out, "w") as f:
    f.write("built")
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(json.dumps({{"args": args, "together": together}}) + "\n")
"""


@pytest.mark.parametrize("fail", [False, True])
def test_build_compiles_each_source_in_parallel(fail, monkeypatch,
                                                tmp_path):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(_FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    log = tmp_path / "calls.jsonl"
    started = tmp_path / "started"
    started.mkdir()
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setenv("FAKE_NVCC_STARTED", str(started))
    monkeypatch.setenv("FAKE_NVCC_COMPILES", str(len(_build.sources())))
    if fail:
        monkeypatch.setenv("FAKE_NVCC_FAIL", "dia_spmv.cu")
    monkeypatch.setattr(_build, "find_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if fail:
        with pytest.raises(RuntimeError, match="fake failure"):
            _build.build()
        assert list((tmp_path / "build").iterdir()) == []
        return
    out = _build.build()
    calls = [json.loads(line) for line in log.read_text().splitlines()]
    # each compile logs as it ends, the link last
    compiles, link = calls[:-1], calls[-1]
    assert sorted(c["args"][-1] for c in compiles) == \
        [str(p) for p in _build.sources()]
    assert all("-c" in c["args"] and "sm_90a" in " ".join(c["args"])
               for c in compiles)
    # every compile saw all the others start before it ended
    assert all(c["together"] for c in compiles)
    assert "-shared" in link["args"] and link["together"] is None
    assert out == _build.library_path() and out.read_text() == "built"
    assert sorted(p.name for p in out.parent.iterdir()) == \
        sorted([out.name, out.with_suffix(".log").name])
    assert out.with_suffix(".log").read_text().count("registers") == \
        len(_build.sources())
    assert _build.build() == out
    assert len(log.read_text().splitlines()) == len(_build.sources()) + 1


def test_library_path_tracks_sources():
    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libellspmv_tpu_torch_")
    assert [p.name for p in _build.sources()] == ["dia_spmv.cu",
                                                  "dia_symgs.cu", "dot.cu",
                                                  "ell_spmv.cu",
                                                  "fma_probe.cu",
                                                  "permute.cu",
                                                  "stream_sum.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def _small(dtype=torch.float64):
    ell = ell_from_coo(banded_random(40, 5, 6, seed=2), value_dtype=dtype,
                       separate_diagonal=True)
    x = torch.from_numpy(np.random.RandomState(0).rand(40)).to(dtype)
    return ell, x


def test_cpu_tensors_take_the_plain_version():
    ell, x = _small()
    before = ell_cuda.launches
    got = ell_cuda.ell_spmv(ell, x)
    assert torch.equal(got, ell_cuda.ell_spmv_torch(ell, x))
    assert ell_cuda.launches == before


@pytest.mark.parametrize("case", ["x_dtype", "x_shape", "y_shape",
                                  "noncontiguous", "mixed_device",
                                  "meta_device", "index_dtype"])
def test_wrapper_refuses(case):
    ell, x = _small()
    y = None
    err = ValueError
    if case == "x_dtype":
        x, err = x.float(), TypeError
    elif case == "x_shape":
        x = torch.ones(41, dtype=torch.float64)
    elif case == "y_shape":
        y = torch.ones(39, dtype=torch.float64)
    elif case == "noncontiguous":
        x = torch.ones(80, dtype=torch.float64)[::2]
    elif case == "mixed_device":
        x = x.to("meta")
    elif case == "meta_device":
        ell, x = ell.to("meta"), x.to("meta")
    elif case == "index_dtype":
        ell.colidx, err = ell.colidx.to(torch.int16), TypeError
    with pytest.raises(err):
        ell_cuda.ell_spmv(ell, x, y)


def test_fma_probe_cpu_takes_the_plain_version():
    a, b = ell_cuda.probe_inputs("cpu")
    before = ell_cuda.probe_launches
    got = ell_cuda.fma_probe(a, b)
    assert torch.equal(got, ell_cuda.fma_probe_torch(a, b))
    assert got.shape == (8, 128) and bool((got != 0).any())
    assert ell_cuda.probe_launches == before


@pytest.mark.parametrize("case", ["dtype", "shape", "noncontiguous",
                                  "meta_device"])
def test_fma_probe_refuses(case):
    a, b = ell_cuda.probe_inputs("cpu")
    err = ValueError
    if case == "dtype":
        b, err = b.double(), TypeError
    elif case == "shape":
        b = b[:4].contiguous()
    elif case == "noncontiguous":
        a, b = a.t(), b.t()
    elif case == "meta_device":
        a, b = a.to("meta"), b.to("meta")
    with pytest.raises(err):
        ell_cuda.fma_probe(a, b)


@pytest.mark.cuda
def test_fma_probe_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    a, b = ell_cuda.probe_inputs("cuda")
    before = ell_cuda.probe_launches
    got = ell_cuda.fma_probe(a, b)
    assert ell_cuda.probe_launches == before + 1
    assert torch.equal(got.cpu(), ell_cuda.fma_probe_torch(a.cpu(), b.cpu()))
    ell_cuda.FMA_PROBE_RESULTS.clear()
    assert ell_cuda.fma_contraction_available(a.device)
    assert ell_cuda.probe_launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    ell = ell_from_coo(poisson2d(64), value_dtype=dtype,
                       separate_diagonal=True, device="cuda")
    x = torch.from_numpy(np.random.RandomState(0).rand(4096)).cuda().to(dtype)
    y = torch.from_numpy(np.random.RandomState(1).randn(4096)).cuda().to(dtype)
    before = ell_cuda.launches
    got = ell_cuda.ell_spmv(ell, x, y)
    torch.cuda.synchronize()
    assert ell_cuda.launches == before + 1
    want = ell_cuda.ell_spmv_torch(ell, x, y)
    tol = {torch.float64: 1e-13, torch.float32: 1e-5, torch.bfloat16: 1e-2}
    scale = float(want.double().abs().max())
    torch.testing.assert_close(got.double(), want.double(), rtol=tol[dtype],
                               atol=tol[dtype] * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_dia_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    coo = diagonal_coo(700, 700, [-300, -129, -7, 0, 5, 127, 128, 301], 4)
    dia = dia_from_coo(coo, value_dtype=dtype, device="cuda")
    x = torch.from_numpy(np.random.RandomState(0).rand(700)).cuda().to(dtype)
    y = torch.from_numpy(np.random.RandomState(1).randn(700)).cuda().to(dtype)
    before = dia_cuda.launches
    got = dia_cuda.dia_spmv(dia, x, y)
    torch.cuda.synchronize()
    assert dia_cuda.launches == before + 1
    want = dia_cuda.dia_spmv_torch(dia, x, y)
    tol = {torch.float64: 1e-13, torch.float32: 1e-5, torch.bfloat16: 1e-2}
    scale = float(want.double().abs().max())
    torch.testing.assert_close(got.double(), want.double(), rtol=tol[dtype],
                               atol=tol[dtype] * scale)
