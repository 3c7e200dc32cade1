"""The port's hub-column hybrid (``formats/hybrid.py``) against the JAX
package's on the same seeded inputs: `hybrid_from_coo` field for field on
every branch (a hub, none for uniform degrees, none where the hub would
hold every column, an empty matrix, the default width), `hybrid_spmv`
(K1's plain version and the plain gather on the CPU) against JAX's
``hybrid_spmv``, run as tests/test_hybrid.py runs it, and against the NumPy
oracle, the metrics and bytes, the dispatch's ``xla`` backend, and
``ellspmv --format=hybrid`` and ``--backend=xla`` against the JAX program.
Tolerances, per row relative to sum |a*x| + |y|: fp64 1e-13, f32 1e-5,
bf16 1e-2."""

import io

import numpy as np
import pytest
import torch

from ellspmv_tpu.bench.harness import SpmvMetrics as JaxSpmvMetrics
from ellspmv_tpu.cli import csrspmv as jax_csrspmv
from ellspmv_tpu.cli import ellspmv as jax_ellspmv
from ellspmv_tpu.formats.coo import CooMatrix as JaxCoo
from ellspmv_tpu.formats.hybrid import hybrid_from_coo as jax_hybrid_from_coo
from ellspmv_tpu.formats.hybrid import hybrid_spmv as jax_hybrid_spmv
from ellspmv_tpu.io.mtx import read_vector, write_matrix
from ellspmv_tpu.models import generators as jax_generators
from ellspmv_tpu.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.bench.harness import SpmvMetrics
from ellspmv_tpu_torch.bench.traffic import (estimate_actual_bytes,
                                             gather_bytes, hybrid_bytes,
                                             sell_bytes)
from ellspmv_tpu_torch.cli import csrspmv, ellspmv
from ellspmv_tpu_torch.formats.hybrid import (HybridMatrix, hybrid_from_coo,
                                              hybrid_spmv, kernel_launches)
from ellspmv_tpu_torch.ops import ell_cuda, permute
from ellspmv_tpu_torch.ops.dispatch import spmv
from tests.conftest import random_coo
from tests.test_torch_csr import port_coo
from tests.test_torch_sell import assert_sell_equal
from torch_cases import assert_rows_close


def _empty():
    return JaxCoo(300, 200, np.zeros(0, np.int32), np.zeros(0, np.int32),
                  np.zeros(0))


# name -> (COO factory, hybrid_from_coo keywords, the branch it takes)
CASES = {
    "hub": (lambda: jax_generators.power_law(4000, 8, seed=1),
            dict(hub_width=512, slice_rows=256, tail_cap=16), "hub"),
    "hub_default_width": (lambda: jax_generators.power_law(20_000, 8,
                                                           seed=2),
                          {}, "hub"),
    "hub_f32_int64": (lambda: jax_generators.power_law(3000, 6, seed=5),
                      dict(hub_width=256, value_dtype="float32",
                           index_dtype="int64"), "hub"),
    "hub_bf16_unsorted": (lambda: jax_generators.power_law(2000, 8, seed=3),
                          dict(hub_width=256, slice_rows=128,
                               length_sort=False, sort_rows=False,
                               value_dtype="bfloat16"), "hub"),
    "hub_symmetric": (lambda: random_coo(np.random.RandomState(44), 600, 600,
                                         3000, symmetric=True),
                      dict(hub_width=128, min_hub_fraction=0.1), "hub"),
    "uniform": (lambda: random_coo(np.random.RandomState(45), 2000, 2000,
                                   8000), dict(hub_width=128), "no hub"),
    "narrow": (lambda: random_coo(np.random.RandomState(46), 400, 100,
                                  2000), {}, "H >= m"),
    "empty": (_empty, {}, "empty"),
}


def _both(name):
    make, kw, _ = CASES[name]
    coo = make()
    return (coo, kw, jax_hybrid_from_coo(coo, **kw),
            hybrid_from_coo(port_coo(coo), **kw))


def _as_f32(sm, jax_side):
    """A bf16 SELL matrix with its values widened to float32 (exactly), so
    that numpy compares them; other types as they are."""
    import dataclasses
    if jax_side:
        if np.asarray(sm.buckets[0].values).dtype.name != "bfloat16":
            return sm
        return dataclasses.replace(sm, buckets=[dataclasses.replace(
            b, values=np.asarray(b.values).astype(np.float32))
            for b in sm.buckets])
    if sm.values.dtype != torch.bfloat16:
        return sm
    return dataclasses.replace(sm, buckets=[dataclasses.replace(
        b, values=b.values.float()) for b in sm.buckets],
        trivial_reassembly=sm.trivial_reassembly)


def assert_parts_equal(got, want):
    assert_sell_equal(_as_f32(got, False), _as_f32(want, True))


@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_from_coo_equals_jax(name):
    _, _, want, got = _both(name)
    assert (got.hub is None) == (want.hub is None)
    assert got.values.dtype == {"float32": torch.float32,
                                "bfloat16": torch.bfloat16}.get(
        CASES[name][1].get("value_dtype"), torch.float64)
    if want.hub is not None:
        assert_parts_equal(got.hub, want.hub)
        assert got.hub_cols.dtype == torch.int32
        np.testing.assert_array_equal(got.hub_cols.numpy(),
                                      np.asarray(want.hub_cols))
    else:
        assert got.hub_cols is None and want.hub_cols is None
    assert_parts_equal(got.rest, want.rest)
    for attr in ("num_rows", "num_columns", "num_nonzeros",
                 "hub_nnz_fraction"):
        assert getattr(got, attr) == getattr(want, attr), attr


def test_the_cases_cover_every_branch():
    branches = {}
    for name, (_, _, branch) in CASES.items():
        coo, _, _, got = _both(name)
        branches.setdefault(branch, []).append(got)
        m = coo.num_columns
        if branch == "H >= m":
            assert got.hub is None and coo.num_nonzeros > 0 and m <= 128
        elif branch == "empty":
            assert got.hub is None and coo.num_nonzeros == 0
        elif branch == "no hub":
            assert got.hub is None and m > 128
        else:
            assert got.hub is not None and 0 < got.hub_nnz_fraction < 1
    assert set(branches) == {"hub", "no hub", "H >= m", "empty"}
    hubs = branches["hub"]
    # the hub's parts take the SELL split's long-row split and its
    # reassembly, and at least one takes the default hub width
    assert any(h.hub.extra_rows is not None or h.rest.extra_rows is not None
               for h in hubs)
    assert any(h.hub.num_columns == 1280 for h in hubs)


def _inputs(coo, precision, with_y, seed):
    rng = np.random.RandomState(seed)
    x = rng.rand(coo.num_columns)
    y = rng.randn(coo.num_rows) if with_y else None
    return x, y


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_hybrid_spmv_against_jax_and_the_oracle(name, with_y):
    coo, kw, jhm, hm = _both(name)
    precision = kw.get("value_dtype", "float64")
    x, y = _inputs(coo, precision, with_y, 47)
    dt = hm.values.dtype
    before = (ell_cuda.launches, permute.launches)
    got = hybrid_spmv(hm, torch.from_numpy(x).to(dt),
                      None if y is None else torch.from_numpy(y).to(dt))
    # the CPU runs the plain versions: no kernel is launched
    assert (ell_cuda.launches, permute.launches) == before
    assert got.dtype == dt and got.shape == (coo.num_rows,)
    assert_rows_close(got.double().numpy(), coo, x, y, precision)
    want = np.asarray(jax_hybrid_spmv(jhm, x.astype(precision),
                                      None if y is None
                                      else y.astype(precision)), np.float64)
    assert_rows_close(got.double().numpy(), coo, x, y, precision, want)


@pytest.mark.parametrize("name", ["hub", "uniform", "hub_f32_int64"])
def test_xla_backend_runs_the_plain_buckets(name, monkeypatch):
    """``backend="xla"`` runs every bucket through K1's plain version (here
    on the CPU, as on a card): the same y as the kernel route's."""
    coo, kw, _, hm = _both(name)
    calls = []
    real = ell_cuda.ell_spmv_torch

    def plain(*args):
        calls.append(1)
        return real(*args)
    monkeypatch.setattr(ell_cuda, "ell_spmv_torch", plain)
    dt = hm.values.dtype
    x = torch.from_numpy(np.random.RandomState(48).rand(
        coo.num_columns)).to(dt)
    got = spmv(hm, x, backend="xla")
    assert len(calls) == kernel_launches(hm)["ell_spmv"]
    assert torch.equal(got, spmv(hm, x))


def test_launches_per_call():
    _, _, _, hm = _both("hub")
    want = kernel_launches(hm)
    assert want == {"ell_spmv": len(hm.hub.buckets) + len(hm.rest.buckets),
                    "permute": 1}
    _, _, _, flat = _both("uniform")
    assert kernel_launches(flat) == {"ell_spmv": len(flat.rest.buckets),
                                     "permute": 0}


@pytest.mark.parametrize("name", ["hub", "hub_f32_int64", "uniform"])
def test_metrics_equal_jax(name):
    _, _, jhm, hm = _both(name)
    want = JaxSpmvMetrics.for_matrix(jhm)
    got = SpmvMetrics.for_matrix(hm)
    assert (got.num_nonzeros, got.num_flops, got.min_bytes,
            got.max_bytes) == (want.num_nonzeros, want.num_flops,
                               want.min_bytes, want.max_bytes)


@pytest.mark.parametrize("name", ["hub", "hub_f32_int64", "uniform"])
def test_bytes_are_the_jax_sum_of_the_parts(name):
    """The JAX package's hybrid bytes: the two SELL parts and the hub's
    gather of x (its int32 map, an element read and written per hub
    column); the rest's SELL takes the hub's result as its y."""
    _, _, jhm, hm = _both(name)
    vb = hm.values.element_size()
    if hm.hub is None:
        assert hybrid_bytes(hm) == sell_bytes(hm.rest)
        return
    H = len(np.asarray(jhm.hub_cols))
    assert gather_bytes(hm.hub_cols, vb) == 4 * H + 2 * H * vb
    assert estimate_actual_bytes(hm) == hybrid_bytes(hm) == (
        4 * H + 2 * H * vb + sell_bytes(hm.hub, with_y=False)
        + sell_bytes(hm.rest) + 3 * hm.num_rows * vb)
    assert hybrid_bytes(hm, with_y=False) == \
        hybrid_bytes(hm) - 3 * hm.num_rows * vb


def test_to_moves_every_part():
    _, _, _, hm = _both("hub")
    moved = hm.to("meta")
    assert isinstance(moved, HybridMatrix) and moved.device.type == "meta"
    assert moved.hub_cols.device.type == "meta"
    assert moved.hub.device.type == "meta"
    assert hm.device.type == "cpu"


# -- the programs -------------------------------------------------------------

def run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.fixture
def hubby(tmp_path):
    """A power-law file with small-integer values, whose hub holds most of
    its entries: every sum is exact in either package's arithmetic."""
    rng = np.random.RandomState(49)
    coo = jax_generators.power_law(3000, 8, seed=6)
    coo.values = rng.randint(-5, 6, coo.num_nonzeros).astype(np.float64)
    path = str(tmp_path / "hubby.mtx")
    write_matrix(path, coo)
    return path, coo


def _lines(err, prefix):
    return [line for line in err.splitlines() if line.startswith(prefix)]


@pytest.mark.parametrize("flags", [
    ["--format=hybrid"], ["--format=hybrid", "--repeat=2"],
    ["--format=hybrid", "--precision=float32"],
    ["--format=hybrid", "--index-width=64", "--separate-diagonal"],
    ["--format=hybrid", "--protocol=chained", "-q"],
])
def test_hybrid_stdout_identical_to_jax(flags, hubby, capsys):
    path, coo = hubby
    rc_j, out_j, err_j = run(jax_ellspmv.main, ["-v"] + flags + [path],
                             capsys)
    rc_p, out_p, err_p = run(ellspmv.main, ["--device=cpu", "-v"] + flags
                             + [path], capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j
    if "-q" not in flags:
        calls = 2 if "--repeat=2" in flags else 1
        np.testing.assert_array_equal(
            read_vector(io.BytesIO(out_p.encode())),
            calls * coo_spmv_numpy(coo, np.ones(coo.num_columns)))
    # the same conversion line (its tail: the hub's share) and as many
    # gemv_hybrid lines as the JAX program prints
    tail = [line.rsplit(", ", 1)[-1] for line in _lines(err_j,
                                                        "hybrid_from_coo:")]
    assert tail and tail == [line.rsplit(", ", 1)[-1] for line in
                             _lines(err_p, "hybrid_from_coo:")]
    assert len(_lines(err_p, "gemv_hybrid:")) == \
        len(_lines(err_j, "gemv_hybrid:"))
    if "--separate-diagonal" in flags:
        assert "note: --format=hybrid stores the diagonal inline" in err_p


@pytest.mark.parametrize("program,flags", [
    ("ellspmv", []), ("ellspmv", ["--format=sell"]),
    ("ellspmv", ["--format=hybrid"]), ("ellspmv", ["--sort-rows",
                                                   "--precision=float32"]),
    ("csrspmv", []), ("csrspmv", ["--separate-diagonal"]),
])
def test_backend_xla_stdout_identical_to_jax(program, flags, hubby, capsys):
    path, coo = hubby
    jax_main, main = {"ellspmv": (jax_ellspmv.main, ellspmv.main),
                      "csrspmv": (jax_csrspmv.main, csrspmv.main)}[program]
    argv = ["--backend=xla"] + flags + [path]
    rc_j, out_j, err_j = run(jax_main, argv, capsys)
    before = ell_cuda.launches
    rc_p, out_p, err_p = run(main, ["--device=cpu", "-v"] + argv, capsys)
    assert rc_j == rc_p == 0, (err_j, err_p)
    assert out_p == out_j
    assert ell_cuda.launches == before
    assert "backend: xla (the plain PyTorch versions" in err_p
