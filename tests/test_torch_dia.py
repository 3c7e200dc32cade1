"""The port's DIA format and its kernel's plain version on the CPU.

`dia_from_coo` against the JAX package's (bit for bit); `dia_spmv` (the
plain PyTorch version, which the wrapper runs for CPU tensors) against the
NumPy oracle, against the JAX package's Pallas kernel K2
(`dia_spmv_pallas`, in interpret mode on the CPU) on identical data carried
across with `dia_from_jax_arrays`, and in bf16 against the JAX package's XLA
DIA product (its Pallas kernel takes no bf16). The CUDA kernel is held
against the same plain version on the card (the ``cuda`` tests of
``tests/test_torch_imports.py``, and ``chip_smoke.py``). Also: the
wrapper's refusals, the DIA metrics, the byte counts of
``bench/traffic.py``, and the cards' memory peaks.
"""

import functools

import ml_dtypes
import numpy as np
import pytest
import torch

from ellspmv_tpu.bench.harness import SpmvMetrics as JaxSpmvMetrics
from ellspmv_tpu.formats.coo import CooMatrix as JaxCooMatrix
from ellspmv_tpu.formats.dia import dia_from_coo as jax_dia_from_coo
from ellspmv_tpu.formats.dia import dia_spmv as jax_dia_spmv
from ellspmv_tpu.models.generators import poisson2d
from ellspmv_tpu.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.bench.harness import SpmvMetrics
from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.dia import (DiaMatrix, dia_from_coo,
                                           dia_from_jax_arrays)
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.ops import dia_cuda
from ellspmv_tpu_torch.ops.dispatch import spmv
from tests.conftest import assert_fp64_close, random_coo

TORCH_DTYPE = {"float64": torch.float64, "float32": torch.float32,
               "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float64": np.float64, "float32": np.float32,
             "bfloat16": ml_dtypes.bfloat16}


def _diagonals(n, m, offs, seed):
    """An n x m matrix with the given diagonals, random values."""
    rows_l, cols_l = [], []
    for o in offs:
        r = np.arange(max(0, -o), min(n, m - o), dtype=np.int64)
        rows_l.append(r)
        cols_l.append(r + o)
    rows, cols = np.concatenate(rows_l), np.concatenate(cols_l)
    vals = np.random.RandomState(seed).randn(len(rows))
    return JaxCooMatrix(n, m, rows.astype(np.int32), cols.astype(np.int32),
                        vals)


# name -> (matrix, max_diags)
MATRICES = {
    "poisson2d": (lambda: poisson2d(20), 32),
    # the offsets of tests/test_pallas.py::test_dia_pallas_offsets_beyond_128
    "offsets_beyond_128": (lambda: _diagonals(
        700, 700, [-300, -129, -7, 0, 5, 127, 128, 301], 4), 32),
    "rectangular": (lambda: _diagonals(300, 260, [-40, -3, 0, 2, 17, 90],
                                       5), 32),
    "rectangular_wide": (lambda: _diagonals(200, 330, [-9, 0, 1, 150, 250],
                                            6), 32),
    "symmetric_dups": (lambda: random_coo(np.random.RandomState(1), 30, 30,
                                          80, symmetric=True,
                                          with_dups=True), 100),
}
# the JAX kernel runs in interpret mode (0.7-2.3 s a case): three matrices
KERNEL_MATRICES = ["poisson2d", "offsets_beyond_128", "rectangular"]


def port_coo(coo) -> CooMatrix:
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     coo.values, coo.symmetry, coo.field)


@functools.cache
def _case(name: str, precision: str):
    """The COO, the JAX DiaMatrix, the port's copy of it, x and y."""
    make, max_diags = MATRICES[name]
    coo = make()
    jdia = jax_dia_from_coo(coo, max_diags=max_diags,
                            value_dtype=JAX_DTYPE[precision])
    pdia = dia_from_jax_arrays(np.asarray(jdia.data), jdia.offsets,
                               jdia.num_rows, jdia.num_columns,
                               jdia.num_nonzeros)
    x = np.random.RandomState(7).rand(coo.num_columns)
    y = np.random.RandomState(11).randn(coo.num_rows)
    return coo, jdia, pdia, x, y


def _port(pdia, x, y, precision):
    dt = TORCH_DTYPE[precision]
    out = dia_cuda.dia_spmv(pdia, torch.from_numpy(x).to(dt),
                            None if y is None else torch.from_numpy(y).to(dt))
    assert out.dtype == dt and out.shape == (pdia.num_rows,)
    return out.double().numpy()


@pytest.mark.parametrize("precision", ["float64", "float32"])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_dia_from_coo_matches_jax(name, precision):
    make, max_diags = MATRICES[name]
    coo = make()
    want = jax_dia_from_coo(coo, max_diags=max_diags,
                            value_dtype=JAX_DTYPE[precision])
    got = dia_from_coo(port_coo(coo), max_diags=max_diags,
                       value_dtype=precision)
    assert got.offsets == want.offsets
    assert (got.num_rows, got.num_columns, got.num_nonzeros) == \
        (want.num_rows, want.num_columns, want.num_nonzeros)
    assert got.num_diags == want.num_diags and got.diasize == want.diasize
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert got.data.dtype == TORCH_DTYPE[precision]


def test_dia_from_coo_refuses_wide_and_rounds_bf16():
    coo = random_coo(np.random.RandomState(0), 200, 200, 2000)
    assert dia_from_coo(port_coo(coo), max_diags=16) is None
    _, jdia, _, _, _ = _case("poisson2d", "float64")
    got = dia_from_coo(port_coo(poisson2d(20)), value_dtype="bfloat16")
    want = np.asarray(jdia.data).astype(ml_dtypes.bfloat16)
    np.testing.assert_array_equal(got.data.float().numpy(),
                                  want.astype(np.float32))


@pytest.mark.parametrize("value_dtype", ["float64", "float32", "bfloat16"])
def test_dia_from_jax_arrays_equals_port_conversion(value_dtype):
    coo = MATRICES["offsets_beyond_128"][0]()
    jdia = jax_dia_from_coo(coo, value_dtype=JAX_DTYPE[value_dtype])
    carried = dia_from_jax_arrays(np.asarray(jdia.data), jdia.offsets,
                                  jdia.num_rows, jdia.num_columns,
                                  jdia.num_nonzeros)
    own = dia_from_coo(port_coo(coo), value_dtype=value_dtype)
    assert carried.offsets == own.offsets
    assert torch.equal(carried.data, own.data)
    moved = own.to("meta")
    assert isinstance(moved, DiaMatrix) and moved.device.type == "meta"


@pytest.mark.parametrize("with_y", [False, True])
@pytest.mark.parametrize("name", sorted(MATRICES))
def test_fp64_against_oracle(name, with_y):
    coo, _, pdia, x, y = _case(name, "float64")
    y = y if with_y else None
    got = _port(pdia, x, y, "float64")
    assert_fp64_close(got, coo_spmv_numpy(coo, x, y))
    # the dispatch takes the same path
    assert_fp64_close(spmv(pdia, torch.from_numpy(x),
                           None if y is None else torch.from_numpy(y))
                      .numpy(), got)


@pytest.mark.parametrize("precision,tol", [("float64", 5e-6),
                                           ("float32", 2e-5)])
@pytest.mark.parametrize("name", KERNEL_MATRICES)
def test_against_jax_kernel(name, precision, tol, monkeypatch):
    # the JAX package's own DIA kernel tests hold it to 5e-6 in interpret
    # mode, even in fp64 (double-double; tests/test_pallas.py:266)
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    from ellspmv_tpu.ops import dia_pallas
    _, jdia, pdia, x, y = _case(name, precision)
    y = y if name == "poisson2d" else None
    jdev = jdia.device_put()
    assert dia_pallas.supported(jdev)
    dt = JAX_DTYPE[precision]
    want = np.asarray(dia_pallas.dia_spmv_pallas(
        jdev, x.astype(dt), None if y is None else y.astype(dt)),
        np.float64)
    got = _port(pdia, x, y, precision)
    scale = max(np.max(np.abs(want)), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.parametrize("name", KERNEL_MATRICES)
def test_bf16_against_jax_and_oracle(name):
    # JAX has no bf16 DIA kernel (dia_pallas.get_plan refuses it) and runs
    # the XLA product in bf16 arithmetic; the port accumulates in f32.
    coo, jdia, pdia, x, y = _case(name, "bfloat16")
    xb = x.astype(ml_dtypes.bfloat16)
    yb = y.astype(ml_dtypes.bfloat16)
    got = _port(pdia, x, y, "bfloat16")
    want = np.asarray(jax_dia_spmv(jdia, xb, yb)).astype(np.float64)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * scale)
    # against the oracle on the bf16-rounded inputs, per row relative to
    # sum |a*x| + |y|
    a = np.asarray(jdia.data).astype(np.float64)
    xr, yr = xb.astype(np.float64), yb.astype(np.float64)
    exact = coo_spmv_numpy(coo, xr, yr)
    bound = np.zeros(coo.num_rows)
    for k, off in enumerate(jdia.offsets):
        lo, hi = max(0, -off), min(coo.num_rows, coo.num_columns - off)
        bound[lo:hi] += np.abs(a[k, lo:hi] * xr[lo + off:hi + off])
    bound += np.abs(yr)
    assert np.all(np.abs(got - exact) <= 1e-2 * np.maximum(bound, 1e-300))


def test_cpu_tensors_take_the_plain_version():
    _, _, pdia, x, y = _case("poisson2d", "float64")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    before = dia_cuda.launches
    got = dia_cuda.dia_spmv(pdia, xt, yt)
    assert torch.equal(got, dia_cuda.dia_spmv_torch(pdia, xt, yt))
    assert dia_cuda.launches == before
    # y is read, never written
    assert torch.equal(yt, torch.from_numpy(y))


@pytest.mark.parametrize("case", ["x_dtype", "x_shape", "y_shape",
                                  "noncontiguous", "mixed_device",
                                  "meta_device", "value_dtype",
                                  "too_many_diagonals"])
def test_wrapper_refuses(case):
    _, _, pdia, x, _ = _case("rectangular", "float64")
    x, y, err = torch.from_numpy(x), None, ValueError
    if case == "x_dtype":
        x, err = x.float(), TypeError
    elif case == "x_shape":
        x = torch.ones(pdia.num_rows, dtype=torch.float64)
    elif case == "y_shape":
        y = torch.ones(pdia.num_columns, dtype=torch.float64)
    elif case == "noncontiguous":
        x = torch.ones(2 * pdia.num_columns, dtype=torch.float64)[::2]
    elif case == "mixed_device":
        x = x.to("meta")
    elif case == "meta_device":
        pdia, x = pdia.to("meta"), x.to("meta")
    elif case == "value_dtype":
        pdia = DiaMatrix(pdia.data.half(), pdia.offsets, pdia.num_rows,
                         pdia.num_columns, pdia.num_nonzeros)
        err = TypeError
    elif case == "too_many_diagonals":
        n = 100
        pdia = DiaMatrix(torch.zeros(65, n, dtype=torch.float64),
                         tuple(range(-32, 33)), n, n, 0)
        x = torch.ones(n, dtype=torch.float64)
    with pytest.raises(err):
        dia_cuda.dia_spmv(pdia, x, y)


@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_dia_metrics_equal_jax(precision):
    coo = MATRICES["rectangular"][0]()
    want = JaxSpmvMetrics.for_matrix(
        jax_dia_from_coo(coo, value_dtype=JAX_DTYPE[precision]))
    got = SpmvMetrics.for_matrix(dia_from_coo(port_coo(coo),
                                              value_dtype=precision))
    assert vars(got) == vars(want)


def test_actual_bytes_count_what_the_kernels_move():
    coo = port_coo(MATRICES["rectangular"][0]())
    n, m = coo.num_rows, coo.num_columns
    dia = dia_from_coo(coo)
    assert estimate_actual_bytes(dia, with_y=False) == (6 * n + m + n) * 8
    assert estimate_actual_bytes(dia) == (6 * n + m + 2 * n) * 8
    ell = ell_from_coo(coo, separate_diagonal=True, value_dtype="float32")
    slots = ell.rowsize * ell.padded_rows
    assert estimate_actual_bytes(ell) == slots * 8 + (n + m + 2 * n) * 4


def test_hbm_peaks(monkeypatch):
    monkeypatch.delenv("HBM_PEAK_GBPS", raising=False)
    assert config.hbm_peak_bytes_per_s("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert config.hbm_peak_bytes_per_s("cuda") == 3.35e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 PCIe")
    assert config.hbm_peak_bytes_per_s("cuda") == 2.0e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    assert config.hbm_peak_bytes_per_s("cuda") is None
    monkeypatch.setenv("HBM_PEAK_GBPS", "1000")
    assert config.hbm_peak_bytes_per_s("cpu") == 1e12

