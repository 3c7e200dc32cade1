"""`ell_spmv` (the plain PyTorch version, which the wrapper runs for CPU
tensors) against the NumPy oracle and against the JAX package's Pallas
kernel K1 (`ell_spmv_pallas`, in interpret mode on the CPU), on identical
ELLPACK data carried across with `ell_from_jax_arrays`; and the FMA probe's
plain version against the JAX probe's inputs and exact residual. The CUDA
kernels are held against the same plain versions on the card
(``chip_smoke.py``)."""

import functools

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.models.generators import banded_random, poisson2d
from ellspmv_tpu.ops.ell_pallas import _two_prod, ell_spmv_pallas, get_plan
from ellspmv_tpu_torch.formats.ell import ell_from_jax_arrays
from ellspmv_tpu_torch.ops.dispatch import spmv
from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv, fma_probe
from ellspmv_tpu_torch.ops.ell_cuda import probe_inputs as fma_probe_inputs
from ellspmv_tpu_torch.ops.reference import ell_spmv_numpy
from tests.conftest import assert_fp64_close, random_coo

TORCH_DTYPE = {"float64": torch.float64, "float32": torch.float32,
               "bfloat16": torch.bfloat16}
JAX_DTYPE = {"float64": np.float64, "float32": np.float32,
             "bfloat16": ml_dtypes.bfloat16}

# name -> (matrix, separate_diagonal, accumulate into y)
CASES = {
    "poisson2d": (lambda: poisson2d(24), False, False),
    "banded": (lambda: banded_random(400, 5, 32), False, False),
    "rectangular": (lambda: random_coo(np.random.RandomState(0), 150, 100,
                                       400), False, False),
    "separate_diagonal": (lambda: banded_random(300, 5, 40, seed=5), True,
                          False),
    "y_accumulate": (lambda: banded_random(300, 5, 40, seed=5), True, True),
}


@functools.cache
def _case(name: str, precision: str):
    """The JAX matrix, the port's copy of it, x and y (numpy, fp64)."""
    make, sep_diag, with_y = CASES[name]
    jell = jax_ell_from_coo(make(), sort_rows=True,
                            separate_diagonal=sep_diag,
                            value_dtype=JAX_DTYPE[precision])
    pell = ell_from_jax_arrays(np.asarray(jell.colidx),
                               np.asarray(jell.values),
                               None if jell.diag is None
                               else np.asarray(jell.diag),
                               jell.num_rows, jell.num_columns,
                               jell.num_nonzeros)
    x = np.random.RandomState(7).rand(jell.num_columns)
    y = np.random.RandomState(11).randn(jell.num_rows) if with_y else None
    return jell, pell, x, y


def _port(pell, x, y, precision):
    dt = TORCH_DTYPE[precision]
    out = ell_spmv(pell, torch.from_numpy(x).to(dt),
                   None if y is None else torch.from_numpy(y).to(dt))
    assert out.dtype == dt and out.shape == (pell.num_rows,)
    return out.double().numpy()


def _jax(jell, x, y, precision):
    assert get_plan(jell) is not None
    xj = x.astype(JAX_DTYPE[precision])
    yj = None if y is None else y.astype(JAX_DTYPE[precision])
    return np.asarray(ell_spmv_pallas(jell, xj, yj)).astype(np.float64)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp64_against_oracle(name):
    _, pell, x, y = _case(name, "float64")
    got = _port(pell, x, y, "float64")
    assert_fp64_close(got, ell_spmv_numpy(pell, x, y))
    # the dispatch takes the same path
    assert_fp64_close(spmv(pell, torch.from_numpy(x),
                           None if y is None else torch.from_numpy(y)).numpy(),
                      got)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fp64_against_jax_kernel(name):
    # JAX fp64 is double-double on the TPU path, even in interpret mode
    jell, pell, x, y = _case(name, "float64")
    got, want = _port(pell, x, y, "float64"), _jax(jell, x, y, "float64")
    scale = max(np.max(np.abs(want)), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * scale)


@pytest.mark.parametrize("name", sorted(CASES))
def test_f32_against_jax_kernel(name):
    jell, pell, x, y = _case(name, "float32")
    got, want = _port(pell, x, y, "float32"), _jax(jell, x, y, "float32")
    scale = max(np.max(np.abs(want)), 1.0)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5 * scale)


def test_fma_probe_against_jax():
    # The port's probe inputs are the JAX probe's, and the plain version of
    # the probe kernel gives the exact residual that the JAX probe demands
    # (ell_pallas.py:169-170) and that JAX's Dekker two_prod computes.
    a, b = fma_probe_inputs("cpu")
    rng = np.random.RandomState(0)
    a_np = rng.uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    b_np = rng.uniform(0.5, 2.0, (8, 128)).astype(np.float32)
    np.testing.assert_array_equal(a.numpy(), a_np)
    np.testing.assert_array_equal(b.numpy(), b_np)
    got = fma_probe(a, b).numpy()
    exact = (a_np.astype(np.float64) * b_np.astype(np.float64)
             - (a_np * b_np).astype(np.float64)).astype(np.float32)
    np.testing.assert_array_equal(got, exact)
    assert np.any(exact != 0)
    _, err = _two_prod(jnp.asarray(a_np), jnp.asarray(b_np))
    np.testing.assert_array_equal(got, np.asarray(err))


@pytest.mark.parametrize("name", sorted(CASES))
def test_bf16_against_jax_kernel(name):
    # Both round values and the result to bf16; the JAX epilogue adds the
    # diagonal and y in bf16, the port in f32. Compared in f32.
    jell, pell, x, y = _case(name, "bfloat16")
    got = _port(pell, x, y, "bfloat16").astype(np.float32)
    want = _jax(jell, x, y, "bfloat16").astype(np.float32)
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2 * scale)


# --------------------------------------------------------------------------
# The narrow column layout (lbase + 16-bit lcol)
# --------------------------------------------------------------------------

def _block_coo(first_col: int, short_row: int | None):
    """256 rows, row i with columns first_col + i and first_col + i + 1;
    `short_row` (if any) keeps one entry, so that it gets a padding slot
    of column min(i, m - 1)."""
    rows = np.repeat(np.arange(256), 2)
    cols = first_col + rows + np.tile([0, 1], 256)
    keep = np.ones(len(rows), bool)
    if short_row is not None:
        keep[2 * short_row + 1] = False
    return port_coo_of(256, first_col + 300, rows[keep], cols[keep])


def port_coo_of(n, m, rows, cols):
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    return CooMatrix(n, m, rows.astype(np.int32), cols.astype(np.int32),
                     np.random.RandomState(0).randn(len(rows)))


# name -> (COO factory, narrow)
NARROW_RULE_CASES = {
    # a band: each block of 256 rows spans a few hundred columns
    "banded": (lambda: port_coo_of(
        1000, 1000, *np.nonzero(np.abs(np.subtract.outer(
            np.arange(1000), np.arange(1000))) <= 3)), True),
    # one block whose entries span 65,535 columns, then 65,536
    "span_65535": (lambda: port_coo_of(
        256, 70_000, np.array([0, 1]), np.array([0, 65_535])), True),
    "span_65536": (lambda: port_coo_of(
        256, 70_000, np.array([0, 1]), np.array([0, 65_536])), False),
    # entries far right of the diagonal: narrow while every row is full,
    # wide once a short row's padding slot (column 5) widens the block
    "full_rows_far_right": (lambda: _block_coo(66_000, None), True),
    "padding_widens": (lambda: _block_coo(66_000, 5), False),
}


@pytest.mark.parametrize("name", sorted(NARROW_RULE_CASES))
def test_narrow_rule_from_coo_matches_the_built_layout(name):
    from ellspmv_tpu_torch.formats.ell import ell_from_coo, narrow_columns_fit
    make, narrow = NARROW_RULE_CASES[name]
    coo = make()
    ell = ell_from_coo(coo)
    assert (ell.lcol is not None) == narrow
    assert narrow_columns_fit(coo.rowidx, coo.colidx, coo.num_rows,
                              coo.num_columns, ell.rowsize) == narrow
    if narrow:
        assert torch.equal(ell.columns(), ell.colidx)
        assert ell.index_bytes == 2 * ell.lcol.numel() + 4 * len(ell.lbase)
    else:
        assert ell.lbase is None and ell.lcol is None
        assert ell.index_bytes == 4 * ell.colidx.numel()


@pytest.mark.parametrize("index_dtype", ["int32", "int64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_narrow_encoding_round_trips_to_colidx(name, index_dtype):
    from ellspmv_tpu_torch.formats.ell import LBLOCK, ell_from_coo
    make, sep_diag, _ = CASES[name]
    ell = ell_from_coo(port_coo_of_jax(make()), sort_rows=True,
                       separate_diagonal=sep_diag, index_dtype=index_dtype)
    assert ell.lcol is not None and ell.lcol.dtype == torch.int16
    assert ell.lcol.shape == ell.colidx.shape and ell.lcol.is_contiguous()
    assert ell.lbase.dtype == ell.colidx.dtype
    assert ell.lbase.shape == (-(-ell.padded_rows // LBLOCK),)
    assert torch.equal(ell.columns(), ell.colidx)
    # each base is its block's least column
    blocks = torch.nn.functional.pad(
        ell.colidx, (0, len(ell.lbase) * LBLOCK - ell.padded_rows),
        value=2**31 - 1).view(ell.rowsize, -1, LBLOCK)
    assert torch.equal(blocks.amin(dim=(0, 2)), ell.lbase)
    moved = ell.to("cpu")
    assert torch.equal(moved.lcol, ell.lcol)
    assert torch.equal(moved.lbase, ell.lbase)


def port_coo_of_jax(coo):
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     coo.values, coo.symmetry, coo.field)


@pytest.mark.parametrize("index_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("precision", ["float64", "float32", "bfloat16"])
def test_plain_on_narrow_layout_against_jax_kernel(precision, index_dtype):
    """The plain version decodes lbase + lcol; against the JAX kernel on the
    same arrays, at the tolerances of the tests above."""
    jell = jax_ell_from_coo(banded_random(600, 7, 40, seed=3),
                            sort_rows=True, separate_diagonal=True,
                            index_dtype=index_dtype,
                            value_dtype=JAX_DTYPE[precision])
    pell = ell_from_jax_arrays(np.asarray(jell.colidx),
                               np.asarray(jell.values), np.asarray(jell.diag),
                               jell.num_rows, jell.num_columns,
                               jell.num_nonzeros)
    assert pell.lcol is not None
    assert pell.lbase.dtype == torch.from_numpy(
        np.zeros(0, index_dtype)).dtype
    x = np.random.RandomState(7).rand(jell.num_columns)
    y = np.random.RandomState(11).randn(jell.num_rows)
    got = _port(pell, x, y, precision).astype(np.float32 if precision ==
                                              "bfloat16" else np.float64)
    want = _jax(jell, x, y, precision)
    tol = {"float64": 1e-12, "float32": 2e-5, "bfloat16": 1e-2}[precision]
    scale = max(float(np.max(np.abs(want))), 1.0)
    np.testing.assert_allclose(got, want.astype(got.dtype), rtol=tol,
                               atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_narrow_kernel_matches_plain_on_card(layout):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    import dataclasses

    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.ops import ell_cuda
    ell = ell_from_coo(port_coo_of_jax(banded_random(5000, 9, 64)),
                       device="cuda")
    assert ell.lcol is not None
    if layout == "wide":
        ell = dataclasses.replace(ell, lbase=None, lcol=None)
    x = torch.from_numpy(np.random.RandomState(0).rand(5000)).cuda()
    got = ell_cuda.ell_spmv(ell, x)
    torch.cuda.synchronize()
    want = ell_cuda.ell_spmv_torch(ell, x)
    torch.testing.assert_close(got, want, rtol=1e-13,
                               atol=1e-13 * float(want.abs().max()))
