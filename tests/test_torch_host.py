"""The port's host modules against their JAX-package originals on the same
inputs: generators, Matrix Market I/O, and COO -> ELLPACK conversion."""

import dataclasses
import gzip
import io

import ml_dtypes
import numpy as np
import pytest
import torch

from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.io import mtx as jax_mtx
from ellspmv_tpu.models import generators as jax_gen
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.ell import ell_from_coo, ell_from_jax_arrays
from ellspmv_tpu_torch.io import mtx
from ellspmv_tpu_torch.models import generators as gen
from tests.conftest import random_coo


def port_coo(coo) -> CooMatrix:
    return CooMatrix(**dataclasses.asdict(coo))


def assert_same_coo(a, b):
    assert (a.num_rows, a.num_columns, a.symmetry, a.field) == \
        (b.num_rows, b.num_columns, b.symmetry, b.field)
    for name in ("rowidx", "colidx", "values"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# -- generators ---------------------------------------------------------

@pytest.mark.parametrize("name,args,kw", [
    ("poisson2d", (12,), {}),
    ("poisson2d", (7, 5), {}),
    ("banded_random", (1500, 9, 64), {}),
    ("banded_random", (300, 7, 20), {"seed": 3}),
    ("fem_mesh_2d", (24,), {}),
    ("fem_mesh_2d", (9, 13), {"extras": 2, "seed": 5}),
])
def test_generators_identical(name, args, kw):
    assert_same_coo(getattr(gen, name)(*args, **kw),
                    getattr(jax_gen, name)(*args, **kw))


# -- Matrix Market input and output -------------------------------------

PATTERN = """%%MatrixMarket matrix coordinate pattern general
3 3 4
1 1
2 3
3 1
3 3
"""

SYMMETRIC = """%%MatrixMarket matrix coordinate real symmetric
% lower triangle only
4 4 6
1 1 2.5
2 1 -1
3 2 -1e-3
4 4 7
4 1 0.25
3 3 1
"""

INTEGER = """%%MatrixMarket matrix coordinate integer general
2 3 3
1 1 4
2 3 -2
1 2 7
"""

VECTOR = """%%MatrixMarket vector array real general
% x
3
1.5
-2
3e-3
"""

COLUMN = """%%MatrixMarket matrix array real general
3 1
1
2
3
"""


def _files(tmp_path):
    paths = {"test.mtx": "examples/test.mtx",
             "test_spd.mtx": "examples/test_spd.mtx"}
    for name, text in (("pattern.mtx", PATTERN), ("symmetric.mtx", SYMMETRIC),
                       ("integer.mtx", INTEGER)):
        p = tmp_path / name
        p.write_text(text)
        paths[name] = str(p)
    gz = tmp_path / "test.mtx.gz"
    with open("examples/test.mtx", "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    paths["test.mtx.gz"] = str(gz)
    return paths


@pytest.mark.parametrize("name,gzipped,index_dtype", [
    ("test.mtx", None, None), ("test_spd.mtx", None, None),
    ("pattern.mtx", None, None), ("symmetric.mtx", None, None),
    ("integer.mtx", None, "int64"), ("test.mtx.gz", None, None),
    ("test.mtx.gz", True, None),
    ("test.mtx", True, None),   # -z on a plain file reads it unchanged
])
def test_read_matrix_matches_jax(tmp_path, name, gzipped, index_dtype):
    path = _files(tmp_path)[name]
    got = mtx.read_matrix(path, gzipped=gzipped, index_dtype=index_dtype)
    want = jax_mtx.read_matrix(path, gzipped=gzipped,
                               index_dtype=index_dtype, use_native=False)
    assert_same_coo(got, want)


@pytest.mark.parametrize("text", [VECTOR, COLUMN])
def test_read_vector_matches_jax(text):
    got = mtx.read_vector(io.BytesIO(text.encode()))
    want = jax_mtx.read_vector(io.BytesIO(text.encode()))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


MALFORMED = {
    "banner": "%%MatrixMarkt matrix coordinate real general\n1 1 1\n1 1 1\n",
    "object": "%%MatrixMarket tensor coordinate real general\n1 1 1\n",
    "format": "%%MatrixMarket matrix sparse real general\n1 1 1\n",
    "field": "%%MatrixMarket matrix coordinate complex general\n1 1 1\n",
    "symmetry": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
                "1 1 1\n",
    "eof": "%%MatrixMarket matrix coordinate real general\n% only\n",
    "size_token": "%%MatrixMarket matrix coordinate real general\n2 x 1\n",
    "size_count": "%%MatrixMarket matrix coordinate real general\n2 2\n",
    "negative": "%%MatrixMarket matrix coordinate real general\n2 -2 1\n",
    "garbage": "%%MatrixMarket matrix coordinate real general\n2 2 1\n"
               "1 1 abc\n",
    "short": "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1\n",
    "fields": "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1\n",
    "comment": "%%MatrixMarket matrix coordinate real general\n2 2 2\n"
               "1 1 1\n% late\n2 2 1\n",
    "range": "%%MatrixMarket matrix coordinate real general\n2 2 1\n"
             "1 1 1e999\n",
    "fraction": "%%MatrixMarket matrix coordinate real general\n2 2 1\n"
                "1.5 1 1\n",
    "index": "%%MatrixMarket matrix coordinate real general\n2 2 1\n3 1 1\n",
    "array": "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
}


def _error(fn, text, **kw):
    with pytest.raises(Exception) as e:
        fn(io.BytesIO(text.encode()), **kw)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_matrix_errors_match_jax(case):
    text = MALFORMED[case]
    assert _error(mtx.read_matrix, text) == \
        _error(jax_mtx.read_matrix, text, use_native=False)


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix coordinate real general\n3 1 3\n",
    "%%MatrixMarket vector array pattern general\n3\n",
    "%%MatrixMarket matrix array real general\n3 2\n",
])
def test_malformed_vector_errors_match_jax(text):
    assert _error(mtx.read_vector, text) == _error(jax_mtx.read_vector, text)


@pytest.mark.parametrize("pattern", [False, True])
def test_writers_match_jax(pattern):
    coo = random_coo(np.random.RandomState(4), 30, 20, 90, pattern=pattern)
    got, want = io.StringIO(), io.StringIO()
    mtx.write_matrix(got, port_coo(coo))
    jax_mtx.write_matrix(want, coo)
    assert got.getvalue() == want.getvalue()
    y = np.random.RandomState(5).randn(17) * 1e3
    got, want = io.StringIO(), io.StringIO()
    mtx.write_vector(got, y)
    jax_mtx.write_vector(want, y)
    assert got.getvalue() == want.getvalue()


# -- COO -> ELLPACK -----------------------------------------------------

def _ell_inputs():
    rng = np.random.RandomState(9)
    general = random_coo(rng, 70, 50, 400, with_dups=True)
    symmetric = random_coo(rng, 60, 60, 300, symmetric=True)
    return {"general_dups": general, "symmetric": symmetric,
            "banded": jax_gen.banded_random(300, 7, 20, seed=1)}


@pytest.mark.parametrize("matrix", ["general_dups", "symmetric", "banded"])
@pytest.mark.parametrize("sort_rows", [False, True])
@pytest.mark.parametrize("separate_diagonal", [False, True])
@pytest.mark.parametrize("index_dtype", ["int32", "int64"])
def test_ell_from_coo_matches_jax(matrix, sort_rows, separate_diagonal,
                                  index_dtype):
    coo = _ell_inputs()[matrix]
    kw = dict(sort_rows=sort_rows, separate_diagonal=separate_diagonal,
              index_dtype=index_dtype, value_dtype=np.float64)
    want = jax_ell_from_coo(coo, **kw)
    got = ell_from_coo(port_coo(coo), **kw)
    assert (got.num_rows, got.num_columns, got.num_nonzeros) == \
        (want.num_rows, want.num_columns, want.num_nonzeros)
    assert got.colidx.dtype == getattr(torch, index_dtype)
    assert got.colidx.is_contiguous() and got.values.is_contiguous()
    np.testing.assert_array_equal(got.colidx.numpy(),
                                  np.asarray(want.colidx).T)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values).T)
    if separate_diagonal:
        np.testing.assert_array_equal(got.diag.numpy(),
                                      np.asarray(want.diag))
    else:
        assert got.diag is None and want.diag is None


@pytest.mark.parametrize("value_dtype", ["float64", "float32", "bfloat16"])
def test_ell_from_jax_arrays_equals_port_conversion(value_dtype):
    coo = _ell_inputs()["general_dups"]
    jdt = ml_dtypes.bfloat16 if value_dtype == "bfloat16" else value_dtype
    j = jax_ell_from_coo(coo, separate_diagonal=True, value_dtype=jdt)
    got = ell_from_jax_arrays(np.asarray(j.colidx), np.asarray(j.values),
                              np.asarray(j.diag), j.num_rows, j.num_columns,
                              j.num_nonzeros)
    want = ell_from_coo(port_coo(coo), separate_diagonal=True,
                        value_dtype=value_dtype)
    assert got.values.dtype == want.values.dtype == \
        getattr(torch, value_dtype)
    for name in ("colidx", "values", "diag"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.num_rows, got.num_columns, got.num_nonzeros) == \
        (want.num_rows, want.num_columns, want.num_nonzeros)


def test_ell_padding_and_properties():
    coo = random_coo(np.random.RandomState(2), 13, 9, 40)
    ell = ell_from_coo(port_coo(coo))
    assert ell.padded_rows == 16 and ell.rowsize == ell.values.shape[0]
    assert ell.ellsize == 13 * ell.rowsize and ell.diagsize == 9
    # padding slots: column min(i, m-1), value 0
    pad = ell.values == 0
    rows = torch.arange(16).expand_as(ell.colidx)
    assert torch.equal(ell.colidx[pad], rows.clamp(max=8)[pad])
    moved = ell.to("cpu")
    assert torch.equal(moved.values, ell.values) and moved.diag is None
