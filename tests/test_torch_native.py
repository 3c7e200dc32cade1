"""The port's native host path (``io/native.py`` over ``csrc/host/*.cc``),
its calibration (``bench/calibrate.py``) and the reference-scale run
(``bench/reference_scale.py``) against the JAX package on the CPU.

The host library is built with ``g++`` into a temporary directory for this
module. Everything is held against the JAX package on the same files and
arrays: the parser against JAX's NumPy and native readers (the COO bit for
bit, the error type and text), the writer's bytes against JAX's native
writer, the argsort against NumPy's stable argsort, and the ELLPACK and
stream plans built with the native library against those built without it,
bit for bit."""

import gzip
import io
import json
import os
import pathlib
import types

import numpy as np
import pytest
import torch

from ellspmv_tpu.formats.ell import ell_from_coo as jax_ell_from_coo
from ellspmv_tpu.io import mtx as jax_mtx
from ellspmv_tpu.io import native as jax_native
from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.bench import calibrate, reference_scale
from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.formats.stream import stream_from_coo, stream_spmv
from ellspmv_tpu_torch.io import mtx, native
from ellspmv_tpu_torch.models.generators import (dense_rows, fem_mesh_2d,
                                                 power_law)
from ellspmv_tpu_torch.utils import calibration as calibration_cache
from tests.conftest import random_coo
from torch_cases import assert_deep_equal

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def host_library(tmp_path_factory):
    """The port's host library built with g++ into a directory of this
    module's own, loaded in place of any built before."""
    if native.find_cxx() is None:
        pytest.skip("no C++ compiler: the native path is not available")
    saved = (native.BUILD_DIR, dict(native._state))
    native.BUILD_DIR = tmp_path_factory.mktemp("native_build")
    native._state.clear()
    assert native.available()
    yield native.BUILD_DIR
    native.BUILD_DIR = saved[0]
    native._state.clear()
    native._state.update(saved[1])


@pytest.fixture
def jax_native_reader():
    if not jax_native.available():
        pytest.skip("the JAX package's native library is not available")


def port_coo(coo) -> CooMatrix:
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     coo.values, coo.symmetry, coo.field)


def assert_same_coo(a, b):
    assert (a.num_rows, a.num_columns, a.symmetry, a.field) == \
        (b.num_rows, b.num_columns, b.symmetry, b.field)
    for name in ("rowidx", "colidx", "values"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, name
        np.testing.assert_array_equal(x, y, err_msg=name)


# -- the build ------------------------------------------------------------

def test_library_built_into_its_directory(host_library):
    built = sorted(p.name for p in host_library.iterdir())
    assert len(built) == 1 and built[0].startswith("libellspmv_host_")
    assert built[0] == native.library_path(native.find_cxx()).name
    assert [p.name for p in native.sources()] == ["mtxio.cc", "mtxwrite.cc",
                                                  "sortperm.cc"]
    assert "-march=native" in native.CXX_FLAGS and "-lz" in native.LIBS


def test_library_path_tracks_sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for p in native.sources():
        (src / p.name).write_bytes(p.read_bytes())
    cxx = native.find_cxx()
    same = native.library_path(cxx, src, tmp_path)
    assert same.name == native.library_path(cxx).name
    (src / "sortperm.cc").write_text((src / "sortperm.cc").read_text()
                                     + "\n// edited\n")
    assert native.library_path(cxx, src, tmp_path).name != same.name


def test_failed_compile_raises_with_stderr(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    (src / "broken.cc").write_text("int f( { return 0; }\n")
    with pytest.raises(RuntimeError, match="failed with exit code") as e:
        native.build(native.find_cxx(), src, tmp_path / "out")
    assert "broken.cc" in str(e.value)
    assert list((tmp_path / "out").iterdir()) == []


def test_no_compiler_means_not_available(monkeypatch):
    monkeypatch.setattr(native, "find_cxx", lambda: None)
    monkeypatch.setattr(native, "_state", {})
    assert native.available() is False
    with pytest.raises(native.NativeUnsupported):
        native.read_matrix(str(REPO / "examples" / "test.mtx"))
    with pytest.raises(native.NativeUnsupported):
        native.ell_pack(1, 1, 8, 1, [0], [0], [1.0], False)
    keys = np.arange(200_000)[::-1]
    np.testing.assert_array_equal(native.argsort(keys),
                                  np.argsort(keys, kind="stable"))
    # the readers take NumPy, and use_native=True says why it cannot
    coo = mtx.read_matrix(str(REPO / "examples" / "test.mtx"))
    assert coo.num_nonzeros == 9
    with pytest.raises(RuntimeError, match="requested but unavailable"):
        mtx.read_matrix(str(REPO / "examples" / "test.mtx"), use_native=True)


# -- the parser -----------------------------------------------------------

FILES = {
    "pattern.mtx": "%%MatrixMarket matrix coordinate pattern general\n"
                   "3 3 4\n1 1\n2 3\n3 1\n3 3\n",
    "symmetric.mtx": "%%MatrixMarket matrix coordinate real symmetric\n"
                     "% lower triangle only\n4 4 6\n1 1 2.5\n2 1 -1\n"
                     "3 2 -1e-3\n4 4 7\n4 1 0.25\n3 3 1\n",
    "integer.mtx": "%%MatrixMarket matrix coordinate integer general\n"
                   "2 3 3\n1 1 4\n2 3 -2\n1 2 7\n",
    "comments.mtx": "%%MatrixMarket matrix coordinate real general\n"
                    "% one\n%two\n\n   \n% three\n3 4 3\n1 4 1e-300\n"
                    "3 1\t-0.125\n2 2 12345678901234567\n",
    "double.mtx": "%%MatrixMarket MATRIX Coordinate DOUBLE General\n"
                  "2 2 2\n1 1 0.1\n2 2 3.3333333333333335\n",
    "empty.mtx": "%%MatrixMarket matrix coordinate real general\n5 3 0\n",
}


def _big_text(nnz=150_000):
    """A file long enough that the parser splits it over threads."""
    coo = random_coo(np.random.RandomState(7), 3000, 2000, nnz,
                     with_dups=True)
    out = io.StringIO()
    jax_mtx.write_matrix(out, coo)
    return out.getvalue()


def _write(tmp_path, name):
    p = tmp_path / name
    if name == "big.mtx":
        p.write_text(_big_text())
    elif name in ("test.mtx", "test_spd.mtx"):
        p.write_bytes((REPO / "examples" / name).read_bytes())
    elif name == "test.mtx.gz":
        with gzip.open(p, "wb") as g:
            g.write((REPO / "examples" / "test.mtx").read_bytes())
    else:
        p.write_text(FILES[name])
    return str(p)


@pytest.mark.parametrize("name,gzipped,index_dtype,value_dtype", [
    ("test.mtx", None, None, np.float64),
    ("test_spd.mtx", None, None, np.float64),
    ("pattern.mtx", None, None, np.float64),
    ("symmetric.mtx", None, None, np.float64),
    ("integer.mtx", None, "int64", np.float64),
    ("comments.mtx", None, None, np.float64),
    ("double.mtx", None, None, np.float32),
    ("empty.mtx", None, None, np.float64),
    ("big.mtx", None, None, np.float64),
    ("big.mtx", None, "int64", np.float32),
    ("test.mtx.gz", None, None, np.float64),
    ("test.mtx.gz", True, None, np.float64),
    ("test.mtx", True, None, np.float64),   # -z on a plain file
])
def test_native_reader_matches_jax(tmp_path, jax_native_reader, name,
                                   gzipped, index_dtype, value_dtype):
    path = _write(tmp_path, name)
    kw = dict(gzipped=gzipped, index_dtype=index_dtype,
              value_dtype=value_dtype)
    got = mtx.read_matrix(path, use_native=True, **kw)
    assert_same_coo(got, jax_mtx.read_matrix(path, use_native=False, **kw))
    assert_same_coo(got, jax_mtx.read_matrix(path, use_native=True, **kw))
    assert_same_coo(got, mtx.read_matrix(path, use_native=False, **kw))
    # by default a path takes the native parser
    assert_same_coo(mtx.read_matrix(path, **kw), got)


MALFORMED = {
    "banner": "%%MatrixMarkt matrix coordinate real general\n1 1 1\n1 1 1\n",
    "banner_short": "%%MatrixMarket matrix coordinate real\n1 1 1\n",
    "no_newline": "%%MatrixMarket matrix coordinate real general",
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
    "zero_index": "%%MatrixMarket matrix coordinate real general\n2 2 1\n"
                  "0 1 1\n",
    "array": "%%MatrixMarket matrix array real general\n2 2\n1\n2\n3\n4\n",
    "vector": "%%MatrixMarket vector array real general\n2\n1\n2\n",
    "big_garbage": None,
    "big_range": None,
    "missing": None,
}


def _malformed(tmp_path, case):
    p = tmp_path / f"{case}.mtx"
    if case == "missing":
        return str(p)
    text = MALFORMED[case]
    if case == "big_garbage":
        text = _big_text().replace("\n17 ", "\n17 x", 1)
    elif case == "big_range":
        lines = _big_text().split("\n")
        lines[100_000] = "1 9999 1.0"
        text = "\n".join(lines)
    p.write_text(text)
    return str(p)


def _error(fn, path, **kw):
    with pytest.raises(Exception) as e:
        fn(path, **kw)
    return type(e.value).__name__, str(e.value)


def _outcome(fn, path, **kw):
    """The COO read, or the error's type and text."""
    try:
        return fn(path, **kw)
    except Exception as e:
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_malformed_files_fail_as_in_jax(tmp_path, jax_native_reader, case):
    """The same outcome as the JAX package, by default (the native parser,
    or NumPy for what it does not take) and with either parser asked for:
    the same error type and text, or, where the native parser skips a
    comment line in the body as JAX's does, the same COO."""
    path = _malformed(tmp_path, case)
    for use_native in (None, True, False):
        got = _outcome(mtx.read_matrix, path, use_native=use_native)
        want = _outcome(jax_mtx.read_matrix, path, use_native=use_native)
        if isinstance(want, tuple):
            assert got == want, use_native
        else:
            assert case == "comment" and use_native is not False
            assert_same_coo(got, want)


def test_native_parser_refuses_file_objects(jax_native_reader):
    text = FILES["pattern.mtx"].encode()
    got = _error(mtx.read_matrix, io.BytesIO(text), use_native=True)
    assert got == _error(jax_mtx.read_matrix, io.BytesIO(text),
                         use_native=True)
    assert_same_coo(mtx.read_matrix(io.BytesIO(text)),
                    jax_mtx.read_matrix(io.BytesIO(text), use_native=False))


# -- the writer -----------------------------------------------------------

@pytest.mark.parametrize("pattern,symmetric", [(False, False), (True, False),
                                               (False, True)])
def test_native_writer_bytes_equal_jax(tmp_path, jax_native_reader, pattern,
                                       symmetric):
    coo = random_coo(np.random.RandomState(8), 500, 300, 4000,
                     pattern=pattern, symmetric=symmetric)
    values = None if pattern else coo.values * 10.0 ** np.arange(-6, 7).repeat(
        -(-len(coo.values) // 13))[:len(coo.values)]
    got, want = tmp_path / "port.mtx", tmp_path / "jax.mtx"
    native.write_coo(got, coo.num_rows, coo.num_columns, coo.rowidx,
                     coo.colidx, values, symmetric=symmetric)
    jax_native.write_coo(str(want), coo.num_rows, coo.num_columns,
                         coo.rowidx, coo.colidx, values, symmetric=symmetric)
    assert got.read_bytes() == want.read_bytes()
    back = mtx.read_matrix(str(got))
    assert (back.symmetry, back.field) == (
        "symmetric" if symmetric else "general",
        "pattern" if pattern else "real")
    np.testing.assert_array_equal(back.rowidx, coo.rowidx)
    np.testing.assert_array_equal(back.colidx, coo.colidx)
    np.testing.assert_array_equal(
        back.values, np.ones(len(coo.rowidx)) if pattern else values)


def test_write_matrix_takes_the_native_writer_when_large(tmp_path,
                                                         jax_native_reader,
                                                         monkeypatch):
    """A matrix of at least 1,000,000 entries written to a path takes the
    native writer, as JAX's does: the same bytes, read back exactly."""
    rng = np.random.RandomState(9)
    nnz = mtx.NATIVE_WRITE_MIN_ENTRIES
    coo = CooMatrix(70_000, 50_000, rng.randint(0, 70_000, nnz),
                    rng.randint(0, 50_000, nnz), rng.randn(nnz) * 1e5)
    calls = []
    real = native.write_coo
    monkeypatch.setattr(native, "write_coo",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, want = tmp_path / "port.mtx", tmp_path / "jax.mtx"
    mtx.write_matrix(str(got), coo)
    jax_mtx.write_matrix(str(want), coo)
    assert calls == [1]
    assert got.read_bytes() == want.read_bytes()
    assert_same_coo(mtx.read_matrix(str(got)),
                    CooMatrix(coo.num_rows, coo.num_columns,
                              coo.rowidx.astype(np.int32),
                              coo.colidx.astype(np.int32), coo.values))
    # below the threshold, or to a file object, the Python writer
    small = CooMatrix(3, 3, coo.rowidx[:5] % 3, coo.colidx[:5] % 3,
                      coo.values[:5])
    mtx.write_matrix(str(tmp_path / "small.mtx"), small)
    assert calls == [1]


# -- the argsort ----------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.int32, np.int64,
                                   np.uint16])
@pytest.mark.parametrize("n,high", [(1000, 50), (200_000, 7),
                                    (200_000, 1 << 20), (300_000, 1 << 31)])
def test_argsort_equals_numpy_stable(dtype, n, high, jax_native_reader):
    high = min(high, np.iinfo(dtype).max)
    keys = np.random.RandomState(n + high).randint(
        0, high, n, dtype=np.int64).astype(dtype)
    got = native.argsort(keys)
    np.testing.assert_array_equal(got, np.argsort(keys, kind="stable"))
    np.testing.assert_array_equal(got, jax_native.argsort(keys))
    # the radix above the threshold (int32 positions), NumPy below it
    assert got.dtype == (np.int32 if n >= native.ARGSORT_MIN_KEYS
                         else np.int64)


@pytest.mark.parametrize("keys", ["negative", "float", "high_bytes"])
def test_argsort_edge_keys(keys):
    rng = np.random.RandomState(11)
    if keys == "negative":
        k = rng.randint(-5, 1000, 150_000).astype(np.int64)
    elif keys == "float":
        k = rng.randint(0, 1000, 150_000).astype(np.float64)
    else:   # only the top byte varies: every other pass is skipped
        k = (rng.randint(0, 4, 150_000).astype(np.uint64) << np.uint64(56))
    got = native.argsort(k)
    np.testing.assert_array_equal(got, np.argsort(k, kind="stable"))
    assert got.dtype == (np.int32 if keys == "high_bytes" else np.int64)


# -- COO -> ELLPACK -------------------------------------------------------

def _ell_case(name):
    rng = np.random.RandomState(12)
    if name == "dups":
        return random_coo(rng, 300, 200, 2500, with_dups=True)
    if name == "symmetric":
        return random_coo(rng, 250, 250, 1500, symmetric=True)
    if name == "empty_rows":
        coo = random_coo(rng, 400, 90, 600, with_dups=True)
        keep = coo.rowidx % 3 != 0
        return type(coo)(400, 90, coo.rowidx[keep], coo.colidx[keep],
                         coo.values[keep])
    return fem_mesh_2d(20, 17, extras=5, seed=1)


def _ell_arrays(ell):
    return {k: v for k, v in vars(ell).items()
            if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("case", ["dups", "symmetric", "empty_rows", "fem"])
@pytest.mark.parametrize("sort_rows", [False, True])
@pytest.mark.parametrize("kw", [
    {}, {"separate_diagonal": True}, {"rowsize": 40}, {"row_tile": 1024},
    {"value_dtype": "float32"}, {"value_dtype": "bfloat16"},
    {"index_dtype": "int64"},
], ids=["plain", "diag", "rowsize", "row_tile", "f32", "bf16", "int64"])
def test_ell_from_coo_native_bit_equal(case, sort_rows, kw, monkeypatch):
    coo = port_coo(_ell_case(case))
    packed = []
    real = native.ell_pack
    monkeypatch.setattr(native, "ell_pack",
                        lambda *a: packed.append(1) or real(*a))
    got = ell_from_coo(coo, sort_rows=sort_rows, **kw)
    # the native packer takes every int32 conversion
    assert packed == ([] if "index_dtype" in kw else [1])
    monkeypatch.setattr(native, "available", lambda: False)
    want = ell_from_coo(coo, sort_rows=sort_rows, **kw)
    assert packed == ([] if "index_dtype" in kw else [1])
    a, b = _ell_arrays(got), _ell_arrays(want)
    assert a.keys() == b.keys()
    for name in a:
        assert a[name].dtype == b[name].dtype, name
        assert torch.equal(a[name], b[name]), name
    assert (got.num_rows, got.num_columns, got.num_nonzeros) == \
        (want.num_rows, want.num_columns, want.num_nonzeros)


@pytest.mark.parametrize("sort_rows", [False, True])
def test_ell_from_coo_equals_jax_native(sort_rows, jax_native_reader):
    """The port's native ELLPACK against JAX's (which packs natively too)
    on a file both read natively."""
    coo = _ell_case("dups")
    got = ell_from_coo(port_coo(coo), sort_rows=sort_rows,
                       separate_diagonal=True)
    want = jax_ell_from_coo(coo, sort_rows=sort_rows, separate_diagonal=True)
    np.testing.assert_array_equal(got.colidx.numpy(),
                                  np.asarray(want.colidx).T)
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values).T)
    np.testing.assert_array_equal(got.diag.numpy(), np.asarray(want.diag))


def test_ell_pack_refuses_what_it_cannot_place():
    with pytest.raises(ValueError, match="overflows rowsize"):
        native.ell_pack(2, 2, 8, 1, [0, 0], [0, 1], [1.0, 2.0], False)
    with pytest.raises(ValueError, match="row index out of range"):
        native.ell_pack(2, 2, 8, 2, [0, 5], [0, 1], [1.0, 2.0], False)


# -- the stream plans -----------------------------------------------------

@pytest.mark.parametrize("case", ["power_law", "dense_rows", "symmetric_diag",
                                  "chunked"])
def test_stream_plans_native_bit_equal(case, monkeypatch):
    """The stream format's plan, products and y with the native argsort
    and with NumPy's, bit for bit; the native sort took the large keys."""
    kw = {}
    if case == "power_law":
        coo = power_law(30_000, 6, seed=2)
    elif case == "dense_rows":
        coo = dense_rows(20_000, 6, num_dense=4, dense_nnz=5000, seed=1)
    elif case == "symmetric_diag":
        coo = port_coo(random_coo(np.random.RandomState(13), 40_000, 40_000,
                                  90_000, symmetric=True))
        kw = {"separate_diagonal": True}
    else:
        coo = power_law(30_000, 6, seed=3)
        kw = {"n_chunks": 3}
    sorted_natively = []
    lib = native._load()
    for name in ("mtxio_argsort_u32", "mtxio_argsort_u64"):
        fn = getattr(lib, name)
        monkeypatch.setattr(lib, name,
                            lambda *a, fn=fn: sorted_natively.append(a[0])
                            or fn(*a))
    got = stream_from_coo(coo, **kw)
    assert sorted_natively and max(sorted_natively) >= native.ARGSORT_MIN_KEYS
    monkeypatch.setattr(native, "available", lambda: False)
    want = stream_from_coo(coo, **kw)
    assert_deep_equal(got, want)
    x = torch.from_numpy(np.random.RandomState(14).rand(coo.num_columns))
    assert torch.equal(stream_spmv(got, x), stream_spmv(want, x))


# -- the calibration ------------------------------------------------------

@pytest.fixture
def calibration(tmp_path, monkeypatch):
    """The cache in a directory of the test's own, nothing injected."""
    monkeypatch.setattr(calibration_cache, "CACHE_PATH",
                        tmp_path / "calib.json")
    yield tmp_path / "calib.json"
    calibrate.inject(None)


def mock_card(monkeypatch, name, sms=132):
    """Make ``torch.cuda`` name a card `name` with `sms` SMs, so that the
    pricing of ``device="cuda"`` runs here as it would on that card."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: name)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: types.SimpleNamespace(
                            multi_processor_count=sms))
    monkeypatch.delenv("HBM_PEAK_GBPS", raising=False)


def test_defaults_and_injection(calibration):
    name = calibrate.K1_ROUND["float64"]
    card = config.HOST_PRICED_CARD
    assert calibrate.get(name, card) is None
    calibrate.inject({name: 5e-6})
    assert calibrate.get(name, card) == 5e-6
    # the names not injected still fall through
    assert calibrate.get(calibrate.RATE, card) is None
    calibrate.inject(None)
    assert calibrate.get(name, card) is None


def test_cache_keyed_by_card(calibration):
    calibration.write_text(json.dumps({
        "Some Card": {calibrate.RATE: 1.5e12,
                      calibrate.K1_ROUND["float32"]: 2e-6}}))
    assert calibrate.get(calibrate.RATE, "Some Card") == 1.5e12
    assert calibrate.get(calibrate.RATE, "Some Card", cached=False) is None
    assert calibrate.get(calibrate.RATE, "Another Card") is None
    assert calibrate.get(calibrate.K1_ROUND["float32"], "Some Card") == 2e-6
    # injection comes first
    calibrate.inject({calibrate.RATE: 1e12})
    assert calibrate.get(calibrate.RATE, "Some Card") == 1e12
    calibration.write_text("{not json")
    calibrate.inject(None)
    assert calibrate.get(calibrate.RATE, "Some Card") is None


def test_save_keeps_the_other_cards(calibration):
    values = {calibrate.K1_ROUND["float64"]: 3e-6, calibrate.RATE: 1e12}
    calibration_cache.save("Some Card", values)
    calibration_cache.save("Another Card", {calibrate.RATE: 2e12})
    assert calibration_cache.load() == {"Some Card": values,
                                        "Another Card": {calibrate.RATE:
                                                         2e12}}
    calibration_cache.save("Some Card", {calibrate.RATE: 1.1e12})
    assert calibrate.get(calibrate.RATE, "Some Card") == 1.1e12
    assert calibrate.get(calibrate.K1_ROUND["float64"], "Some Card") is None
    assert [p.name for p in calibration.parent.iterdir()] == ["calib.json"]


def test_plausibility_gate_drops_jittered_measurements():
    out = {calibrate.K1_ROUND["float64"]: 1.7e-6,
           calibrate.K1_ROUND["float32"]: 1e-12, calibrate.RATE: 1e17}
    log = io.StringIO()
    calibrate._apply_plausibility_gate(out, log)
    assert out == {calibrate.K1_ROUND["float64"]: 1.7e-6}
    assert log.getvalue().count("implausible") == 2
    out = {calibrate.RATE: 2.9e12}
    assert calibrate._apply_plausibility_gate(out) == {calibrate.RATE: 2.9e12}


def test_no_cache_prices_as_before(calibration):
    card = config.HOST_PRICED_CARD
    assert config.k1_geometry("cpu") == (config.K1_ROUND_SECONDS[card],
                                         config.SM_COUNT[card])
    assert config.k1_geometry("cpu", torch.float32)[0] == \
        config.K1_ROUND_SECONDS[card]
    assert config.pricing_rate("cpu") == config.HBM_PEAK_BYTES_PER_S[card]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_off_a_card_the_cache_is_not_read(calibration, device):
    """A cache made on the card in this checkout leaves every price, and so
    every pick, off a card as `config.py` makes it."""
    card = config.HOST_PRICED_CARD
    calibration.write_text(json.dumps({card: {
        calibrate.K1_ROUND["float64"]: 3e-6,
        calibrate.K1_ROUND["float32"]: 2e-6, calibrate.RATE: 1e12}}))
    assert config.k1_geometry(device) == (config.K1_ROUND_SECONDS[card],
                                          config.SM_COUNT[card])
    assert config.k1_geometry(device, torch.float32)[0] == \
        config.K1_ROUND_SECONDS[card]
    assert config.pricing_rate(device) == config.HBM_PEAK_BYTES_PER_S[card]


def test_geometry_follows_the_calibration(calibration, monkeypatch):
    card = config.HOST_PRICED_CARD
    mock_card(monkeypatch, card, sms=114)
    assert config.k1_geometry("cuda") == (config.K1_ROUND_SECONDS[card], 114)
    calibration_cache.save(card, {
        calibrate.K1_ROUND["float64"]: 3e-6,
        calibrate.K1_ROUND["float32"]: 2e-6, calibrate.RATE: 1e12})
    assert config.k1_geometry("cuda") == (3e-6, 114)
    assert config.k1_geometry("cuda", torch.float32)[0] == 2e-6
    assert config.k1_geometry("cuda", torch.bfloat16)[0] == 3e-6
    # a card in the data-sheet table keeps its data sheet
    assert config.pricing_rate("cuda") == config.HBM_PEAK_BYTES_PER_S[card]
    calibrate.inject({calibrate.K1_ROUND["float64"]: 4e-6})
    assert config.k1_geometry("cuda")[0] == 4e-6
    assert config.k1_geometry("cpu")[0] == 4e-6


def test_unknown_card_takes_its_cached_rate(calibration, monkeypatch):
    mock_card(monkeypatch, "Unknown Card")
    h100 = config.HBM_PEAK_BYTES_PER_S[config.HOST_PRICED_CARD]
    assert config.pricing_rate("cuda") == h100
    assert config.k1_geometry("cuda")[0] == \
        config.K1_ROUND_SECONDS[config.HOST_PRICED_CARD]
    calibration_cache.save("Unknown Card", {calibrate.RATE: 1.2e12,
                           calibrate.K1_ROUND["float64"]: 2.5e-6})
    assert config.pricing_rate("cuda") == 1.2e12
    assert config.k1_geometry("cuda")[0] == 2.5e-6
    assert config.pricing_rate("cpu") == h100
    monkeypatch.setenv("HBM_PEAK_GBPS", "900")
    assert config.pricing_rate("cuda") == 9e11


def test_chooser_follows_an_injected_k1_latency(calibration):
    """At the blowup gate of dense_rows the chooser takes the stream
    format by K1's measured latency; a card whose short launches cost
    nothing (an injected latency of 0) gets the SELL split, priced by its
    bytes."""
    coo = dense_rows(100_000, 8, num_dense=16, dense_nnz=12_500, seed=0)
    assert auto_from_coo(coo, value_dtype="float64",
                         device="meta")._auto_choice == "stream"
    # a cache does not reach the pricing off a card
    calibration_cache.save(config.HOST_PRICED_CARD,
                           {calibrate.K1_ROUND["float64"]: 0.0})
    assert auto_from_coo(coo, value_dtype="float64",
                         device="meta")._auto_choice == "stream"
    calibrate.inject({calibrate.K1_ROUND["float64"]: 0.0})
    assert auto_from_coo(coo, value_dtype="float64",
                         device="meta")._auto_choice == "sell"


def test_calibrate_needs_a_card(calibration):
    with pytest.raises(ValueError, match="needs a CUDA device"):
        calibrate.calibrate(save=True, device="cpu")
    assert not calibration.exists()


def test_calibrate_program_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert calibrate.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert calibrate.main(["--bogus"]) == 1


# -- the reference-scale run ----------------------------------------------

def test_reference_scale_end_to_end_on_cpu(tmp_path, capsys):
    """The whole run at a tiny mesh: the file written natively reads back
    to the generator's COO, and the program's read, convert and gemv
    lines come back with the summary."""
    nx = 12
    assert reference_scale.main(["--nx", str(nx), "--dir", str(tmp_path),
                                 "--device=cpu", "--gen-only"]) == 0
    path = reference_scale.matrix_path(tmp_path, nx)
    assert_same_coo(mtx.read_matrix(path, use_native=True),
                    fem_mesh_2d(nx, nx, extras=5, seed=1))
    assert reference_scale.main(["--nx", str(nx), "--dir", str(tmp_path),
                                 "--device=cpu", "--run-only"]) == 0
    out = capsys.readouterr().out
    assert not os.path.exists(path)
    assert "host: " in out and "card: " not in out
    assert f"fem_mesh_2d({nx}, extras=5, seed=1): {nx * nx:,} rows" in out
    assert "the native writer" in out
    assert "  mtxfile_read: " in out and "  ell_from_coo: " in out
    assert "-iteration chained span" in out
    assert "reference scale: read " in out and "GB/s effective" in out


def test_reference_scale_reports_a_failed_run(tmp_path, capsys):
    assert reference_scale.main(["--nx", "4", "--dir", str(tmp_path),
                                 "--device=cpu", "--run-only"]) == 1
    assert "exit 1" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        reference_scale.main(["--nx", "0"])


def test_reference_scale_summary():
    stderr = ("mtxfile_read: 12.5 seconds (312.4 MB/s)\n"
              "ell_from_coo: 7.25 seconds, 6,812,100 rows\n"
              "gemv: 0.000601000 seconds/iteration (slope over a 512-"
              "iteration chained span; 190.2 Gnz/s, 380.4 Gflop/s, "
              "2537.4 to 2900.1 GB/s)\n")
    assert reference_scale.summary(stderr) == (
        "reference scale: read 12.5 s (312.4 MB/s), ell_from_coo 7.25 s, "
        "gemv 0.000601000 s/iteration, 2537.4 GB/s effective = 17.14x the "
        "reference's 148 GB/s")
    assert reference_scale.summary(stderr.split("gemv")[0]) is None
