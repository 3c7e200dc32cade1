"""The port's `auto_from_coo` against the JAX package's chooser: the same
choice on the same matrices, the DIA it returns equal to JAX's, only the
chosen matrix built, and the stream format where the ELLPACK padding blows
up (the JAX chooser also prices the SELL split there, which is not yet
ported) or where it moves fewer bytes than ELL. The JAX chooser runs with
the interpret variable set, as its own tests do
(tests/test_stream.py::test_auto_picks_dia_for_stencil)."""

import numpy as np
import pytest
import torch

from ellspmv_tpu.formats.auto import auto_from_coo as jax_auto_from_coo
from ellspmv_tpu.models.generators import banded_random, fem_mesh_2d, poisson2d
from ellspmv_tpu_torch.bench.traffic import stream_bytes_estimate
from ellspmv_tpu_torch.formats import ell as port_ell
from ellspmv_tpu_torch.formats import stream as port_stream
from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.dia import DiaMatrix
from ellspmv_tpu_torch.formats.ell import EllMatrix
from ellspmv_tpu_torch.formats.stream import StreamMatrix
from ellspmv_tpu_torch.ops.dispatch import spmv


def port_coo(coo) -> CooMatrix:
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     coo.values, coo.symmetry, coo.field)


# name -> (matrix, keyword arguments, the choice both make)
CASES = {
    "poisson2d": (lambda: poisson2d(24), {}, "dia"),
    "fem_mesh_2d": (lambda: fem_mesh_2d(64), {}, "dia"),
    "banded_random": (lambda: banded_random(400, 5, 32), {}, "ell"),
    "separate_diagonal": (lambda: poisson2d(24),
                          {"separate_diagonal": True}, "ell"),
    "dia_not_allowed": (lambda: poisson2d(24), {"allow_dia": False}, "ell"),
    "fem_mesh_2d_f32": (lambda: fem_mesh_2d(16),
                        {"value_dtype": "float32"}, "dia"),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_same_choice_as_jax(name, monkeypatch):
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    make, kw, choice = CASES[name]
    kw = {"value_dtype": "float64", **kw}
    coo = make()
    want = jax_auto_from_coo(coo, **kw)
    got = auto_from_coo(port_coo(coo), **kw)
    assert want._auto_choice == got._auto_choice == choice
    assert isinstance(got, DiaMatrix if choice == "dia" else EllMatrix)
    if choice == "dia":
        # the DIA JAX chose, bit for bit
        assert got.offsets == want.offsets
        np.testing.assert_array_equal(got.data.numpy(),
                                      np.asarray(want.data))
        assert "dense diagonals" in got._auto_reason
    else:
        assert "; ELL beats the stream format (" in got._auto_reason
        assert (got.diag is not None) == kw.get("separate_diagonal", False)


def test_dia_reason_prices_by_bytes_at_the_card_peak(monkeypatch):
    monkeypatch.setenv("HBM_PEAK_GBPS", "3350")
    coo = port_coo(fem_mesh_2d(64))
    dia = auto_from_coo(coo, value_dtype="float64")
    n = coo.num_rows
    dia_ms = (dia.diasize + 2 * n) * 8 / 3.35e12 * 1e3
    assert dia._auto_reason.startswith(
        f"{dia.num_diags} dense diagonals (est {dia_ms:.3f} ms <= ELL est ")


def test_only_the_chosen_matrix_is_built(monkeypatch):
    def no_ell(*args, **kwargs):
        raise AssertionError("ELL built although DIA was chosen")
    monkeypatch.setattr(port_ell, "ell_from_coo", no_ell)
    dia = auto_from_coo(port_coo(poisson2d(24)), value_dtype="float64",
                        device="meta")
    assert isinstance(dia, DiaMatrix) and dia.device.type == "meta"
    assert dia._auto_choice == "dia"


def test_padding_blowup_is_not_yet_ported():
    # one row of 300 entries over 20,000 rows of one: ELLPACK would hold
    # 6M slots for 20,299 nonzeros, where JAX takes the SELL/stream branch;
    # the port takes the stream format, as the SELL split is not yet ported
    n = 20_000
    rows = np.concatenate([np.arange(n), np.zeros(299, np.int64)])
    cols = np.concatenate([np.arange(n), np.arange(1, 300)])
    coo = CooMatrix(n, n, rows.astype(np.int32), cols.astype(np.int32),
                    np.ones(len(rows)))
    sm = auto_from_coo(coo, value_dtype="float64")
    assert isinstance(sm, StreamMatrix) and sm._auto_choice == "stream"
    assert sm._auto_reason.startswith(
        "ELL padding blowup (6,000,000 slots for 20,299 nonzeros); stream (")
    assert "the SELL split, which the JAX chooser prices against it here, "\
        "is not yet ported" in sm._auto_reason
    got = spmv(sm, torch.ones(n, dtype=torch.float64)).numpy()
    want = np.ones(n)
    want[0] = 300
    np.testing.assert_array_equal(got, want)


def _rows_of_16_and_one_of(longest, num_columns):
    rng = np.random.RandomState(0)
    n = 20_000
    rows = np.concatenate([np.repeat(np.arange(n), 16),
                           np.zeros(longest - 16)])
    cols = rng.randint(0, num_columns, len(rows))
    return (n, num_columns, rows.astype(np.int32), cols.astype(np.int32),
            rng.randn(len(rows)))


def _stream_ms(coo, value_bytes, narrow):
    n, m = coo.num_rows, coo.num_columns
    return stream_bytes_estimate(coo.num_nonzeros, n, m, value_bytes,
                                 narrow) / 3.35e12 * 1e3


def test_stream_when_it_moves_fewer_bytes(monkeypatch):
    # rows of 16 entries and one of 63: ELLPACK pads 3.9x (accepted). The
    # columns spread over 70,000, so every block of 256 rows spans more
    # than 65,536 of them and the ELL keeps 4-byte columns. The stream's
    # products, in the sum plan's position order, hold the s-th column of
    # each row in run s, which keeps their blocks under 65,536: priced by
    # the layout they took (2-byte columns), the stream moves fewer bytes
    # in both types. The JAX chooser takes ELL here by its TPU prices (a
    # known divergence, ROADMAP F8)
    monkeypatch.setenv("HBM_PEAK_GBPS", "3350")
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    coo = CooMatrix(*_rows_of_16_and_one_of(63, 70_000))
    assert not port_ell.narrow_columns_fit(coo.rowidx, coo.colidx, 20_000,
                                           70_000, 63)
    for precision in ("float32", "float64"):
        sm = auto_from_coo(coo, value_dtype=precision)
        assert isinstance(sm, StreamMatrix), sm._auto_reason
        assert sm.prod.lcol is not None
        ms = _stream_ms(coo, sm.values.element_size(), True)
        assert sm._auto_reason.startswith(f"stream (est {ms:.3f} ms) beats "
                                          "ELL (est ")
        want = jax_auto_from_coo(coo, value_dtype=precision)
        assert want._auto_choice == "ell"


def test_narrow_ell_beats_the_stream_as_in_jax(monkeypatch):
    # rows of 16 entries and one of 63, columns in 20,000: ELLPACK pads 3.9x
    # (accepted) and keeps 2-byte columns. The JAX chooser takes ELL. The
    # port's byte rule takes the stream format in both types: its products
    # in position order keep 2-byte columns too, and it moves no padding
    # (f32: 5,042,108 bytes against the narrow ELL's 7,720,316). Between
    # about 2.5x padding (2.8x in fp64) and the blowup gate the two
    # choosers part (ROADMAP F8)
    monkeypatch.setenv("HBM_PEAK_GBPS", "3350")
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    coo = CooMatrix(*_rows_of_16_and_one_of(63, 20_000))
    assert port_ell.narrow_columns_fit(coo.rowidx, coo.colidx, 20_000,
                                       20_000, 63)
    for precision in ("float32", "float64"):
        sm = auto_from_coo(coo, value_dtype=precision)
        assert isinstance(sm, StreamMatrix), sm._auto_reason
        assert sm.prod.lcol is not None
        ms = _stream_ms(coo, sm.values.element_size(), True)
        assert sm._auto_reason.startswith(f"stream (est {ms:.3f} ms) beats "
                                          "ELL (est ")
        want = jax_auto_from_coo(coo, value_dtype=precision)
        assert want._auto_choice == "ell" and want.num_rows == 20_000
    assert stream_bytes_estimate(coo.num_nonzeros, 20_000, 20_000, 4,
                                 True) == 5_042_108


def test_narrow_ell_beats_even_the_least_stream_price(monkeypatch):
    # rows of 16 and one of 24, columns in 20,000: the narrow ELL's 6 bytes
    # a slot in f32 beat even the stream's least price (2-byte product
    # columns), so no stream layout is built, and both choosers take ELL
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")

    def no_stream(*args, **kwargs):
        raise AssertionError("the stream format was laid out to be priced")
    monkeypatch.setattr(port_stream, "stream_layout", no_stream)
    coo = CooMatrix(*_rows_of_16_and_one_of(24, 20_000))
    got = auto_from_coo(coo, value_dtype="float32")
    assert isinstance(got, EllMatrix) and got.lcol is not None
    assert "; ELL beats the stream format (at least " in got._auto_reason
    assert jax_auto_from_coo(coo, value_dtype="float32")._auto_choice == \
        "ell"


def test_ell_when_the_built_products_are_wide(monkeypatch):
    # rows of 16 and one of 37, columns over 200,000: with 2-byte product
    # columns the stream would beat the wide ELL, so its plan and products
    # are laid out on the host; their blocks span more than 65,536 columns
    # even in position order, at 4 bytes a column the stream costs more
    # than ELL, and the products' ELL is never built
    monkeypatch.setenv("HBM_PEAK_GBPS", "3350")

    def no_products(*args, **kwargs):
        raise AssertionError("the stream format was built, not chosen")
    monkeypatch.setattr(port_stream, "stream_from_layout", no_products)
    coo = CooMatrix(*_rows_of_16_and_one_of(37, 200_000))
    assert _stream_ms(coo, 4, True) < _stream_ms(coo, 4, False)
    assert not port_stream.stream_layout(coo).products_narrow()
    got = auto_from_coo(coo, value_dtype="float32")
    assert isinstance(got, EllMatrix) and got.lcol is None, got._auto_reason
    assert got._auto_reason.endswith(
        f"; ELL beats the stream format (est "
        f"{_stream_ms(coo, 4, False):.3f} ms)")


def test_bf16_may_choose_dia():
    # JAX never chooses DIA in bf16 (its DIA kernel takes no bf16); the
    # port's kernel does, so the byte count decides (ROADMAP Queue 3)
    dia = auto_from_coo(port_coo(poisson2d(24)), value_dtype="bfloat16")
    assert dia._auto_choice == "dia" and dia.data.dtype == torch.bfloat16
