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
from ellspmv_tpu_torch.formats import ell as port_ell
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


def _rows_of_16_and_one_of_63(num_columns):
    rng = np.random.RandomState(0)
    n = 20_000
    rows = np.concatenate([np.repeat(np.arange(n), 16), np.zeros(47)])
    cols = rng.randint(0, num_columns, len(rows))
    return (n, num_columns, rows.astype(np.int32), cols.astype(np.int32),
            rng.randn(len(rows)))


def test_stream_when_it_moves_fewer_bytes(monkeypatch):
    # rows of 16 entries and one of 63: ELLPACK pads 3.9x (accepted). Below
    # that gate narrow ELL columns (2 bytes a slot) always move fewer bytes
    # than the stream format, so the columns spread over 70,000: every
    # block of 256 rows then spans more than 65,536 of them, the ELL keeps
    # 4-byte columns, and in f32 its 8 bytes per slot cost more than the
    # stream's bytes. The JAX chooser takes ELL here by its TPU prices (a
    # known divergence, ROADMAP F8)
    monkeypatch.setenv("HBM_PEAK_GBPS", "3350")
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    coo = CooMatrix(*_rows_of_16_and_one_of_63(70_000))
    assert not port_ell.narrow_columns_fit(coo.rowidx, coo.colidx, 20_000,
                                           70_000, 63)
    sm = auto_from_coo(coo, value_dtype="float32")
    assert isinstance(sm, StreamMatrix), sm._auto_reason
    assert sm._auto_reason.startswith("stream (est ")
    assert " beats ELL (est " in sm._auto_reason
    ell = auto_from_coo(coo, value_dtype="float64")
    assert isinstance(ell, EllMatrix), ell._auto_reason
    assert ell.lcol is None
    want = jax_auto_from_coo(coo, value_dtype="float32")
    assert want._auto_choice == "ell"


def test_narrow_ell_beats_the_stream_as_in_jax(monkeypatch):
    # the same rows with their columns in 20,000: the narrow ELL's 6 bytes
    # a slot in f32 beat the stream format, and both choosers take ELL
    monkeypatch.setenv("ELLSPMV_TPU_PALLAS_INTERPRET", "1")
    coo = CooMatrix(*_rows_of_16_and_one_of_63(20_000))
    got = auto_from_coo(coo, value_dtype="float32")
    assert isinstance(got, EllMatrix) and got.lcol is not None
    assert "; ELL beats the stream format (" in got._auto_reason
    assert jax_auto_from_coo(coo, value_dtype="float32")._auto_choice == \
        "ell"


def test_bf16_may_choose_dia():
    # JAX never chooses DIA in bf16 (its DIA kernel takes no bf16); the
    # port's kernel does, so the byte count decides (ROADMAP Queue 3)
    dia = auto_from_coo(port_coo(poisson2d(24)), value_dtype="bfloat16")
    assert dia._auto_choice == "dia" and dia.data.dtype == torch.bfloat16
