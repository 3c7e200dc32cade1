"""The chooser's ELLPACK candidate in the span recorder, on the CPU: on
DIMACS10's random geometric graph numbered by grid cell (the class the
benchmark's ``rgg_n_2_24`` cell runs at 2^24) the chooser keeps ELL, and
the attributes of ``formats.price.ell`` (`rowsize`, `slots`, `narrow`)
and ``formats.build.ell`` (those, `nonzeros`, `sliced` and
`padded_slots`) are the built ELL's."""

import numpy as np
import pytest

from ellspmv_tpu_torch.formats.auto import auto_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.models.generators import banded_random
from ellspmv_tpu_torch.utils import timing
from torch_cases import geometric_coo, random_coo


def _attrs(ell):
    return {"rowsize": ell.rowsize, "slots": ell.ellsize,
            "narrow": ell.lcol is not None}


def _build_attrs(ell):
    """The build span's attributes of `ell`: the price's, `nonzeros`,
    whether it is `sliced` and the padded layout's slots; `slots` the
    slices' where it is sliced."""
    attrs = {**_attrs(ell), "nonzeros": ell.num_nonzeros,
             "sliced": ell.slices is not None, "padded_slots": ell.ellsize}
    if ell.slices is not None:
        attrs["slots"] = ell.slices.stored
    return attrs


@pytest.fixture(scope="module")
def geometric():
    return geometric_coo(16)


def test_the_chooser_keeps_ell_on_a_geometric_graph(geometric):
    with timing.recording() as rec:
        ell = auto_from_coo(geometric, value_dtype="float64")
    assert ell._auto_choice == "ell"
    assert rec.find("formats.auto_from_coo")[0].attrs["choice"] == "ell"
    counts = np.bincount(geometric.rowidx, minlength=geometric.num_rows)
    assert ell.rowsize == counts.max()
    assert 2 * counts.mean() < ell.rowsize < 4 * counts.mean()
    assert ell.lcol is not None
    (price,) = rec.find("formats.price.ell")
    (build,) = rec.find("formats.build.ell")
    assert price.attrs == _attrs(ell)
    assert build.attrs == _build_attrs(ell)
    assert build.attrs["nonzeros"] == geometric.num_nonzeros
    assert build.attrs["slots"] == geometric.num_rows * counts.max()
    # the stream format is priced by its least bytes alone, not laid out
    assert not rec.find("formats.build.stream")


@pytest.mark.parametrize("case", ["geometric", "banded", "wide", "diagonal"])
def test_the_build_span_is_the_built_ells(case, geometric):
    """`ell_from_coo` alone: one build span, whose attributes are the
    ELL's, narrow or wide columns, with the diagonal split or not."""
    coo, kw = {
        "geometric": (geometric, {"sort_rows": True}),
        "banded": (banded_random(3000, 8, 500, seed=2), {}),
        "wide": (random_coo(np.random.RandomState(3), 3000, 200_000,
                            20_000), {}),
        "diagonal": (banded_random(3000, 8, 500, seed=4),
                     {"separate_diagonal": True}),
    }[case]
    with timing.recording() as rec:
        ell = ell_from_coo(coo, **kw)
    (build,) = rec.find("formats.build.ell")
    assert build.attrs == _build_attrs(ell)
    assert build.attrs["narrow"] is (case != "wide")


def test_the_price_span_says_wide_where_blocks_reach_far():
    """Rows whose columns reach 40,000 either side: a block of rows spans
    more than the narrow layout's 65,536 columns, and the price says wide,
    as the build does."""
    coo = banded_random(200_000, 8, 40_000, seed=5)
    with timing.recording() as rec:
        ell = auto_from_coo(coo, value_dtype="float64", allow_dia=False)
    assert ell._auto_choice == "ell" and ell.lcol is None
    (price,) = rec.find("formats.price.ell")
    (build,) = rec.find("formats.build.ell")
    assert price.attrs == _attrs(ell) == {
        k: build.attrs[k] for k in ("rowsize", "slots", "narrow")}


@pytest.mark.parametrize("case", ["geometric", "banded", "wide"])
def test_the_build_span_of_a_sliced_ell(case, geometric, monkeypatch):
    """The whole matrix sliced (as on a card; here by making the CPU take
    the layout): the span says `sliced`, its `slots` are the slices' and
    fewer than the padded layout's `padded_slots`, and `narrow` is the
    sliced layout's own."""
    from ellspmv_tpu_torch.formats import ell as ell_mod
    monkeypatch.setattr(ell_mod, "_slices_on", lambda device: True)
    coo = {"geometric": geometric,
           "banded": banded_random(3000, 8, 500, seed=2),
           "wide": random_coo(np.random.RandomState(3), 3000, 200_000,
                              20_000)}[case]
    with timing.recording() as rec:
        ell = ell_from_coo(coo)
    (build,) = rec.find("formats.build.ell")
    assert build.attrs == _build_attrs(ell)
    assert build.attrs["sliced"] is True
    assert build.attrs["slots"] < build.attrs["padded_slots"]
    assert build.attrs["narrow"] is (case != "wide")
