"""The port's benchmark suite (``bench/suite.py``) and the chooser's price of
K1's short launches (``bench/traffic.k1_launch_seconds``) on the CPU.

`run_suite` at a tiny scale (its `SIZES` cut down) prints every row of
``ellspmv_tpu/bench/suite.py`` but those of a card (the measured peak) and
of several devices (config4, which prints its skip line), with the JAX
rows' fields; each timed row's y holds the NumPy oracle through the
suite's check hook. The price term is held against a count by hand. The
suite on a card, at full scale, runs in ``chip_smoke.py``."""

import io
import json
import re

import numpy as np
import pytest
import torch

from ellspmv_tpu_torch import config
from ellspmv_tpu_torch.bench import suite
from ellspmv_tpu_torch.bench.stream import measure_peak_bandwidth
from ellspmv_tpu_torch.bench.traffic import (k1_launch_seconds, k1_rounds,
                                             sell_bytes, sell_seconds,
                                             stream_bytes_estimate,
                                             stream_seconds_estimate)
from ellspmv_tpu_torch.formats.sell import sell_from_coo
from ellspmv_tpu_torch.ops.dispatch import spmv
from torch_cases import assert_rows_close, random_coo

TINY = {"poisson": 16, "mesh_rows": 400, "banded": 2000, "power_law": 4000,
        "power_law_10x": 8000, "dense_rows": 4000}
# The timed rows' record fields and the other rows' keys, as the JAX suite
# writes them.
RECORD_FIELDS = ["config", "best_s", "gnz_per_s", "gflop_per_s",
                 "min_gb_per_s", "max_gb_per_s", "roofline_effective",
                 "actual_bytes", "actual_gb_per_s", "roofline_physical",
                 "note"]


def jax_row_patterns() -> list[str]:
    """Every row name of ``ellspmv_tpu/bench/suite.py`` as a regular
    expression (its f-strings' fields match anything), from its source."""
    with open("ellspmv_tpu/bench/suite.py") as f:
        src = f.read()
    names = re.findall(r'record\(\s*f?"([^"]+)"', src)
    names += re.findall(r'"config":\s*f?"([^"]+)"', src)
    return ["^" + re.sub(r"\\\{[^}]*\\\}", ".+", re.escape(name)) + "$"
            for name in names]


@pytest.fixture(scope="module", params=[True, False], ids=["quick", "full"])
def ran(request):
    # one thread: the chained protocol's many tiny launches run far faster
    # on one CPU thread than on a contended pool
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(suite, "SIZES", TINY)
    checked = []

    def check(name, coo, matrix, x):
        got = spmv(matrix, torch.from_numpy(x))       # every row is fp64
        assert_rows_close(got.double().numpy(), coo, x, None, "float64")
        checked.append(name)
    log = io.StringIO()
    try:
        rows = suite.run_suite(quick=request.param, stream=log,
                               device="cpu", check=check)
    finally:
        mp.undo()
        torch.set_num_threads(threads)
    return request.param, rows, log.getvalue(), checked


def test_every_jax_row_is_there(ran):
    quick, rows, log, _ = ran
    names = [r["config"] for r in rows]
    assert len(names) == len(set(names))
    for pattern in jax_row_patterns():
        card_only = pattern.startswith("^hbm")
        devices = pattern.startswith("^config4")
        tenfold = pattern.startswith("^config3\\-10x")
        present = [n for n in names if re.match(pattern, n)]
        if card_only or devices or (quick and tenfold):
            assert present == [], pattern
        else:
            assert len(present) == 1, pattern
    assert ("config4 skipped: multi-device is not yet ported (see "
            "ROADMAP.md)\n") in log
    assert len(names) == (13 if quick else 16)


def test_rows_carry_the_jax_fields(ran):
    _, rows, log, _ = ran
    for row in rows:
        if "best_s" in row:
            assert list(row) == RECORD_FIELDS
            # no card: no peak, so no roofline shares
            assert row["roofline_effective"] is None
            assert row["roofline_physical"] is None
            assert row["actual_bytes"] > 0 and row["best_s"] > 0
    golden = next(r for r in rows if r["config"] == "config0 golden")
    assert golden == {"config": "config0 golden", "pass": True}
    for row in rows:
        if row["config"].endswith("oracle"):
            assert list(row) == ["config", "normwise_err"]
            assert row["normwise_err"] < 1e-14
    hybrid = next(r for r in rows if "hub-hybrid" in r["config"])
    assert re.fullmatch(r"hub \d+%", hybrid["note"])
    chosen = next(r for r in rows if r["config"].startswith("headline"))
    assert chosen["note"].startswith("auto=")
    json.dumps(rows)


def test_every_timed_row_holds_the_oracle(ran):
    _, rows, _, checked = ran
    assert checked == [r["config"] for r in rows if "best_s" in r]


def test_the_program_needs_a_card_or_the_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert suite.main([]) == 1
    assert "no CUDA device is available" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        suite.main(["--device=tpu"])


def test_the_triad_needs_a_card():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        measure_peak_bandwidth(device="cpu")


# -- the chooser's price of K1's short launches (ROADMAP F8) -----------------

def test_k1_price_by_hand():
    rate, round_s, sms = 3.35e12, 1.67e-6, 132
    assert [k1_rounds(w) for w in (1, 4, 5, 8, 128, 129)] == \
        [1, 1, 2, 2, 32, 33]
    # 16,384 rows of 128: 32 blocks of 512 rows on 132 SMs, 32 rounds
    nbytes = 16_384 * 128 * 12
    assert k1_launch_seconds(16_384, 128, nbytes, rate, round_s, sms) == \
        32 * 1.67e-6
    # 1,007,616 rows of 8: 1,968 blocks fill the card, bytes alone
    nbytes = 1_007_616 * 8 * 10
    assert k1_launch_seconds(1_007_616, 8, nbytes, rate, round_s, sms) == \
        nbytes / rate
    # 67,072 rows (131 blocks) are short, 67,584 (132 blocks) are not
    assert k1_launch_seconds(67_072, 4, 100, rate, round_s, sms) == round_s
    assert k1_launch_seconds(67_584, 4, 100, rate, round_s, sms) == \
        100 / rate
    # bytes above the rounds win even on a short launch
    assert k1_launch_seconds(512, 4, 10 ** 9, rate, round_s, sms) == \
        10 ** 9 / rate


def test_sell_and_stream_prices_by_hand():
    rate, round_s, sms = 3.35e12, 1.67e-6, 132
    coo = random_coo(np.random.RandomState(50), 3000, 3000, 20_000)
    sm = sell_from_coo(coo, slice_rows=1024, length_sort=True,
                       value_dtype="float64")
    want = sell_bytes(sm, with_y=False) / rate
    for b in sm.buckets:          # every bucket here is a short launch
        assert -(-b.num_rows // 512) < sms
        k1 = b.rowsize * b.padded_rows * 8 + b.index_bytes + b.num_rows * 8
        want += max(k1 / rate, k1_rounds(b.rowsize) * round_s) - k1 / rate
    assert sell_seconds(sm, rate, round_s, sms) == pytest.approx(want,
                                                                 rel=1e-12)
    assert sell_seconds(sm, rate, 0.0, sms) == pytest.approx(
        sell_bytes(sm, with_y=False) / rate, rel=1e-12)
    # the stream's K1 is one slot a row over the padded products: 16,384
    # slots (32 blocks, short) take one round at least
    nnz = 10_000
    got = stream_seconds_estimate(nnz, 3000, 3000, 8, True, rate, round_s,
                                  sms)
    k1 = 2 * 16_384 * 8 + 2 * 16_384 + 4 * 64
    rest = stream_bytes_estimate(nnz, 3000, 3000, 8, True) - k1
    assert got == pytest.approx(rest / rate + max(k1 / rate, round_s),
                                rel=1e-12)


def test_geometry_of_the_host_priced_card():
    """Off a card the chooser prices for the card the constant was
    measured on; ``HBM_PEAK_GBPS`` overrides the rate."""
    assert config.k1_geometry("cpu") == (
        config.K1_ROUND_SECONDS[config.HOST_PRICED_CARD],
        config.SM_COUNT[config.HOST_PRICED_CARD])
    assert config.k1_geometry("cpu")[0] > 0
    assert config.pricing_rate("cpu") == \
        config.HBM_PEAK_BYTES_PER_S[config.HOST_PRICED_CARD]
