"""The port's kernels on a card, held against their plain PyTorch versions
(and, where the plain version is exact, bit for bit): the ``cuda`` tests.

This file imports neither jax nor the JAX package and uses no fixture of
``tests/conftest.py``, so that it runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_card.py tests/test_torch_imports.py -q -rA

(``chip_smoke.py`` runs that on the card). Every input comes from a numpy
seed (``tests/torch_cases.py``). Off a card each test skips, and a skip is
no pass. Tolerances, per row relative to sum |a*x| + |y| (or the vectors'
sum |x*y| for the dot): fp64 1e-13, f32 1e-5, bf16 1e-2. The loops
captured in CUDA graphs (the chained protocol's blocks, CG) are held
against the same loops launched eagerly, bit for bit."""

import ctypes
import dataclasses
import math
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from ellspmv_tpu_torch.bench.harness import (CHAINED_BLOCK, _block_loop,
                                             _eager_loop)
from ellspmv_tpu_torch.formats.csr import csr_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.formats.hybrid import (hybrid_from_coo, hybrid_spmv,
                                              kernel_launches)
from ellspmv_tpu_torch.formats.sell import kernel_launches as sell_launches
from ellspmv_tpu_torch.formats.sell import sell_from_coo, sell_spmv
from ellspmv_tpu_torch.formats.stream import column_order_products, stream_spmv
from ellspmv_tpu_torch.models.generators import (banded_random, fem_mesh_2d,
                                                 hpcg_27pt, power_law)
from ellspmv_tpu_torch.models.solvers import STEPS_AHEAD, cg, cg_eager
from ellspmv_tpu_torch.ops import (_build, dia_cuda, dot_cuda, ell_cuda,
                                   permute, stream_sum)
from ellspmv_tpu_torch.ops.csr import csr_spmv, csr_spmv_segment, to_sell
from ellspmv_tpu_torch.ops.dispatch import traceable_spmv
from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv
from ellspmv_tpu_torch.parallel.launch import kernel_launches as launch_counts
from torch_cases import (CSR_CASES, PLAN_CASES, PRODUCT_CASES,
                               SELL_CASES, SPMV_CASES, TRACEABLE_CASES,
                               assert_deep_equal, assert_rows_close,
                               dest_chunked, diagonal_coo,
                               gather_pipeline_spmv,
                               general_targets, geometric_coo, random_coo,
                               random_products, rng_coo, spmv_inputs,
                               traceable_case)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")


# -- the toolchain ----------------------------------------------------------

TRIVIAL_KERNEL = r"""
#include <cuda_runtime.h>
__global__ void add_one(int* p, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) p[i] += 1;
}
extern "C" int add_one_launch(void* p, int n) {
  add_one<<<(n + 127) / 128, 128>>>(static_cast<int*>(p), n);
  return static_cast<int>(cudaDeviceSynchronize());
}
"""


@pytest.mark.cuda
def test_toolchain_builds_and_launches_a_trivial_kernel(tmp_path):
    """`ops/_build.build` compiles a source of its own directory with the
    port's nvcc flags for sm_90a, links it, and the library launches."""
    _needs_card()
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "add_one.cu").write_text(TRIVIAL_KERNEL)
    lib = ctypes.CDLL(str(_build.build(csrc, tmp_path / "build")))
    lib.add_one_launch.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.add_one_launch.restype = ctypes.c_int
    p = torch.arange(1000, dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    assert lib.add_one_launch(p.data_ptr(), 1000) == 0
    assert torch.equal(p.cpu(), torch.arange(1, 1001, dtype=torch.int32))


# -- K1: the ELL kernel -----------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["narrow", "wide"])
def test_narrow_kernel_matches_plain_on_card(layout):
    _needs_card()
    ell = ell_from_coo(banded_random(5000, 9, 64), device="cuda")
    assert ell.lcol is not None
    if layout == "wide":
        ell = dataclasses.replace(ell, lbase=None, lcol=None)
    x = torch.from_numpy(np.random.RandomState(0).rand(5000)).cuda()
    got = ell_cuda.ell_spmv(ell, x)
    torch.cuda.synchronize()
    want = ell_cuda.ell_spmv_torch(ell, x)
    torch.testing.assert_close(got, want, rtol=1e-13,
                               atol=1e-13 * float(want.abs().max()))


@pytest.mark.cuda
def test_k1_on_a_geometric_graph_on_card():
    """K1 on DIMACS10's random geometric graph numbered by grid cell, as
    the chooser sends it to ELLPACK: rows of about Poisson lengths padded
    to the longest, narrow columns, one row emptied."""
    _needs_card()
    coo = geometric_coo(14, empty_row=100)
    counts = np.bincount(coo.rowidx, minlength=coo.num_rows)
    ell = ell_from_coo(coo, sort_rows=True, device="cuda")
    assert ell.lcol is not None and counts[100] == 0
    assert ell.rowsize == counts.max() > 2 * counts.mean()
    rng = np.random.RandomState(14)
    x, y = rng.rand(coo.num_rows), rng.randn(coo.num_rows)
    xd, yd = torch.from_numpy(x).cuda(), torch.from_numpy(y).cuda()
    before = ell_cuda.launches
    got = ell_spmv(ell, xd, yd)
    torch.cuda.synchronize()
    assert ell_cuda.launches == before + 1
    assert float(got[100]) == y[100]
    want = ell_cuda.ell_spmv_torch(ell, xd, yd)
    assert_rows_close(got.cpu().numpy(), coo, x, y, "float64",
                      want=want.cpu().numpy())
    assert_rows_close(got.cpu().numpy(), coo, x, y, "float64")


# -- K1 on the sliced layout ------------------------------------------------

def _npb_coo(params):
    """NPB CG's matrix of the class `params` names, made on the card by the
    benchmark's generator, as a host COO."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from spmv_bench.generators import npb_cg

    from ellspmv_tpu_torch.formats.coo import CooMatrix
    m = npb_cg.generate(params, 1, "cuda")
    return CooMatrix(m.num_rows, m.num_rows, m.rows.int().cpu().numpy(),
                     m.cols.int().cpu().numpy(), m.values.cpu().numpy())


def _every_third_row_empty(coo):
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    keep = coo.rowidx % 3 != 0
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx[keep],
                     coo.colidx[keep], coo.values[keep])


#: NPB CG's class W (npbparams.h).
NPB_CLASS_W = dict(na=7000, nonzer=8, rcond=0.1, shift=12.0, niter=15)

#: name -> (COO factory, ell_from_coo keywords, narrow columns): matrices
#: whose rows differ in length, so that the card's whole-matrix ELL is
#: sliced
SLICED_CASES = {
    "rgg_2^16": (lambda: geometric_coo(16, empty_row=100),
                 {"sort_rows": True}, True),
    "npb_class_w": (lambda: _npb_coo(NPB_CLASS_W), {}, True),
    "power_law": (SPMV_CASES["power_law"][0], {}, True),
    "empty_rows": (lambda: _every_third_row_empty(rng_coo(2000, 1800,
                                                          15_000)()),
                   {}, True),
    "odd_rows_diagonal": (rng_coo(1533, 1533, 9000),
                          {"separate_diagonal": True}, True),
    "wide_4_byte": (rng_coo(2100, 300_000, 20_000), {}, False),
    "int64": (rng_coo(777, 700, 5000), {"index_dtype": "int64"}, True),
    "f32": (rng_coo(1100, 1000, 7000), {"value_dtype": "float32"}, True),
    "bf16": (rng_coo(900, 900, 6000), {"value_dtype": "bfloat16"}, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLICED_CASES))
def test_sliced_k1_equals_padded_k1_on_card(name):
    """K1 on the sliced layout `ell_from_coo` builds on the card against
    K1 on the same rows in the padded layout (built on the host, moved to
    the card): y bit for bit, with and without y, in place, and within the
    tolerance of the oracle; each sliced launch counted."""
    _needs_card()
    make, kw, narrow = SLICED_CASES[name]
    coo = make()
    sliced = ell_from_coo(coo, device="cuda", **kw)
    padded = ell_from_coo(coo, **kw).to("cuda")
    assert sliced.slices is not None and padded.slices is None
    assert (sliced.lcol is not None) is narrow
    assert sliced.slices.stored < padded.values.numel()
    precision = kw.get("value_dtype", "float64")
    dt = sliced.values.dtype
    rng = np.random.RandomState(21)
    x64, y64 = rng.rand(coo.num_columns), rng.randn(coo.num_rows)
    x = torch.from_numpy(x64).cuda().to(dt)
    for y in (None, torch.from_numpy(y64).cuda().to(dt)):
        before = ell_cuda.launches, ell_cuda.sliced_launches
        got = ell_spmv(sliced, x, y)
        want = ell_spmv(padded, x, y)
        torch.cuda.synchronize()
        assert (ell_cuda.launches, ell_cuda.sliced_launches) == (
            before[0] + 2, before[1] + 1)
        assert torch.equal(got, want)
        assert_rows_close(got.double().cpu().numpy(), coo,
                          x.double().cpu().numpy(),
                          None if y is None else y.double().cpu().numpy(),
                          precision)
    # in place: y_out is y_in
    y = torch.from_numpy(y64).cuda().to(dt)
    want = ell_spmv(padded, x, y)
    symbol, args, _ = ell_cuda.kernel_call(sliced, x, y)
    args = (*args[:9], y.data_ptr(), *args[10:])
    fn, _ = _build.entry(symbol, ell_cuda.SPMV_ARGTYPES)
    assert fn(*args) == 0
    torch.cuda.synchronize()
    assert torch.equal(y, want)


@pytest.mark.cuda
def test_sliced_launches_through_graph_replays_on_card():
    """A CUDA graph of K1 on a sliced matrix counts its replays in
    `sliced_launches`; on a padded one (equal rows) it does not."""
    _needs_card()
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.utils.graphs import Graph
    sliced = ell_from_coo(geometric_coo(12), device="cuda")
    n, k = 4096, 7       # a circulant: every row holds k entries
    rows = np.repeat(np.arange(n), k)
    cols = (rows + np.tile(np.arange(k) * 97, n)) % n
    equal = ell_from_coo(CooMatrix(n, n, rows.astype(np.int32),
                                   cols.astype(np.int32), np.ones(n * k)),
                         device="cuda")
    assert sliced.slices is not None and equal.slices is None
    for mat, counted in ((sliced, 1), (equal, 0)):
        x = torch.ones(mat.num_columns, dtype=torch.float64, device="cuda")
        with Graph(lambda: ell_spmv(mat, x), "cuda") as graph:
            before = ell_cuda.launches, ell_cuda.sliced_launches
            for _ in range(3):
                graph.replay()
            torch.cuda.synchronize()
            assert (ell_cuda.launches, ell_cuda.sliced_launches) == (
                before[0] + 3, before[1] + 3 * counted)


@pytest.mark.cuda
def test_plain_version_on_the_sliced_layout_in_a_graph_on_card():
    """The plain version lays a sliced matrix back into the padded layout
    on the card without a host read, so a CUDA graph captures it (as the
    plain version's CG does); its replay equals the eager call bit for
    bit, and K1 within the tolerance."""
    _needs_card()
    from ellspmv_tpu_torch.utils.graphs import Graph
    sliced = ell_from_coo(geometric_coo(12, empty_row=7), device="cuda")
    assert sliced.slices is not None
    x = torch.from_numpy(np.random.RandomState(9).rand(
        sliced.num_columns)).cuda()
    want = ell_cuda.ell_spmv_torch(sliced, x)
    out = torch.empty_like(want)
    with Graph(lambda: out.copy_(ell_cuda.ell_spmv_torch(sliced, x)),
               "cuda") as graph:
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
    assert torch.equal(out, want)
    torch.testing.assert_close(ell_spmv(sliced, x), want, rtol=1e-13,
                               atol=1e-13 * float(want.abs().max()))


# -- K2: the DIA kernel's symmetric form ------------------------------------

DIA_SYMMETRIC_CASES = {"fem_mesh_2d(40)": lambda: fem_mesh_2d(40),
                       "hpcg_27pt(32^3)": lambda: hpcg_27pt(32),
                       "hpcg_27pt(13x7x9)": lambda: hpcg_27pt(13, 7, 9)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(DIA_SYMMETRIC_CASES))
def test_dia_symmetric_form_equals_general_form_on_card(name, precision):
    """K2 on a symmetric DIA, which reads only the offsets >= 0, against K2
    on the same matrix with the mark cleared: y bit for bit, with and
    without y, and within the tolerance of the oracle; each launch counted
    in its form."""
    _needs_card()
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    coo = DIA_SYMMETRIC_CASES[name]()
    sym = dia_from_coo(coo, value_dtype=precision, device="cuda")
    assert sym.symmetric
    general = dataclasses.replace(sym, symmetric=False)
    rng = np.random.RandomState(5)
    x64, y64 = rng.rand(coo.num_columns), rng.randn(coo.num_rows)
    x = torch.from_numpy(x64).cuda().to(sym.data.dtype)
    for y in (None, torch.from_numpy(y64).cuda().to(sym.data.dtype)):
        before = dia_cuda.launches, dia_cuda.symmetric_launches
        got = dia_cuda.dia_spmv(sym, x, y)
        want = dia_cuda.dia_spmv(general, x, y)
        torch.cuda.synchronize()
        assert (dia_cuda.launches, dia_cuda.symmetric_launches) == (
            before[0] + 2, before[1] + 1)
        assert torch.equal(got, want)
        assert_rows_close(got.double().cpu().numpy(), coo,
                          x.double().cpu().numpy(),
                          None if y is None else y.double().cpu().numpy(),
                          precision)


@pytest.mark.cuda
def test_dia_symmetric_launches_only_on_symmetric_data_on_card():
    """No symmetric launch on a DIA of random diagonals, its offsets a ±d
    set or not; on a symmetric one, a CUDA graph's replays count theirs."""
    _needs_card()
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.utils.graphs import Graph
    for offsets in ([-300, -129, -7, 0, 5, 127, 128, 301], [-7, 0, 7]):
        dia = dia_from_coo(diagonal_coo(700, 700, offsets, 4), device="cuda")
        assert not dia.symmetric
        x = torch.ones(700, dtype=torch.float64, device="cuda")
        before = dia_cuda.launches, dia_cuda.symmetric_launches
        dia_cuda.dia_spmv(dia, x)
        assert (dia_cuda.launches, dia_cuda.symmetric_launches) == (
            before[0] + 1, before[1])
    sym = dia_from_coo(fem_mesh_2d(40), device="cuda")
    x = torch.ones(sym.num_rows, dtype=torch.float64, device="cuda")
    with Graph(lambda: dia_cuda.dia_spmv(sym, x), "cuda") as graph:
        before = dia_cuda.launches, dia_cuda.symmetric_launches
        for _ in range(3):
            graph.replay()
        torch.cuda.synchronize()
        assert (dia_cuda.launches, dia_cuda.symmetric_launches) == (
            before[0] + 3, before[1] + 3)


# -- K6: the dot kernel -----------------------------------------------------

@pytest.mark.cuda
def test_dot_kernel_matches_plain_on_card():
    _needs_card()
    for n in (1, 1023, 1024, 1025, 262_144):
        rng = np.random.RandomState(n)
        x, y = (torch.from_numpy(v).cuda() for v in (rng.randn(n),
                                                     rng.randn(n)))
        before = dot_cuda.launches
        got, again = dot_cuda.vdot(x, y), dot_cuda.vdot(x, y)
        torch.cuda.synchronize()
        assert dot_cuda.launches == before + 2
        assert torch.equal(got, again)
        want = math.fsum((x * y).cpu().numpy())
        scale = float((x * y).abs().sum())
        assert abs(float(got) - want) <= 1e-14 * scale
        assert abs(float(got) - float(dot_cuda.vdot_torch(x, y))) \
            <= 2e-14 * scale


# -- CSR and SELL on K1 -----------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CSR_CASES))
def test_csr_spmv_on_card(name):
    _needs_card()
    make, kw = CSR_CASES[name]
    coo = make()
    csr = csr_from_coo(coo, **kw)
    precision = kw.get("value_dtype", "float64")
    x = np.random.RandomState(13).rand(coo.num_columns)
    y = np.random.RandomState(14).randn(coo.num_rows)
    dt = csr.values.dtype
    card = csr.to("cuda")
    before = ell_cuda.launches
    got = csr_spmv(card, torch.from_numpy(x).to("cuda", dt),
                   torch.from_numpy(y).to("cuda", dt))
    torch.cuda.synchronize()
    assert ell_cuda.launches == before + len(to_sell(card).buckets)
    assert_rows_close(got.double().cpu().numpy(), coo, x, y, precision)
    seg = csr_spmv_segment(card, torch.from_numpy(x).to("cuda", dt))
    assert_rows_close(seg.double().cpu().numpy(), coo, x, None, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SELL_CASES))
def test_sell_spmv_on_card(name):
    _needs_card()
    make, kw = SELL_CASES[name]
    coo = make()
    sm = sell_from_coo(coo, **kw)
    precision = kw.get("value_dtype", "float64")
    x = np.random.RandomState(37).rand(coo.num_columns)
    y = np.random.RandomState(38).randn(coo.num_rows)
    card = sm.to("cuda")
    dt = sm.values.dtype
    before = ell_cuda.launches
    got = sell_spmv(card, torch.from_numpy(x).to("cuda", dt),
                    torch.from_numpy(y).to("cuda", dt))
    torch.cuda.synchronize()
    assert ell_cuda.launches == before + sell_launches(card)
    assert_rows_close(got.double().cpu().numpy(), coo, x, y, precision)
    plain = sell_spmv(sm, torch.from_numpy(x).to(dt),
                      torch.from_numpy(y).to(dt))
    assert_rows_close(got.double().cpu().numpy(), coo, x, y, precision,
                      plain.double().numpy())


# -- the hybrid: the gather (K4's counterpart), then K1 per bucket -----------

HYBRID_CASES = {
    "hub": (lambda: power_law(4000, 8, seed=1), dict(hub_width=512,
                                                     slice_rows=256,
                                                     tail_cap=16)),
    "no_hub": (lambda: random_coo(np.random.RandomState(41), 2000, 2000,
                                  8000), dict(hub_width=128)),
    "split": (lambda: power_law(3000, 8, seed=2), dict(hub_width=256)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "float32", "bfloat16"])
@pytest.mark.parametrize("name", sorted(HYBRID_CASES))
def test_hybrid_spmv_on_card(name, precision):
    _needs_card()
    make, kw = HYBRID_CASES[name]
    coo = make()
    hm = hybrid_from_coo(coo, value_dtype=precision, **kw)
    dt = hm.values.dtype
    x = torch.from_numpy(np.random.RandomState(42).rand(
        coo.num_columns)).to(dt)
    y = torch.from_numpy(np.random.RandomState(43).randn(
        coo.num_rows)).to(dt)
    card = hm.to("cuda")
    before = (ell_cuda.launches, permute.launches)
    got = hybrid_spmv(card, x.cuda(), y.cuda())
    torch.cuda.synchronize()
    want = kernel_launches(card)
    assert (ell_cuda.launches - before[0], permute.launches - before[1]) \
        == (want["ell_spmv"], want["permute"])
    plain = hybrid_spmv(hm, x, y)
    assert_rows_close(got.double().cpu().numpy(), coo, x.double().numpy(),
                      y.double().numpy(), precision)
    assert_rows_close(got.double().cpu().numpy(), coo, x.double().numpy(),
                      y.double().numpy(), precision, plain.double().numpy())


# -- K3 and the gather (K4/K5): the stream format ----------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", PRODUCT_CASES)
def test_position_order_products_on_card(case):
    _needs_card()
    coo, sm, kw, precision, x, _ = spmv_inputs(case, "cuda")
    x = x.to(sm.values.dtype)
    src = torch.from_numpy(stream_sum.position_map(
        sm.ddsum.levels[0])).cuda()
    col = column_order_products(coo, kw.get("separate_diagonal", False),
                                precision)
    want = permute.apply_permute(src, ell_spmv(col.to("cuda"), x))
    got = ell_spmv(sm.prod, x)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_sums_through_a_map_on_card(case):
    _needs_card()
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap,
                                       chunk_starts=starts).to("cuda")
    rng = np.random.RandomState(27)
    for dtype in (torch.float64, torch.float32):
        buffer = torch.from_numpy(rng.randn(plan.buffer_len)).to(
            "cuda", dtype)
        for i, lv in enumerate(plan.levels):
            if i == 0:
                src = torch.from_numpy(stream_sum.position_map(lv)).cuda()
                stream = torch.from_numpy(rng.randn(lv.in_len)).to(
                    "cuda", dtype)
            else:
                src, stream = lv.src, buffer
            before = stream_sum.src_launches
            got = stream_sum.stream_sum(lv.table, stream, src)
            want = stream_sum.stream_sum(lv.table,
                                         permute.apply_permute(src, stream))
            torch.cuda.synchronize()
            assert stream_sum.src_launches == before + 1
            assert torch.equal(got, want)
            assert torch.equal(got, stream_sum.stream_sum_torch(
                lv.table, stream, src))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_stream_spmv_bit_equal_on_card(case):
    """One `stream_spmv`: K3 as products on level 1, through its map on
    each deeper level, one gather, and no K1 nor K3 in place; bit for bit
    K1 followed by K3 in place, and the pipeline that gathered every level
    first."""
    _needs_card()
    coo, sm, kw, precision, x, y = spmv_inputs(case, "cuda")
    counters = ("ell_spmv", "stream_sum", "stream_sum_prod",
                "stream_sum_src", "permute")
    before = launch_counts()
    got = stream_spmv(sm, x, y)
    torch.cuda.synchronize()
    after = launch_counts()
    deeper = len(sm.ddsum.levels) - 1
    assert {k: after[k] - before[k] for k in counters} == {
        "ell_spmv": 0, "stream_sum": 0, "stream_sum_prod": 1,
        "stream_sum_src": deeper, "permute": 1}
    want = gather_pipeline_spmv(coo, sm, kw, precision, x, y, "cuda",
                                 k1=ell_spmv, gather=permute.apply_permute,
                                 sums=stream_sum.stream_sum)
    assert torch.equal(got, want)
    xd = x.to(sm.values.dtype)
    two_launches = stream_sum.apply_stream_sum(sm.ddsum,
                                               ell_spmv(sm.prod, xd))
    assert torch.equal(stream_sum.apply_stream_sum(
        sm.ddsum, stream_sum.Products(sm.prod, xd)), two_launches)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stream_sum_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dest, n, cap, starts = dest_chunked(3)()
    plan = stream_sum.build_stream_sum(dest, n, chunk_starts=starts)
    lv = plan.levels[0].to("cuda")
    stream = torch.from_numpy(np.random.RandomState(20).randn(
        lv.in_rows * 128)).to("cuda", dtype)
    before = stream_sum.launches
    got = stream_sum.stream_sum(lv.table, stream)
    torch.cuda.synchronize()
    assert stream_sum.launches == before + 1
    assert torch.equal(got, stream_sum.stream_sum_torch(lv.table, stream))


@pytest.mark.cuda
@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_stream_sum_products_kernel_matches_plain_on_card(dtype, narrow):
    """K3 reading level 1 as products (`stream_sum_prod_*`) on a chunked
    plan, in narrow and int32 columns: bit for bit its plain version and K1
    followed by K3 in place, with NaNs in the gaps' values, never read."""
    _needs_card()
    dest, n, cap, starts = dest_chunked(3)()
    plan = stream_sum.build_stream_sum(dest, n, chunk_starts=starts)
    table = plan.levels[0].table.to("cuda")
    prod = random_products(plan, dtype, narrow, gap_value=np.nan,
                           device="cuda")
    before = (stream_sum.product_launches, stream_sum.launches)
    got = stream_sum.stream_sum(table, prod)
    torch.cuda.synchronize()
    assert (stream_sum.product_launches, stream_sum.launches) == (
        before[0] + 1, before[1])
    assert torch.equal(got, stream_sum.stream_sum_torch(table, prod))
    assert torch.equal(got, stream_sum.stream_sum(
        table, ell_spmv(prod.ell, prod.x)))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_stream_sum_kernel_on_every_plan_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap,
                                       chunk_starts=starts).to("cuda")
    for lv in plan.levels:
        stream = torch.from_numpy(np.random.RandomState(25).randn(
            lv.in_rows * 128)).cuda()
        got = stream_sum.stream_sum(lv.table, stream)
        torch.cuda.synchronize()
        assert torch.equal(got, stream_sum.stream_sum_torch(lv.table,
                                                            stream))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
def test_permute_kernel_matches_plain_on_card(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    target, n_out = general_targets()
    src = torch.from_numpy(permute.gather_from_targets(target, n_out))
    src = src.to("cuda")
    payload = torch.from_numpy(np.random.RandomState(21).randn(
        len(target))).to("cuda", dtype)
    before = permute.launches
    got = permute.apply_permute(src, payload)
    torch.cuda.synchronize()
    assert permute.launches == before + 1
    assert torch.equal(got, permute.apply_permute_torch(src, payload))


# -- the native host path (``io/native.py``) ---------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_native_read_and_pack_on_card(precision, tmp_path, monkeypatch):
    """A file written and read by the native library, then packed natively
    on the card, equals the NumPy reader's and packer's bit for bit, and K1
    computes the same y from both."""
    _needs_card()
    from ellspmv_tpu_torch.io import mtx, native
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d
    assert native.available()
    coo = fem_mesh_2d(300, 300, extras=5, seed=1)   # 90,000 rows: threads
    path = str(tmp_path / "mesh.mtx")
    native.write_coo(path, coo.num_rows, coo.num_columns, coo.rowidx,
                     coo.colidx, coo.values)
    read = mtx.read_matrix(path, use_native=True)
    assert_deep_equal(read, mtx.read_matrix(path, use_native=False), "coo")
    assert_deep_equal(read, coo, "coo")
    got = ell_from_coo(read, sort_rows=True, value_dtype=precision,
                       device="cuda")
    monkeypatch.setattr(native, "available", lambda: False)
    want = ell_from_coo(read, sort_rows=True, value_dtype=precision,
                        device="cuda")
    assert_deep_equal(got, want, "ell")
    x = torch.from_numpy(np.random.RandomState(40).rand(
        coo.num_columns)).cuda().to(got.values.dtype)
    assert torch.equal(ell_spmv(got, x), ell_spmv(want, x))


@pytest.mark.cuda
def test_native_stream_plan_on_card(monkeypatch):
    """The stream format built on the card with the native argsort equals
    the one built with NumPy's, and so does its y."""
    _needs_card()
    from ellspmv_tpu_torch.formats.stream import stream_from_coo
    from ellspmv_tpu_torch.io import native
    coo = power_law(30_000, 6, seed=2)
    got = stream_from_coo(coo, device="cuda")
    monkeypatch.setattr(native, "available", lambda: False)
    want = stream_from_coo(coo, device="cuda")
    assert_deep_equal(got, want, "stream")
    x = torch.from_numpy(np.random.RandomState(41).rand(
        coo.num_columns)).cuda()
    assert torch.equal(stream_spmv(got, x), stream_spmv(want, x))


# -- the calibration (``bench/calibrate.py``) ---------------------------------

@pytest.mark.cuda
def test_calibrate_saves_what_the_pricing_reads(tmp_path, monkeypatch):
    """``python -m ellspmv_tpu_torch.bench.calibrate``'s `main` measures the
    card, caches its values under the card's name, and the chooser's
    pricing then reads them: K1's round latency fp64 and f32."""
    _needs_card()
    from ellspmv_tpu_torch import config
    from ellspmv_tpu_torch.bench import calibrate
    from ellspmv_tpu_torch.utils import calibration
    monkeypatch.setattr(calibration, "CACHE_PATH", tmp_path / "calib.json")
    calibrate.inject(None)
    assert calibrate.main([]) == 0
    card = torch.cuda.get_device_name(0)
    saved = calibration.load()[card]
    assert set(saved) == {*calibrate.K1_ROUND.values(), calibrate.RATE}
    assert config.k1_geometry("cuda")[0] == \
        saved[calibrate.K1_ROUND["float64"]]
    assert config.k1_geometry("cuda", torch.float32)[0] == \
        saved[calibrate.K1_ROUND["float32"]]
    assert config.pricing_rate("cuda") == config.HBM_PEAK_BYTES_PER_S.get(
        card, saved[calibrate.RATE])


# -- over ranks sharing the card (``parallel/``) ------------------------------

@pytest.fixture(scope="module", params=[1, 2, 4],
                ids=["nccl1", "gloo2", "gloo4"])
def card_pool(request):
    """Ranks on the one card: one over NCCL, or two or four sharing it over
    gloo (NCCL refuses two ranks on one card)."""
    _needs_card()
    from ellspmv_tpu_torch.parallel.launch import RankPool
    with RankPool(["cuda:0"] * request.param, timeout=300) as pool:
        yield pool


SHARDED_CASES = ["ell", "ell_diag", "ell_f32", "csr", "csr_diag",
                 "csr_nonzeros", "stream", "stream_diag"]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SHARDED_CASES)
def test_sharded_spmv_on_card(card_pool, case):
    """The sharded y against the one-device y on the card: ELL and CSR bit
    for bit, the stream format (each rank its own plan) against the oracle
    per row; K1 (for the stream, K3 as products and the gather) launched
    on every rank."""
    from ellspmv_tpu_torch.ops.dispatch import spmv
    from ellspmv_tpu_torch.parallel.spmv import run_spmv, shard_matrix
    from ellspmv_tpu_torch.parallel.stream import shard_stream
    rng = np.random.RandomState(31)
    fmt, _, variant = case.partition("_")
    precision = "float32" if variant == "f32" else "float64"
    diag = variant == "diag"
    if fmt == "stream":
        coo = power_law(20_000, 6, seed=3)
    else:
        coo = banded_random(30_000, 9, 700, seed=4)
    x = rng.randn(coo.num_columns)
    y = rng.randn(coo.num_rows)
    launches = []
    if fmt == "stream":
        sm = shard_stream(coo, card_pool.world, value_dtype=precision,
                          separate_diagonal=diag)
        got = run_spmv(card_pool, sm, torch.from_numpy(x),
                       torch.from_numpy(y), launches=launches)
        assert_rows_close(got.double().numpy(), coo, x, y, precision)
        assert all(c["stream_sum_prod"] >= 1 and c["permute"] >= 1
                   for c in launches)
    else:
        conv = ell_from_coo if fmt == "ell" else csr_from_coo
        mat = conv(coo, separate_diagonal=diag, value_dtype=precision)
        dt = mat.values.dtype
        xt, yt = torch.from_numpy(x).to(dt), torch.from_numpy(y).to(dt)
        partition = "nonzeros" if variant == "nonzeros" else "rows"
        sm = shard_matrix(mat, card_pool.world, partition=partition)
        got = run_spmv(card_pool, sm, xt, yt, launches=launches)
        want = spmv(mat.to("cuda"), xt.cuda(), yt.cuda()).cpu()
        assert torch.equal(got, want)
        assert all(c["ell_spmv"] >= 1 for c in launches)


@pytest.mark.cuda
def test_collectives_take_card_tensors(card_pool):
    """The allgather and the all_reduce on CUDA tensors, over NCCL and over
    gloo."""
    from ellspmv_tpu_torch.parallel.spmv import collectives_task
    out = card_pool.run(collectives_task, [(1000, 3)] * card_pool.world)
    world = card_pool.world
    assert out == [{"gathered": True,
                    "reduced": float(world * (world - 1) // 2)}] * world


# -- over ranks, captured: the sharded traceable form --------------------------

def _sharded_case(fmt, world, precision="float64"):
    """fem_mesh_2d(64) (4,096 rows) cut for `world` ranks as a sorted-row
    ELL, a CSR or the stream format; the whole matrix (None for the
    stream format, whose shards each plan their own rows) and a seeded
    x."""
    from ellspmv_tpu_torch.parallel.spmv import shard_matrix
    from ellspmv_tpu_torch.parallel.stream import shard_stream
    coo = fem_mesh_2d(64)
    x = torch.from_numpy(np.random.RandomState(23).rand(coo.num_rows))
    if fmt == "stream":
        return shard_stream(coo, world, value_dtype=precision), None, x
    conv = ell_from_coo if fmt == "ell" else csr_from_coo
    mat = conv(coo, sort_rows=True, value_dtype=precision)
    return shard_matrix(mat, world), mat, x.to(mat.values.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["ell", "csr", "stream"])
def test_captured_chained_over_ranks_on_card(card_pool, fmt):
    """Two blocks and five single iterations of the chained recurrence
    over the ranks: the loop through ``sharded_spmv_fn`` (replays of CUDA
    graphs that hold the allgather over NCCL; launched eagerly on gloo
    ranks sharing the card) against the loop launched eagerly, bit for
    bit, and for ELL and CSR against the one-device captured loop; K1 (K3
    as products for the stream) counted through the replays on every
    rank."""
    from ellspmv_tpu_torch.bench.harness import run_chained
    sm, mat, x = _sharded_case(fmt, card_pool.world)
    iters = 2 * CHAINED_BLOCK + 5
    launches = []
    got = run_chained(card_pool, sm, x, iters, launches=launches)
    assert torch.equal(got, run_chained(card_pool, sm, x, iters, eager=True))
    kernel = "ell_spmv" if mat is not None else "stream_sum_prod"
    assert all(c[kernel] >= iters for c in launches)
    if mat is not None:
        operand, fn = traceable_spmv(mat.to("cuda"))
        xc = x.cuda()
        with _block_loop(fn, operand, xc, torch.zeros_like(xc)) as (start,
                                                                     run):
            start()
            assert torch.equal(got, run(iters).cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_captured_cg_over_ranks_on_card(card_pool, precision):
    """``cg_sharded`` (its masked step captured with the allgather and the
    all_reduces over NCCL; ``cg_eager`` on gloo ranks sharing the card)
    against ``cg_eager`` over the same ranks: the same iterations, x and
    residual bit for bit; every rank the same iterations and steps, over
    NCCL exactly STEPS_AHEAD masked; `maxiter` honoured."""
    from ellspmv_tpu_torch.parallel.solver import solve_sharded
    sm, mat, _ = _sharded_case("ell", card_pool.world, precision)
    b = torch.from_numpy(np.random.RandomState(8).rand(sm.num_rows)).to(
        mat.values.dtype)
    tol = 1e-8 if precision == "float64" else 1e-4
    got = solve_sharded(card_pool, sm, b, tol=tol)
    want = solve_sharded(card_pool, sm, b, tol=tol, eager=True)
    assert got["iterations"] == want["iterations"] > STEPS_AHEAD
    assert np.array_equal(got["x"], want["x"])
    assert got["residual_norm"] == want["residual_norm"]
    masked = STEPS_AHEAD if card_pool.backend == "nccl" else 0
    assert got["rank_steps"] == [(got["iterations"],
                                  got["iterations"] + masked)] * sm.world
    assert all(c["ell_spmv"] >= got["steps"] for c in got["launches"])
    for maxiter in (1, want["iterations"] - 1):
        got = solve_sharded(card_pool, sm, b, tol=tol, maxiter=maxiter)
        want = solve_sharded(card_pool, sm, b, tol=tol, maxiter=maxiter,
                             eager=True)
        assert got["rank_steps"] == [(maxiter, maxiter)] * sm.world
        assert np.array_equal(got["x"], want["x"])


@pytest.mark.cuda
def test_captured_allgather_replays_equal_eager_on_card(card_pool):
    """An NCCL allgather captured in a CUDA graph right after eager ones
    (still pending for the group's watchdog), replayed 100 times: each
    replay bit-equal to the eager allgather."""
    from ellspmv_tpu_torch.parallel.spmv import captured_allgather_task
    if card_pool.backend != "nccl":
        pytest.skip("gloo ranks sharing a card cannot be captured "
                    "(test_graph_around_a_gloo_collective_raises_on_card)")
    assert card_pool.run(captured_allgather_task, [(1000, 100)]) == \
        [{"equal": True}]


@pytest.mark.cuda
def test_graph_around_a_gloo_collective_raises_on_card():
    """Gloo ranks sharing the card: a CUDA graph around their allgather
    raises in the ranks, and the call fails; nothing falls back."""
    _needs_card()
    from ellspmv_tpu_torch.parallel.launch import RankFailure, RankPool
    from ellspmv_tpu_torch.parallel.spmv import captured_allgather_task
    with RankPool(["cuda:0"] * 2, timeout=60) as pool:
        with pytest.raises(RankFailure, match="raised in captured_"):
            pool.run(captured_allgather_task, [(1000, 1)] * 2, timeout=120)


@pytest.mark.cuda
def test_a_rank_out_of_time_in_a_replay_fails_the_call_on_card():
    """The card twin of `test_a_rank_out_of_time_fails_the_call`: a rank
    that keeps replaying a graph with its NCCL allgather (which the
    group's watchdog does not time) fails the call at the call's
    deadline, and the pool stops it."""
    _needs_card()
    from ellspmv_tpu_torch.parallel.launch import RankFailure, RankPool
    from ellspmv_tpu_torch.parallel.spmv import captured_allgather_task
    t0 = time.monotonic()
    with RankPool(["cuda:0"], timeout=60) as pool:
        assert pool.run(captured_allgather_task, [(8, 1)]) == \
            [{"equal": True}]
        with pytest.raises(RankFailure, match="did not finish"):
            pool.run(captured_allgather_task, [(8, 10 ** 9)], timeout=2)
        assert not any(p.is_alive() for p in pool._procs)
    assert time.monotonic() - t0 < 120


# -- the loops captured in CUDA graphs: the chained protocol and CG ----------

def _grew(before: dict, after: dict) -> dict:
    return {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["auto", "xla"])
@pytest.mark.parametrize("name", sorted(TRACEABLE_CASES))
def test_captured_chained_loop_equals_eager_on_card(name, backend):
    """Two blocks and five single iterations replayed from their graphs
    give the eager loop's y bit for bit, twice, and the replays count the
    kernels that the eager loop launches."""
    _needs_card()
    _, matrix, x, y = traceable_case(name, device="cuda")
    operand, fn = traceable_spmv(matrix, backend)
    iters = 2 * CHAINED_BLOCK + 5
    start, run = _eager_loop(fn, operand, x, y)
    start()
    before = launch_counts()
    want = run(iters)
    torch.cuda.synchronize()
    eager = _grew(before, launch_counts())
    assert backend == "xla" or eager
    with _block_loop(fn, operand, x, y) as (start, run):
        for _ in range(2):
            start()
            before = launch_counts()
            got = run(iters)
            torch.cuda.synchronize()
            assert _grew(before, launch_counts()) == eager
            assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["float64", "float32"])
def test_captured_cg_equals_eager_on_card(precision):
    """`cg` (one masked step captured and replayed, the iteration count
    read a step behind) against `cg_eager`: the same iterations, x and
    residual, bit for bit; at most STEPS_AHEAD masked steps; the kernels' launches
    counted through the replays; `maxiter` honoured; a converged start
    left as it is."""
    _needs_card()
    ell = ell_from_coo(fem_mesh_2d(64), sort_rows=True, value_dtype=precision,
                       device="cuda")
    operand, fn = traceable_spmv(ell)
    b = torch.from_numpy(np.random.RandomState(8).rand(ell.num_rows)).to(
        "cuda", ell.values.dtype)
    tol = 1e-8 if precision == "float64" else 1e-4

    def solve(solver, **kw):
        return solver(lambda op, v: fn(op, v), b, operand=operand, **kw)
    want = solve(cg_eager, tol=tol)
    before = launch_counts()
    got = solve(cg, tol=tol)
    grew = _grew(before, launch_counts())
    assert got.iterations == want.iterations > STEPS_AHEAD
    assert torch.equal(got.x, want.x)
    assert got.residual_norm == want.residual_norm
    assert want.iterations <= got.steps <= want.iterations + STEPS_AHEAD
    # K1 once for r = b - A*x0 and once a step; K6 twice before, twice a step
    assert grew["ell_spmv"] == 1 + got.steps
    assert grew.get("dot", 0) == (2 + 2 * got.steps
                                  if precision == "float64" else 0)
    for maxiter in (1, 2, want.iterations - 1):
        got = solve(cg, tol=tol, maxiter=maxiter)
        want = solve(cg_eager, tol=tol, maxiter=maxiter)
        assert got.iterations == got.steps == want.iterations == maxiter
        assert torch.equal(got.x, want.x)
    done = solve(cg, tol=tol)
    again = solve(cg, x0=done.x, tol=100 * tol)
    assert again.iterations == 0 and again.steps <= STEPS_AHEAD
    assert torch.equal(again.x, done.x)


CAPTURES_A_HOST_READ = textwrap.dedent("""
    import torch
    from ellspmv_tpu_torch.utils.graphs import Graph
    x = torch.ones(8, device="cuda")
    try:
        Graph(lambda: x.sum().item(), "cuda")
    except RuntimeError as e:
        print("raised:", str(e).splitlines()[0])
        raise SystemExit(0)
    raise SystemExit(3)
""")


@pytest.mark.cuda
def test_capturing_a_host_read_raises_on_card():
    """`utils/graphs.Graph` raises where the body reads the host, and does
    not fall back to eager launches. In a child process: a failed capture
    may leave the process's CUDA context unusable."""
    _needs_card()
    proc = subprocess.run([sys.executable, "-c", CAPTURES_A_HOST_READ],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("raised:")


# -- HPCG's multigrid: K8 and the PCG set -------------------------------------

def _symgs_scale(dia, r, x, rows, slot):
    """Per row of `rows`: (|r| + Σ_{j≠i} |a_ij·x_j|) / |a_ii|, the size of
    what K8 sums for it."""
    n = dia.num_rows
    j = rows + torch.tensor(dia.offsets, device=r.device)[:, None]
    inside = (j >= 0) & (j < n)
    inside[slot] = False
    terms = (dia.data[:, rows] * x[j.clamp(0, n - 1)]).abs()
    total = torch.where(inside, terms, 0.0).sum(0) + r[rows].abs()
    return total / dia.data[slot, rows].abs()


@pytest.mark.cuda
@pytest.mark.parametrize("grid", [(32, 32, 32), (16, 24, 32), (3, 5, 6)])
def test_symgs_kernel_matches_plain_on_card(grid):
    """K8 against its plain version, colour by colour, both on the
    colour-major copy of the DIA values: the colour's rows within fp64's
    1e-13 of what they sum, every other row untouched bit for bit, one
    launch a colour."""
    _needs_card()
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.models.generators import hpcg_27pt
    from ellspmv_tpu_torch.ops import symgs_cuda
    dia = dia_from_coo(hpcg_27pt(*grid), device="cuda")
    slot = dia.offsets.index(0)
    cm = symgs_cuda.colour_major(dia, grid, slot)
    rng = np.random.RandomState(11)
    r = torch.from_numpy(rng.rand(dia.num_rows)).cuda()
    x0 = torch.from_numpy(rng.rand(dia.num_rows)).cuda()
    colour = symgs_cuda.colour_of(grid, "cuda")
    for c in range(8):
        before = symgs_cuda.launches
        got, want = x0.clone(), x0.clone()
        symgs_cuda.dia_symgs(cm, r, got, c)
        symgs_cuda.dia_symgs_torch(cm, r, want, c)
        torch.cuda.synchronize()
        assert symgs_cuda.launches == before + 1
        rows = symgs_cuda.colour_rows(grid, c, "cuda")
        assert torch.equal(got[colour != c], x0[colour != c])
        err = (got[rows] - want[rows]).abs() / _symgs_scale(dia, r, x0,
                                                            rows, slot)
        assert float(err.max()) <= 1e-13, (c, float(err.max()))


def _hpcg_on_card(grid, depth):
    from ellspmv_tpu_torch.models import multigrid
    port = multigrid.hpcg(*grid, depth=depth, device="cuda")
    lv = port.levels[0]
    b = lv.fn(lv.matrix, torch.ones(lv.matrix.num_rows, dtype=torch.float64,
                                    device="cuda"))
    return port, lv, b


@pytest.mark.cuda
def test_captured_pcg_set_equals_eager_on_card():
    """One HPCG set (50 iterations, tolerance 0) captured once and
    replayed twice against the same set launched eagerly: x and every
    residual norm bit for bit, each replay restarting from x = 0; the
    launches counted through the replays; and the set against the plain
    reference on the card (fp64, sums in another order: 1e-12 of x, and of
    the first norm)."""
    _needs_card()
    import reference_hpcg as ref

    from ellspmv_tpu_torch.models import solvers
    from ellspmv_tpu_torch.utils.graphs import Graph
    port, lv, b = _hpcg_on_card((32, 32, 32), 4)
    s = solvers.pcg_set_state(b, 50)

    def one_set():
        solvers.pcg_set(s, lv.fn, b, precond=port, operand=lv.matrix)
    one_set()
    torch.cuda.synchronize()
    want = [t.clone() for t in s]
    with Graph(one_set, "cuda") as graph:
        for _ in range(2):
            for t in s:
                t.fill_(7.0)
            before = launch_counts()
            graph.replay()
            torch.cuda.synchronize()
            grew = _grew(before, launch_counts())
            for a, c in zip(s, want):
                assert torch.equal(a, c)
            # per iteration: 8 colours x (4 sweeps at 3 levels + 2 at the
            # coarsest); K2 for A·p and 3 residuals (x = 0 leaves r = b
            # with no multiply); K6 for r·z, p·Ap and r·r, plus r·r once
            assert grew["dia_symgs"] == 50 * 8 * (3 * 4 + 2)
            assert grew["dia_spmv"] == 50 * 4
            assert grew["dot"] == 1 + 50 * 3
    reference = ref.hierarchy(32, 32, 32, device="cuda")
    x, norms = ref.pcg_set(reference, b, 50)
    torch.testing.assert_close(want[0], x, rtol=1e-12, atol=0)
    torch.testing.assert_close(want[4] / norms[0], norms / norms[0], rtol=0,
                               atol=1e-12)


#: NPB CG's class A (npbparams.h) and its published ζ.
NPB_CLASS_A = dict(na=14000, nonzer=11, rcond=0.1, shift=20.0, niter=15,
                   zeta_verify=17.130235054029)


@pytest.mark.cuda
def test_npb_class_a_through_the_captured_step_on_card():
    """NPB CG's class A (14,000 rows, 1.85M nonzeros) as the benchmark
    runs class C: the matrix made on the card, the chooser, and one outer
    step (25 CG iterations and A·z) captured once and replayed NITER
    times from x = 1: ζ within NPB's 1e-10 of its published value; x, ζ
    and the step counter bit for bit the same steps launched eagerly;
    each replay 26 multiplies and 54 dots (r·r once, p·q and r·r an
    iteration, then ‖x - A·z‖, x·z and z·z)."""
    _needs_card()
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from spmv_bench.generators import npb_cg

    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.models import solvers
    p = NPB_CLASS_A
    m = npb_cg.generate(p, 1, "cuda")
    n = m.num_rows
    coo = CooMatrix(n, n, m.rows.int().cpu().numpy(),
                    m.cols.int().cpu().numpy(), m.values.cpu().numpy())
    operand, fn = traceable_spmv(auto_from_coo(coo, device="cuda"))
    eager = solvers.power_state(n, 25, device="cuda")
    for _ in range(p["niter"]):
        solvers.power_step(eager, fn, p["shift"], operand=operand)
    s = solvers.power_state(n, 25, device="cuda")
    step, graph = solvers.power_stepper(s, fn, p["shift"], operand=operand)
    try:
        s.x.fill_(1)
        s.steps.zero_()
        for k in range(p["niter"]):
            before = launch_counts()
            step()
            torch.cuda.synchronize()
            grew = _grew(before, launch_counts())
            assert grew.pop("dot") == 54, k
            assert sum(grew.values()) % 26 == 0 and grew, (k, grew)
    finally:
        graph.close()
    for a, b in zip([s.x, s.zeta, s.rnorm, s.steps],
                    [eager.x, eager.zeta, eager.rnorm, eager.steps]):
        assert torch.equal(a, b)
    assert int(s.steps) == p["niter"]
    gap = abs(float(s.zeta) - p["zeta_verify"]) / p["zeta_verify"]
    assert gap <= 1e-10, gap


@pytest.mark.cuda
def test_no_span_per_graph_replay_on_card():
    """The set-up log on a card: the chooser's tree holds the copy to the
    card, and NPB's capture keeps a tree of its own; the chained blocks'
    replays and the captured step's replays keep no span, in a recording
    or in the log."""
    _needs_card()
    from ellspmv_tpu_torch.formats.auto import auto_from_coo
    from ellspmv_tpu_torch.models import solvers
    from ellspmv_tpu_torch.utils import timing
    matrix = auto_from_coo(banded_random(20_000, 8, 500, seed=3),
                           value_dtype="float64", device="cuda")
    chooser = timing.setup_log()[-1]
    assert chooser.spans[0].name == "formats.auto_from_coo"
    (up,) = chooser.find("formats.upload")
    assert up.attrs["bytes"] > 0 and up.seconds > 0
    operand, fn = traceable_spmv(matrix)
    s = solvers.power_state(matrix.num_rows, 5, torch.float64, "cuda")
    step, graph = solvers.power_stepper(s, fn, 10.0, operand=operand)
    assert timing.setup_log()[-1].spans[0].name == \
        "solvers.power_step.capture"
    x = torch.ones(matrix.num_rows, dtype=torch.float64, device="cuda")
    before = timing.setup_log()
    try:
        with _block_loop(fn, operand, x, torch.zeros_like(x)) as (start,
                                                                  run):
            start()
            with timing.recording() as rec:
                run(2 * CHAINED_BLOCK + 3)
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
    finally:
        graph.close()
    assert rec.spans == [] and timing.setup_log() == before
