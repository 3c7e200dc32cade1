"""The port's kernels on a card, held against their plain PyTorch versions
(and, where the plain version is exact, bit for bit): the ``cuda`` tests.

This file imports neither jax nor the JAX package and uses no fixture of
``tests/conftest.py``, so that it runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_card.py tests/test_torch_imports.py -q -rA

(``chip_smoke.py`` runs that on the card). Every input comes from a numpy
seed (``tests/torch_cases.py``). Off a card each test skips, and a skip is
no pass. Tolerances, per row relative to sum |a*x| + |y| (or the vectors'
sum |x*y| for the dot): fp64 1e-13, f32 1e-5, bf16 1e-2."""

import ctypes
import dataclasses
import math

import numpy as np
import pytest
import torch

from ellspmv_tpu_torch.formats.csr import csr_from_coo
from ellspmv_tpu_torch.formats.ell import ell_from_coo
from ellspmv_tpu_torch.formats.hybrid import (hybrid_from_coo, hybrid_spmv,
                                              kernel_launches)
from ellspmv_tpu_torch.formats.sell import kernel_launches as sell_launches
from ellspmv_tpu_torch.formats.sell import sell_from_coo, sell_spmv
from ellspmv_tpu_torch.formats.stream import column_order_products, stream_spmv
from ellspmv_tpu_torch.models.generators import banded_random, power_law
from ellspmv_tpu_torch.ops import (_build, dot_cuda, ell_cuda, permute,
                                   stream_sum)
from ellspmv_tpu_torch.ops.csr import csr_spmv, csr_spmv_segment, to_sell
from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv
from torch_cases import (CSR_CASES, PLAN_CASES, PRODUCT_CASES,
                               SELL_CASES, SPMV_CASES, assert_deep_equal,
                               assert_rows_close,
                               dest_chunked, gather_pipeline_spmv,
                               general_targets, random_coo, spmv_inputs)


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
    _needs_card()
    coo, sm, kw, precision, x, y = spmv_inputs(case, "cuda")
    before = (stream_sum.launches, stream_sum.src_launches, permute.launches)
    got = stream_spmv(sm, x, y)
    torch.cuda.synchronize()
    deeper = len(sm.ddsum.levels) - 1
    assert (stream_sum.launches - before[0], stream_sum.src_launches
            - before[1], permute.launches - before[2]) == (1, deeper, 1)
    want = gather_pipeline_spmv(coo, sm, kw, precision, x, y, "cuda",
                                 k1=ell_spmv, gather=permute.apply_permute,
                                 sums=stream_sum.stream_sum)
    assert torch.equal(got, want)


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
    per row; K1 (and, for the stream, K3 and the gather) launched on every
    rank."""
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
        assert all(c["stream_sum"] >= 1 and c["permute"] >= 1
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
