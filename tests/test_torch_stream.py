"""The port's stream format (``formats/stream.py``, ``ops/stream_sum.py``,
``ops/permute.py``) against the JAX package on the CPU: the power-law
generator bit for bit, the sum plans field for field, the plain segmented
sums against the interpret-mode Pallas kernel exactly, the gather against
both TPU routes, and `stream_spmv` against the NumPy oracle and the JAX
`stream_spmv`; and the port's delivery of each level's entries (products
laid out in position order, sums read through a map, one output buffer)
bit for bit against the pipeline that gathers every level into position
order first. The JAX plans are built with ``ELLSPMV_TPU_NO_PERMUTE`` set,
so that they keep the positions (sort keys) that the port's maps are
composed from; the JAX knobs are set in the environment, the port's are
arguments. The kernels themselves run only on a card (the ``cuda`` tests
below, and ``chip_smoke.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

from ellspmv_tpu.bench.harness import SpmvMetrics as JaxSpmvMetrics
from ellspmv_tpu.formats.coo import CooMatrix as JaxCoo
from ellspmv_tpu.formats.stream import stream_from_coo as jax_stream_from_coo
from ellspmv_tpu.formats.stream import stream_spmv as jax_stream_spmv
from ellspmv_tpu.models import generators as jax_generators
from ellspmv_tpu.ops import permute as jax_permute
from ellspmv_tpu.ops import stream_sum as jax_stream_sum
from ellspmv_tpu.ops.reference import coo_spmv_numpy
from ellspmv_tpu_torch.bench.harness import SpmvMetrics, benchmark_spmv
from ellspmv_tpu_torch.bench.traffic import (estimate_actual_bytes,
                                             gather_bytes,
                                             stream_bytes_estimate,
                                             sum_bytes)
from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.stream import (StreamMatrix,
                                              column_order_products,
                                              stream_from_coo,
                                              stream_from_layout,
                                              stream_layout, stream_spmv)
from ellspmv_tpu_torch.models.generators import power_law
from ellspmv_tpu_torch.ops import permute, stream_sum
from ellspmv_tpu_torch.ops.dispatch import spmv
from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv_torch
from tests.conftest import random_coo
from torch_cases import (PLAN_CASES, PRODUCT_CASES, SPMV_CASES,
                               dest_long_rows, dest_random,
                               gather_pipeline_spmv, general_targets,
                               random_products, rng_coo, spmv_inputs)

# Per-row tolerance of stream_spmv against the oracle, relative to
# sum |a*x| + |d*x| + |y|: fp64 is native (summation order alone differs),
# f32 and bf16 (stored in bf16, computed in f32) as their rounding allows.
TOLERANCE = {"float64": 1e-13, "float32": 1e-5, "bfloat16": 1e-2}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Small gathers run far faster on one CPU thread than on a contended
    pool; the results do not depend on it."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def no_permute(monkeypatch):
    monkeypatch.setenv("ELLSPMV_TPU_NO_PERMUTE", "1")


def port_coo(coo) -> CooMatrix:
    return CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     coo.values, coo.symmetry, coo.field)


# --------------------------------------------------------------------------
# The generator
# --------------------------------------------------------------------------

@pytest.mark.parametrize("args,kw", [
    ((2000, 5), {"seed": 3}),
    ((700, 8), {"alpha": 2.2, "seed": 1}),
    ((300, 3), {"value_dtype": np.float32}),
])
def test_power_law_bit_equal(args, kw):
    got, want = power_law(*args, **kw), jax_generators.power_law(*args, **kw)
    assert (got.num_rows, got.num_columns) == (want.num_rows,
                                               want.num_columns)
    for name in ("rowidx", "colidx", "values"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# The sum plan
# --------------------------------------------------------------------------



def assert_plans_equal(got, want):
    assert got.num_rows == want.num_rows
    assert tuple(got.chunk_bases) == tuple(want.chunk_bases)
    assert len(got.levels) == len(want.levels)
    for lg, lw in zip(got.levels, want.levels):
        assert (lg.in_rows, lg.out_len, lg.multi_len, lg.in_len) == \
            (lw.in_rows, lw.out_len, lw.multi_len, lw.in_len)
        np.testing.assert_array_equal(lg.keys, np.asarray(lw.keys))
        np.testing.assert_array_equal(lg.tkeys, np.asarray(lw.tkeys))
        assert len(lg.buckets) == len(lw.buckets)
        for bg, bw in zip(lg.buckets, lw.buckets):
            assert (bg.S, bg.K, bg.T, bg.sub) == (bw.S, bw.K, bw.T, bw.sub)
            np.testing.assert_array_equal(bg.estart, np.asarray(bw.estart))
            np.testing.assert_array_equal(bg.oc, np.asarray(bw.oc))
    np.testing.assert_array_equal(got.final_keys,
                                  np.asarray(want.final_keys))


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_sum_plan_equals_jax(case, no_permute):
    dest, n, cap, starts = PLAN_CASES[case]()
    got = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    want = jax_stream_sum.build_stream_sum(dest, n, cap=cap,
                                           chunk_starts=starts)
    assert_plans_equal(got, want)
    if case in ("long_rows", "chunked3", "chunked4"):
        assert len(got.levels) >= 2
    if case == "deep":
        assert len(got.levels) >= 4
    if case == "folded":
        assert any(b.sub > 1 for b in got.levels[0].buckets)


def _src_of(keys, in_len, n_out):
    src = np.full(n_out, -1, np.int64)
    real = np.flatnonzero(keys[:in_len] != stream_sum._I32_SENTINEL)
    src[keys[real]] = real
    return src


@pytest.mark.parametrize("case", ["long_rows", "chunked3", "empty_rows"])
def test_gather_maps_invert_the_positions(case):
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    offsets = []
    for i, lv in enumerate(plan.levels):
        src = stream_sum.position_map(lv)
        np.testing.assert_array_equal(
            src, _src_of(lv.keys, lv.in_len, lv.in_rows * 128))
        # the gap positions after the entries get no element
        assert (src[lv.keys[lv.in_len:]] == -1).all()
        # level 1 carries no map; a deeper level's points into the buffer,
        # at the outputs of the level before
        if i == 0:
            assert lv.src is None
        else:
            assert lv.src.dtype == torch.int32
            got = lv.src.numpy()
            np.testing.assert_array_equal(
                got, np.where(src >= 0, src + offsets[-1], -1))
        offsets.append(lv.out_offset)
    assert offsets == list(np.cumsum([0] + [lv.out_len for lv in
                                            plan.levels])[:-1])
    assert plan.buffer_len == sum(lv.out_len for lv in plan.levels)
    # every row terminates exactly once, at a terminal output in the buffer
    fs = plan.final_src.numpy()
    assert (fs >= 0).all() and len(np.unique(fs)) == n
    terminal = np.concatenate([np.arange(lv.out_offset + lv.multi_len,
                                         lv.out_offset + lv.out_len)
                               for lv in plan.levels])
    concat = np.searchsorted(terminal, fs)
    np.testing.assert_array_equal(terminal[concat], fs)
    np.testing.assert_array_equal(plan.final_keys[concat], np.arange(n))
    np.testing.assert_array_equal(concat, stream_sum.final_map(plan))


# name -> (COO factory, JAX environment, port keyword arguments)
FORMAT_CASES = {
    "unchunked": (lambda: power_law(3000, 6, seed=2), {}, {}),
    "chunks3": (lambda: random_coo(np.random.RandomState(7), 600, 900, 6000),
                {"ELLSPMV_TPU_STREAM_CHUNKS": "3"}, {"n_chunks": 3}),
    "cap32": (lambda: power_law(1500, 8, seed=4),
              {"ELLSPMV_TPU_SUM_CAP": "32"}, {"cap": 32}),
    "span": (lambda: random_coo(np.random.RandomState(8), 400, 3000, 40000),
             {"ELLSPMV_TPU_STREAM_SPAN": "1000"}, {"span_max": 1000}),
}


@pytest.mark.parametrize("case", sorted(FORMAT_CASES))
def test_stream_from_coo_plan_equals_jax(case, no_permute, monkeypatch):
    make, env, kw = FORMAT_CASES[case]
    coo = make()
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    want = jax_stream_from_coo(JaxCoo(coo.num_rows, coo.num_columns,
                                      coo.rowidx, coo.colidx, coo.values),
                               value_dtype=np.float64)
    got = stream_from_coo(port_coo(coo), value_dtype="float64", **kw)
    assert got.prod_len == want.prod_len
    assert (got.num_rows, got.num_columns, got.num_nonzeros) == \
        (want.num_rows, want.num_columns, want.num_nonzeros)
    assert_plans_equal(got.ddsum, want.ddsum)
    if case == "chunks3":
        assert len(got.ddsum.chunk_bases) == 4
    if case == "span":          # 3 spans, but too few entries to chunk
        assert len(got.ddsum.chunk_bases) == 0


@pytest.mark.parametrize("args,chunks", [
    ((1_000_000, 7_049_701), 6),       # config3: one chunk per span
    ((1_000_000, 2_000_000), 4),       # capped by entries per chunk
    ((100_000, 7_000_000), 1),
    ((1_000_000, 7_000_000, 196608, 3), 3),    # forced
    ((5, 100, 196608, 10), 5),         # forced, at most one per column
])
def test_chunk_count_rule(args, chunks):
    from ellspmv_tpu_torch.formats.stream import num_chunks
    assert num_chunks(*args) == chunks


# --------------------------------------------------------------------------
# The segmented sums (K3) and the gather (K4/K5)
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["long_rows", "folded", "chunked4"])
def test_plain_sums_equal_jax_kernel(case):
    """Each bucket's plain sums equal the interpret-mode Pallas kernel
    (`_runsum_f32`) on the same bucket arrays, exactly: small-integer
    values make every order of summation exact."""
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    rng = np.random.RandomState(9)
    lv = plan.levels[0]
    stream = rng.randint(-8, 9, lv.in_rows * 128).astype(np.float32)
    for b in lv.buckets:
        want = jax_stream_sum._runsum_f32(
            b.estart, b.oc, stream.reshape(lv.in_rows, 128), S=b.S, K=b.K,
            T=b.T, sub=b.sub, interpret=True)
        got = stream_sum.stream_sum_torch(stream_sum._sum_table([b]),
                                          torch.from_numpy(stream))
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(want).reshape(-1))


def _per_subtile_sums(table, stream):
    """The first kernel's schedule, in NumPy: per 1024-output subtile, all
    its runs in order into one accumulator per output."""
    ptr, start, count = (t.numpy().astype(np.int64) for t in
                         (table.slot_ptr, table.run_start, table.run_count))
    out = np.zeros(table.num_subtiles * stream_sum.R, stream.dtype)
    r = np.arange(stream_sum.R)
    for u in range(table.num_subtiles):
        acc = np.zeros(stream_sum.R, stream.dtype)
        for k in range(ptr[u], ptr[u + 1]):
            acc = acc + np.where(r < count[k], stream[np.minimum(
                start[k] + r, len(stream) - 1)], 0).astype(stream.dtype)
        out[u * stream_sum.R:(u + 1) * stream_sum.R] = acc
    return out


def _per_block_sums(table, stream):
    """The kernel's grid, in NumPy: each block at its launch position sums
    its R/Q outputs over its runs in order."""
    start, count = (t.numpy().astype(np.int64) for t in
                    (table.run_start, table.run_count))
    width = stream_sum.R // stream_sum.Q
    out = np.full(table.num_subtiles * stream_sum.R, np.nan, stream.dtype)
    for j, first, runs in zip(table.order.numpy(), table.block_first.numpy(),
                              table.block_runs.numpy()):
        u, q = divmod(int(j), stream_sum.Q)
        r = q * width + np.arange(width)
        acc = np.zeros(width, stream.dtype)
        for k in range(first, first + runs):
            acc = acc + np.where(r < count[k], stream[np.minimum(
                start[k] + r, len(stream) - 1)], 0).astype(stream.dtype)
        out[u * stream_sum.R + r] = acc
    return out


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_block_split_covers_every_output_once(case):
    """Every level's grid: the blocks are a permutation of the subtiles'
    Q parts, each reads a prefix of its subtile's runs that holds every
    run reaching its outputs, and they launch by live elements,
    descending."""
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    for lv in plan.levels:
        _check_grid(lv.table, stream_sum.Q)


@pytest.mark.parametrize("parts", [1, 4, 16])
@pytest.mark.parametrize("case", ["cap300", "chunked4", "long_rows"])
def test_block_split_holds_for_other_part_counts(case, parts):
    """The table's grid at another count of blocks per subtile (as a build
    of variant sources takes it) keeps the same guarantees."""
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    for lv in plan.levels:
        _check_grid(stream_sum._sum_table(lv.buckets, parts), parts)


def _check_grid(t, parts):
    """The blocks of table `t`, `parts` per subtile, are a permutation of
    the subtiles' parts, each reads the prefix of its subtile's runs that
    ends with the last run reaching its outputs, and they launch by live
    elements, descending."""
    width = stream_sum.R // parts
    U = t.num_subtiles
    order = t.order.numpy()
    assert sorted(order) == list(range(parts * U))
    ptr = t.slot_ptr.numpy()
    count = t.run_count.numpy()
    covered = np.zeros(U * stream_sum.R, int)
    live = []
    for j, first, runs in zip(order, t.block_first.numpy(),
                              t.block_runs.numpy()):
        u, q = divmod(int(j), parts)
        covered[u * stream_sum.R + q * width:
                u * stream_sum.R + (q + 1) * width] += 1
        assert first == ptr[u] and first + runs <= ptr[u + 1]
        reach = np.flatnonzero(count[ptr[u]:ptr[u + 1]] > q * width)
        assert runs == (reach[-1] + 1 if len(reach) else 0)
        live.append(int(np.clip(count[first:first + runs] - q * width,
                                0, width).sum()))
    assert (covered == 1).all()
    assert live == sorted(live, reverse=True)
    assert sum(live) == int(count.sum())


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plain_sums_equal_both_schedules(case):
    """`stream_sum_torch` on the new table is bit for bit the sums of the
    first kernel's schedule (per subtile) and of the new one (per block,
    longest first), in fp64 and f32."""
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    rng = np.random.RandomState(24)
    for lv in plan.levels:
        for dtype in (np.float64, np.float32):
            stream = rng.randn(lv.in_rows * 128).astype(dtype)
            got = stream_sum.stream_sum_torch(lv.table,
                                              torch.from_numpy(stream))
            np.testing.assert_array_equal(
                got.numpy(), _per_subtile_sums(lv.table, stream))
            np.testing.assert_array_equal(
                got.numpy(), _per_block_sums(lv.table, stream))


@pytest.mark.parametrize("case", ["random", "long_rows", "chunked3"])
def test_apply_stream_sum_exact_small_ints(case):
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    vals = np.random.RandomState(10).randint(-8, 9, len(dest))
    want = np.bincount(dest[dest >= 0], weights=vals[dest >= 0],
                       minlength=n)
    # level 1 takes its entries in position order
    src = torch.from_numpy(stream_sum.position_map(plan.levels[0]))
    for dtype in (torch.float64, torch.float32):
        v = permute.apply_permute_torch(src, torch.from_numpy(vals).to(dtype))
        got = stream_sum.apply_stream_sum(plan, v)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="level 1's input"):
        stream_sum.apply_stream_sum(plan, torch.zeros(plan.in_positions + 1))



def _cells_targets():
    # two groups of bpg=2 blocks; each element stays in its group
    rng = np.random.RandomState(12)
    group = 2 * jax_permute.BLOCK
    target = np.concatenate([g * group + rng.permutation(group)
                             for g in range(2)]).astype(np.int64)
    target[rng.rand(len(target)) < 0.2] = -1
    return target, len(target)


@pytest.mark.parametrize("route", ["general", "cells"])
def test_gather_realises_jax_route(route):
    """Both TPU plan kinds (K4's general route, K5's uniform cells) and the
    port's gather put every element where its target says."""
    target, n_out = (general_targets() if route == "general"
                     else _cells_targets())
    iota = np.arange(len(target), dtype=np.float32)
    if route == "general":
        plan = jax_permute.build_permute(target, n_out)
    else:
        plan = jax_permute.build_permute_cells(target, bpg=2)
        assert plan.bpg == 2
    (want,) = jax_permute.apply_permute(plan, iota, interpret=True)
    src = permute.gather_from_targets(target, n_out)
    got = permute.apply_permute_torch(torch.from_numpy(src),
                                      torch.from_numpy(iota)).numpy()
    covered = src >= 0
    assert covered.sum() == (target >= 0).sum()
    np.testing.assert_array_equal(got[covered],
                                  np.asarray(want)[:n_out][covered])
    np.testing.assert_array_equal(got[~covered], 0)


@pytest.mark.parametrize("case", ["duplicate", "out_of_range"])
def test_gather_from_targets_refuses_as_build_permute(case):
    target = np.arange(100, dtype=np.int64)
    if case == "duplicate":
        target[5] = target[9]
    else:
        target[3] = 100
    with pytest.raises(ValueError, match=r"distinct positions in \[0, "
                                         r"n_out\)") as jax_error:
        jax_permute.build_permute(target, 100)
    with pytest.raises(ValueError) as port_error:
        permute.gather_from_targets(target, 100)
    assert str(port_error.value) == str(jax_error.value)
    if case == "duplicate":     # unchecked on request, as in JAX
        src = permute.gather_from_targets(target, 100, validate=False)
        assert src[target[9]] in (5, 9)


def test_wrappers_take_the_plain_version_on_the_cpu():
    dest, n, cap, starts = dest_long_rows()
    plan = stream_sum.build_stream_sum(dest, n)
    lv = plan.levels[0]
    src = torch.from_numpy(stream_sum.position_map(lv))
    v = torch.from_numpy(np.random.RandomState(13).randn(lv.in_len))
    before = (permute.launches, stream_sum.launches, stream_sum.src_launches)
    before_products = stream_sum.product_launches
    s = permute.apply_permute(src, v)
    assert torch.equal(s, permute.apply_permute_torch(src, v))
    out = stream_sum.stream_sum(lv.table, s)
    assert torch.equal(out, stream_sum.stream_sum_torch(lv.table, s))
    assert out.shape == (lv.out_len,)
    # through the map, into a slice of a larger buffer
    buffer = torch.full((lv.out_len + 5,), np.nan, dtype=torch.float64)
    got = stream_sum.stream_sum(lv.table, v, src, buffer[3:-2])
    assert got.data_ptr() == buffer[3:].data_ptr()
    assert torch.equal(buffer[3:-2], out)
    assert buffer[:3].isnan().all() and buffer[-2:].isnan().all()
    prod = random_products(plan, torch.float64, narrow=True)
    got = stream_sum.stream_sum(lv.table, prod)
    assert torch.equal(got, stream_sum.stream_sum_torch(lv.table, prod))
    assert (permute.launches, stream_sum.launches,
            stream_sum.src_launches) == before
    assert stream_sum.product_launches == before_products


@pytest.mark.parametrize("case", ["src_dtype", "payload_dtype", "shape",
                                  "noncontiguous", "mixed_device",
                                  "meta_device"])
def test_permute_wrapper_refuses(case):
    src = torch.tensor([2, -1, 0], dtype=torch.int32)
    payload = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    err = ValueError
    if case == "src_dtype":
        src, err = src.long(), TypeError
    elif case == "payload_dtype":
        # 16-bit floats move as bf16 bit patterns only; fp16 has no kernel
        payload, err = payload.to(torch.float16), TypeError
    elif case == "shape":
        payload = payload.view(1, 3)
    elif case == "noncontiguous":
        payload = torch.ones(6, dtype=torch.float64)[::2]
    elif case == "mixed_device":
        payload = payload.to("meta")
    elif case == "meta_device":
        src, payload = src.to("meta"), payload.to("meta")
    with pytest.raises(err):
        permute.apply_permute(src, payload)


@pytest.mark.parametrize("case", ["dtype", "table_dtype", "mixed_device",
                                  "meta_device", "src_dtype", "src_device",
                                  "out_shape", "out_dtype", "prod_dtype",
                                  "prod_x_dtype", "prod_x_shape",
                                  "prod_x_device", "prod_rowsize",
                                  "prod_colidx_dtype", "prod_lbase_shape",
                                  "prod_src", "prod_out_dtype"])
def test_stream_sum_wrapper_refuses(case):
    dest, n, cap, starts = dest_random()
    plan = stream_sum.build_stream_sum(dest, n)
    lv = plan.levels[0]
    table = lv.table
    stream = torch.zeros(lv.in_rows * 128, dtype=torch.float64)
    src = out = None
    err = ValueError
    if case.startswith("prod"):
        # products of one of each column layout
        stream = random_products(plan, torch.float64,
                                 narrow=case != "prod_colidx_dtype")
        ell = stream.ell
    if case == "dtype":
        stream, err = stream.to(torch.bfloat16), TypeError
    elif case == "table_dtype":
        table = dataclasses.replace(table, slot_ptr=table.slot_ptr.long())
        err = TypeError
    elif case == "mixed_device":
        stream = stream.to("meta")
    elif case == "meta_device":
        table, stream = table.to("meta"), stream.to("meta")
    elif case.startswith("src"):
        src = torch.from_numpy(stream_sum.position_map(lv))
        src, err = ((src.long(), TypeError) if case == "src_dtype"
                    else (src.to("meta"), ValueError))
    elif case == "out_shape":
        out = torch.empty(lv.out_len + 1, dtype=torch.float64)
    elif case in ("out_dtype", "prod_out_dtype"):
        out, err = torch.empty(lv.out_len, dtype=torch.float32), TypeError
    elif case == "prod_dtype":
        ell.values, err = ell.values.to(torch.bfloat16), TypeError
    elif case == "prod_x_dtype":
        stream.x, err = stream.x.float(), TypeError
    elif case == "prod_x_shape":
        stream.x = torch.cat([stream.x, stream.x[:1]])
    elif case == "prod_x_device":
        stream.x = stream.x.to("meta")
    elif case == "prod_rowsize":
        stream.ell = dataclasses.replace(
            ell, values=ell.values.expand(2, -1).contiguous())
    elif case == "prod_colidx_dtype":
        ell.colidx, err = ell.colidx.long(), TypeError
    elif case == "prod_lbase_shape":
        ell.lbase = ell.lbase[:-1]
    elif case == "prod_src":
        src = torch.from_numpy(stream_sum.position_map(lv))
    with pytest.raises(err):
        stream_sum.stream_sum(table, stream, src, out)


def test_sum_position_space_guard(monkeypatch):
    """The position space is int32; a size beyond it raises rather than
    wraps, as in the JAX package (test_stream_sum_key_space_guard)."""
    class Tiny:
        max = 1000
    monkeypatch.setattr(stream_sum.np, "iinfo", lambda *a, **k: Tiny())
    with pytest.raises(ValueError, match="int32"):
        stream_sum.build_stream_sum(np.zeros(1024, np.int64), n_rows=2048)


# --------------------------------------------------------------------------
# stream_spmv
# --------------------------------------------------------------------------



def _row_errors(coo, x, y, got, sm):
    """max over rows of |got - oracle| relative to sum |a*x| + |y|."""
    want = coo_spmv_numpy(coo, x, y)
    absm = CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                     np.abs(coo.values), coo.symmetry, coo.field)
    scale = coo_spmv_numpy(absm, np.abs(x),
                           None if y is None else np.abs(y))
    return float(np.max(np.abs(got - want) / np.maximum(scale, 1e-300),
                        initial=0.0))


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_stream_spmv_matches_oracle(case):
    make, precision, with_y, kw = SPMV_CASES[case]
    coo = make()
    rng = np.random.RandomState(16)
    x = rng.rand(coo.num_columns)
    y = rng.randn(coo.num_rows) if with_y else None
    sm = stream_from_coo(coo, value_dtype=precision, **kw)
    dtype = torch.float64 if precision == "float64" else torch.float32
    assert sm.values.dtype == dtype
    got = stream_spmv(sm, torch.from_numpy(x),
                      None if y is None else torch.from_numpy(y))
    assert got.shape == (coo.num_rows,) and got.dtype == dtype
    err = _row_errors(coo, x, y, got.double().numpy(), sm)
    assert err <= TOLERANCE[precision], err
    if case in ("hubs", "deep"):
        assert len(sm.ddsum.levels) >= 2
    if case.startswith("chunked"):
        assert len(sm.ddsum.chunk_bases) == kw["n_chunks"] + 1


def test_stream_spmv_empty_matrix():
    empty = CooMatrix(4, 4, np.zeros(0, np.int32), np.zeros(0, np.int32),
                      np.zeros(0))
    sm = stream_from_coo(empty, value_dtype="float64")
    got = stream_spmv(sm, torch.ones(4, dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), np.zeros(4))


# name -> (COO factory, precision, JAX environment, port arguments)
JAX_CASES = {
    "rect": (rng_coo(700, 500, 4000), "float64", {}, {}),
    "f32": (rng_coo(600, 600, 5000), "float32", {}, {}),
    "chunked_sort_path": (rng_coo(400, 700, 4000), "float64",
                          {"ELLSPMV_TPU_STREAM_CHUNKS": "3",
                           "ELLSPMV_TPU_NO_PERMUTE": "1"}, {"n_chunks": 3}),
    # the uniform-cell route (K5) on the JAX side
    "cells": (rng_coo(500, 900, 6000), "float64",
              {"ELLSPMV_TPU_STREAM_CHUNKS": "3",
               "ELLSPMV_TPU_STREAM_BPG": "2",
               "ELLSPMV_TPU_CELLS_MIN": "0"}, {"n_chunks": 3}),
}


@pytest.mark.parametrize("case", sorted(JAX_CASES))
def test_stream_spmv_matches_jax(case, monkeypatch):
    """y against the JAX stream_spmv, at tests/test_stream.py's tolerances
    (its interpret mode loses the double-double error-free transforms)."""
    make, precision, env, kw = JAX_CASES[case]
    coo = make()
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rng = np.random.RandomState(17)
    x = rng.rand(coo.num_columns)
    y = rng.randn(coo.num_rows)
    jsm = jax_stream_from_coo(JaxCoo(coo.num_rows, coo.num_columns,
                                     coo.rowidx, coo.colidx, coo.values),
                              value_dtype=np.dtype(precision))
    if case == "cells":
        assert jsm.ddsum.levels[0].perm.bpg == 2
    want = np.asarray(jax_stream_spmv(jsm, x, y), np.float64)
    sm = stream_from_coo(coo, value_dtype=precision, **kw)
    got = stream_spmv(sm, torch.from_numpy(x),
                      torch.from_numpy(y)).double().numpy()
    rtol = 2e-4 if precision == "float32" else 5e-5
    scale = max(np.max(np.abs(want), initial=0.0), 1.0)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def test_dispatch_benchmark_and_metrics(no_permute):
    coo = random_coo(np.random.RandomState(18), 400, 400, 3000)
    sm = stream_from_coo(port_coo(coo), value_dtype="float64")
    x = np.random.RandomState(19).rand(400)
    xt = torch.from_numpy(x)
    np.testing.assert_allclose(spmv(sm, xt).numpy(), coo_spmv_numpy(coo, x),
                               rtol=1e-13, atol=1e-13)
    res = benchmark_spmv(None, sm, xt, repeat=2, warmup=1)
    assert res.best > 0 and res.metrics.num_nonzeros == coo.num_nonzeros
    # warmup and repeat calls accumulate
    np.testing.assert_allclose(res.y.numpy(), 3 * coo_spmv_numpy(coo, x),
                               rtol=1e-12)
    res = benchmark_spmv(None, sm, xt, repeat=2, warmup=1,
                         protocol="chained")
    assert res.best > 0 and bool(torch.isfinite(res.y).all())
    for precision in ("float64", "float32", "bfloat16"):
        jsm = jax_stream_from_coo(coo, value_dtype=precision,
                                  separate_diagonal=True)
        got = SpmvMetrics.for_matrix(stream_from_coo(
            port_coo(coo), value_dtype=precision, separate_diagonal=True))
        assert vars(got) == vars(JaxSpmvMetrics.for_matrix(jsm))


def test_traffic_counts_the_plan():
    coo = power_law(20_000, 8, seed=6)
    sm = stream_from_coo(coo, value_dtype="float64")
    plan = sm.ddsum
    slots = plan.in_positions
    assert sm.prod.padded_rows == slots >= sm.prod_len
    exact = estimate_actual_bytes(sm)
    # K1 runs over one slot per position of level 1; 20,000 columns keep
    # every block narrow: 2 bytes a slot and a base per 256
    assert sm.prod.lcol is not None
    k1 = slots * (8 + 2 + 8) + 4 * -(-slots // 256) + coo.num_columns * 8
    assert estimate_actual_bytes(sm.prod, with_y=False) == k1
    # level 1's K3 reads the products in place, the deeper levels read
    # through their maps, one gather ends it; no gather per level and no
    # concatenation
    sums = sum(sum_bytes(lv.table, 8, with_map=i > 0)
               for i, lv in enumerate(plan.levels))
    assert len(plan.levels) >= 2
    assert exact == (k1 + sums + gather_bytes(plan.final_src, 8)
                     + coo.num_rows * 8)
    # the chooser's estimate leaves out the deeper levels and the pads, so
    # it lies a little below the count
    est = stream_bytes_estimate(coo.num_nonzeros, coo.num_rows,
                                coo.num_columns, 8, True)
    assert 0.9 * exact <= est <= exact, (est, exact)
    live = sum(int(lv.table.run_count.sum()) for lv in plan.levels)
    assert live == sum(int((stream_sum.position_map(lv) >= 0).sum())
                       for lv in plan.levels)
    assert isinstance(sm, StreamMatrix) and sm.worksize == coo.num_nonzeros


# --------------------------------------------------------------------------
# The delivery of each level's entries, against gathering them first
# --------------------------------------------------------------------------


@pytest.mark.parametrize("case", PRODUCT_CASES)
def test_position_order_products_equal_the_gathered_column_order(case):
    """K1 over the products laid out in level 1's position order gives the
    level-1 stream that K1 over the column-order products and a gather
    gave; gap slots hold 0 and the column of the slot before them."""
    coo, sm, kw, precision, x, _ = spmv_inputs(case)
    x = x.to(sm.values.dtype)
    src = torch.from_numpy(stream_sum.position_map(sm.ddsum.levels[0]))
    col = column_order_products(coo, kw.get("separate_diagonal", False),
                                precision)
    want = permute.apply_permute_torch(src, ell_spmv_torch(col, x))
    got = ell_spmv_torch(sm.prod, x)
    assert got.shape == (sm.ddsum.in_positions,)
    assert torch.equal(got, want)
    gaps = (src < 0).numpy()
    assert gaps.any() and (sm.prod.values[0].numpy()[gaps] == 0).all()
    columns = sm.prod.columns()[0].numpy()
    after = np.flatnonzero(gaps)
    after = after[after > np.argmax(~gaps)]
    np.testing.assert_array_equal(columns[after], columns[after - 1])


@pytest.mark.parametrize("case", PRODUCT_CASES + ["wide"])
def test_layout_knows_the_products_column_layout(case):
    """`StreamLayout.products_narrow`, by which the chooser prices the
    products, is the column layout the built products take; the format
    finished from the layout is `stream_from_coo`'s; the column-order
    yardstick spans the JAX package's `prod_len`."""
    if case == "wide":
        # 2,000 rows of 8 columns over 300,000: every block of 256
        # position-order slots spans more than 65,536 columns
        coo, precision, kw = rng_coo(2000, 300_000, 16_000)(), "float32", {}
    else:
        coo, _, kw, precision, _, _ = spmv_inputs(case)
    split = kw.get("separate_diagonal", False)
    layout = stream_layout(coo, **kw)
    sm = stream_from_coo(coo, value_dtype=precision, **kw)
    assert layout.products_narrow() == (sm.prod.lcol is not None)
    assert layout.products_narrow() == (case != "wide")
    got = stream_from_layout(layout, value_dtype=precision)
    for a, b in ((got.prod.colidx, sm.prod.colidx),
                 (got.prod.values, sm.prod.values)):
        assert torch.equal(a, b)
    assert (got.prod_len, got.num_nonzeros) == (sm.prod_len, sm.num_nonzeros)
    col = column_order_products(coo, split, precision)
    assert col.padded_rows == sm.prod_len and col.values.dtype == \
        sm.values.dtype


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_sums_through_a_map_equal_gather_then_sum(case):
    """`stream_sum_torch` reading position p as ``stream[src[p]]`` is bit
    for bit the sums of the gathered stream, on level 1's map over its
    entries and on each deeper level's map into the output buffer."""
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    rng = np.random.RandomState(26)
    for dtype in (np.float64, np.float32):
        buffer = torch.from_numpy(rng.randn(plan.buffer_len).astype(dtype))
        for i, lv in enumerate(plan.levels):
            if i == 0:
                src = torch.from_numpy(stream_sum.position_map(lv))
                stream = torch.from_numpy(rng.randn(lv.in_len).astype(dtype))
            else:
                src, stream = lv.src, buffer
            want = stream_sum.stream_sum_torch(
                lv.table, permute.apply_permute_torch(src, stream))
            got = stream_sum.stream_sum_torch(lv.table, stream, src)
            assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_stream_spmv_bit_equal_to_the_gather_pipeline(case):
    """`stream_spmv` (products in position order, sums through maps, one
    output buffer, one gather) is bit for bit the pipeline that gathered
    every level first; test_stream_spmv_matches_oracle and
    test_stream_spmv_matches_jax hold the same cases to the oracle and to
    JAX."""
    coo, sm, kw, precision, x, y = spmv_inputs(case)
    got = stream_spmv(sm, x, y)
    want = gather_pipeline_spmv(coo, sm, kw, precision, x, y)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("columns", ["narrow", "int32"])
@pytest.mark.parametrize("case", sorted(SPMV_CASES))
def test_products_equal_k1_then_sums_in_place(case, columns):
    """K3's plain version reading level 1 as the stream format's products
    (each value times its gathered x) is bit for bit K1's plain version
    over the products, then the sums in place, on level 1 and through the
    whole plan; in the narrow column layout and in int32 columns."""
    coo, sm, kw, precision, x, _ = spmv_inputs(case)
    prod = sm.prod
    assert prod.lcol is not None
    if columns == "int32":
        prod = dataclasses.replace(prod, lcol=None, lbase=None)
    x = x.to(sm.values.dtype)
    plan = sm.ddsum
    products = stream_sum.Products(prod, x)
    stream = ell_spmv_torch(prod, x)
    got = stream_sum.stream_sum_torch(plan.levels[0].table, products)
    want = stream_sum.stream_sum_torch(plan.levels[0].table, stream)
    assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(stream_sum.apply_stream_sum(plan, products),
                       stream_sum.apply_stream_sum(plan, stream))


@pytest.mark.parametrize("narrow", [True, False])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32,
                                   torch.bfloat16])
@pytest.mark.parametrize("case", ["chunked3", "deep", "long_rows"])
def test_products_on_plans_equal_k1_then_sums(case, dtype, narrow):
    """On plans with column chunks, several levels and long rows: the
    products form against K1's plain version then the sums in place, bit
    for bit, in fp64, f32 and bf16 storage, narrow and int32 columns; NaNs
    planted in the alignment gaps' values change nothing, as no run reads
    a gap."""
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    table = plan.levels[0].table
    prod = random_products(plan, dtype, narrow)
    stream = ell_spmv_torch(prod.ell, prod.x)
    want = stream_sum.stream_sum_torch(table, stream)
    assert torch.equal(stream_sum.stream_sum_torch(table, prod), want)
    whole = stream_sum.apply_stream_sum(plan, stream)
    assert torch.equal(stream_sum.apply_stream_sum(plan, prod), whole)
    planted = random_products(plan, dtype, narrow, gap_value=np.nan)
    assert planted.ell.values.isnan().any()
    assert torch.equal(stream_sum.stream_sum_torch(table, planted), want)
    assert torch.equal(stream_sum.apply_stream_sum(plan, planted), whole)


@pytest.mark.parametrize("how", ["dropped", "moved to a gap"])
@pytest.mark.parametrize("level", [0, -1])
@pytest.mark.parametrize("case", ["chunked3", "deep", "long_rows"])
def test_plan_refuses_a_read_position_without_a_source(case, level, how):
    """A map in which a position that a run reads has no source (its entry
    dropped, or moved to an alignment gap) is refused before it ships."""
    dest, n, cap, starts = PLAN_CASES[case]()
    plan = stream_sum.build_stream_sum(dest, n, cap=cap, chunk_starts=starts)
    lv = plan.levels[level]
    k = int(np.flatnonzero(lv.keys[:lv.in_len] != stream_sum._I32_SENTINEL)
            [0])
    if how == "dropped":
        lv.keys[k] = stream_sum._I32_SENTINEL
    else:
        assert len(lv.keys) > lv.in_len
        lv.keys[k] = lv.keys[lv.in_len]
    with pytest.raises(ValueError, match="a position that a run reads has "
                                         "no source"):
        stream_sum._attach_maps(plan)
