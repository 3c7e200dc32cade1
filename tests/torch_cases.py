"""Seeded inputs of the port's tests that need neither jax nor the JAX
package, shared by the tests that hold the port against the JAX package
(``test_torch_stream.py``) and the card tests (``test_torch_card.py``),
which run where jax is not installed: sum plans (`PLAN_CASES`), stream
SpMV cases (`SPMV_CASES`), a gather's targets, the stream pipeline that
gathers every level first, CSR and SELL cases, `random_coo`, the
port's copy of ``tests/conftest.random_coo`` (the same draws), and
`assert_deep_equal` for plans built two ways."""

import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch.formats.coo import CooMatrix
from ellspmv_tpu_torch.formats.stream import (column_order_products,
                                              stream_from_coo)
from ellspmv_tpu_torch.models.generators import (dense_rows, fem_mesh_2d,
                                                 power_law)
from ellspmv_tpu_torch.ops import permute, stream_sum
from ellspmv_tpu_torch.ops.ell_cuda import ell_spmv_torch
from ellspmv_tpu_torch.ops.reference import coo_spmv_numpy

TOLERANCE = {"float64": 1e-13, "float32": 1e-5, "bfloat16": 1e-2}


def assert_deep_equal(a, b, where="plan"):
    """`a` and `b` equal field for field, arrays and tensors bit for bit
    and of one type."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a) is type(b), where
        for f in dataclasses.fields(a):
            assert_deep_equal(getattr(a, f.name), getattr(b, f.name),
                              f"{where}.{f.name}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_deep_equal(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), where
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype, where
        np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert a == b, where


def random_coo(rng, n, m, nnz, symmetric=False, with_dups=False,
               pattern=False, index_dtype=np.int32):
    """``tests/conftest.random_coo`` as a port COO: the same draws from
    `rng`, so the same matrix."""
    rows = rng.randint(0, n, nnz).astype(index_dtype)
    cols = rng.randint(0, m, nnz).astype(index_dtype)
    if symmetric:
        lo = np.minimum(rows, cols)
        hi = np.maximum(rows, cols)
        rows, cols = hi, lo
    if not with_dups:
        keys = rows.astype(np.int64) * m + cols
        _, keep = np.unique(keys, return_index=True)
        rows, cols = rows[keep], cols[keep]
        nnz = len(rows)
    vals = np.ones(nnz) if pattern else rng.randn(nnz)
    return CooMatrix(n, m, rows, cols, vals,
                     "symmetric" if symmetric else "general",
                     "pattern" if pattern else "real")


def assert_rows_close(got, coo, x, y, precision, want=None):
    """got against `want` (default: the oracle), each row relative to
    sum |a*x| + |y|, within `TOLERANCE`."""
    if want is None:
        want = coo_spmv_numpy(coo, x, y)
    scale = coo_spmv_numpy(
        CooMatrix(coo.num_rows, coo.num_columns, coo.rowidx, coo.colidx,
                  np.abs(coo.values), coo.symmetry), np.abs(x),
        None if y is None else np.abs(y))
    err = np.abs(np.asarray(got, np.float64) - want) / np.maximum(scale,
                                                                  1e-300)
    assert err.max(initial=0.0) <= TOLERANCE[precision]


def pad(dest):
    e_pad = -(-len(dest) // 1024) * 1024
    return np.pad(dest, (0, e_pad - len(dest)), constant_values=-1)


def dest_random():
    rng = np.random.RandomState(0)
    dest = rng.randint(0, 300, 5000).astype(np.int64)
    dest[rng.rand(5000) < 0.05] = -1
    return pad(dest), 300, 128, None


def dest_long_rows():
    # two rows over the cap (a second level) and background
    rng = np.random.RandomState(1)
    dest = np.concatenate([np.full(1500, 7), np.full(400, 200),
                           rng.randint(0, 500, 3000)]).astype(np.int64)
    return pad(rng.permutation(dest)), 500, 128, None


def dest_deep():
    # a row of 5000 over cap 16: sub-rows of sub-rows, four levels
    rng = np.random.RandomState(2)
    dest = np.concatenate([np.full(5000, 3), rng.randint(0, 90, 600)])
    return pad(rng.permutation(dest.astype(np.int64))), 90, 16, None


def dest_empty_rows():
    rng = np.random.RandomState(3)
    dest = rng.randint(0, 200, 900).astype(np.int64) * 7   # 6 rows in 7 empty
    return pad(dest), 1400, 128, None


def dest_folded():
    # 40,000 one-entry rows: an S=1 bucket of 40 tiles folds 16 per step
    # (two steps and a tail of 8), and a few heavier rows
    rng = np.random.RandomState(4)
    dest = np.concatenate([np.arange(40_000), np.repeat(
        rng.choice(40_000, 30, replace=False), 9)]).astype(np.int64)
    return pad(rng.permutation(dest)), 40_000, 128, None


def dest_chunked(C):
    def make():
        rng = np.random.RandomState(5 + C)
        dest = np.concatenate([np.full(900, 7), np.full(800, 200),
                               rng.randint(0, 250, 2500)]).astype(np.int64)
        dest = pad(rng.permutation(dest))      # rows >= 250 but 7 empty
        cuts = np.sort(rng.choice(np.arange(1, len(dest)), C - 1,
                                  replace=False))
        return dest, 500, 128, [0, *cuts.tolist(), len(dest)]
    return make


def dest_cap300():
    # rows of 1500 and 400 entries under cap 300: subtiles of 300 runs, more
    # than K3 stages in shared memory at once
    dest, n, _, starts = dest_long_rows()
    return dest, n, 300, starts


PLAN_CASES = {
    "cap300": dest_cap300,
    "random": dest_random,
    "long_rows": dest_long_rows,
    "deep": dest_deep,
    "empty_rows": dest_empty_rows,
    "folded": dest_folded,
    "chunked3": dest_chunked(3),
    "chunked4": dest_chunked(4),
}

def general_targets():
    rng = np.random.RandomState(11)
    n_in, n_out = 40_000, 50_000
    target = rng.permutation(n_out)[:n_in].astype(np.int64)
    target[rng.rand(n_in) < 0.1] = -1
    return target, n_out


def hubs():
    rng = np.random.RandomState(14)
    n = 500
    rows = np.concatenate([np.full(1500, 7), np.full(1400, 200),
                           rng.randint(0, n, 3000)]).astype(np.int32)
    cols = rng.randint(0, n, len(rows)).astype(np.int32)
    return CooMatrix(n, n, rows, cols, rng.randn(len(rows)))


def empty_rows():
    return CooMatrix(6, 5, np.array([0, 1, 2, 4, 4], np.int32),
                     np.array([1, 0, 3, 2, 4], np.int32),
                     np.array([1.0, 2.0, 3.0, 4.0, 5.0]))


def rng_coo(*args, **kw):
    def make():
        return random_coo(np.random.RandomState(15), *args, **kw)
    return make


# name -> (COO factory, precision, with y, stream_from_coo arguments)
SPMV_CASES = {
    "rect": (rng_coo(700, 500, 4000), "float64", False, {}),
    "f32": (rng_coo(600, 600, 5000), "float32", False, {}),
    "y": (rng_coo(300, 400, 2500), "float64", True, {}),
    "duplicates": (rng_coo(100, 100, 1500, with_dups=True), "float64",
                   False, {}),
    "symmetric": (rng_coo(250, 250, 1200, symmetric=True), "float64",
                  False, {}),
    "separate_diagonal": (rng_coo(200, 200, 1500), "float64", True,
                          {"separate_diagonal": True}),
    "separate_diagonal_rect": (rng_coo(200, 150, 1500), "float32", False,
                               {"separate_diagonal": True}),
    "hubs": (hubs, "float64", False, {}),
    "empty_rows": (empty_rows, "float64", True, {}),
    "chunked": (rng_coo(600, 900, 6000), "float64", True, {"n_chunks": 4}),
    "chunked_f32": (rng_coo(300, 800, 3500), "float32", True,
                    {"n_chunks": 5}),
    "deep": (lambda: power_law(2000, 6, seed=5), "float64", False,
             {"cap": 8}),
    "bf16": (rng_coo(200, 200, 1200), "bfloat16", False, {}),
    "power_law": (lambda: power_law(4000, 8, seed=1), "float64", False, {}),
}

def gather_pipeline(plan, entries, gather=permute.apply_permute_torch,
                     sums=stream_sum.stream_sum_torch):
    """The plan's sums as the port first ran them: per level a gather of its
    entries into position order (`position_map`), then the sums; the
    levels' terminal outputs concatenated, and one gather into row order
    (`final_map`). `gather` and `sums` are the plain versions or the
    kernels."""
    device = entries.device
    parts, v = [], entries
    for lv in plan.levels:
        src = torch.from_numpy(stream_sum.position_map(lv)).to(device)
        out = sums(lv.table, gather(src, v))
        parts.append(out[lv.multi_len:])
        v = out[:lv.multi_len]
    final = torch.from_numpy(stream_sum.final_map(plan)).to(device)
    return gather(final, torch.cat(parts))


def gather_pipeline_spmv(coo, sm, kw, precision, x, y, device="cpu",
                          k1=ell_spmv_torch, **pipeline):
    """`stream_spmv` as the port first ran it: K1 over the column-order
    products, `gather_pipeline`, the split diagonal and y."""
    dtype = sm.values.dtype
    x = x.to(dtype)
    prod = column_order_products(coo, kw.get("separate_diagonal", False),
                                 precision)
    out = gather_pipeline(sm.ddsum, k1(prod.to(device), x), **pipeline)
    if sm.diag is not None and sm.num_columns > 0:
        xi = torch.arange(sm.num_rows, device=x.device).clamp_(
            max=sm.num_columns - 1)
        out = torch.addcmul(out, sm.diag, x[xi])
    return out if y is None else out + y.to(dtype)


def spmv_inputs(case, device="cpu"):
    make, precision, with_y, kw = SPMV_CASES[case]
    coo = make()
    rng = np.random.RandomState(16)
    x = torch.from_numpy(rng.rand(coo.num_columns)).to(device)
    y = (torch.from_numpy(rng.randn(coo.num_rows)).to(device) if with_y
         else None)
    sm = stream_from_coo(coo, value_dtype=precision, device=device, **kw)
    return coo, sm, kw, precision, x, y


# the stream_spmv cases whose products differ in layout: unchunked,
# chunked, several levels, split diagonal, fp64 and f32
PRODUCT_CASES = ["chunked", "chunked_f32", "deep", "f32", "hubs", "rect",
                 "separate_diagonal_rect"]


# name -> (COO factory, csr_from_coo keywords): tests/test_torch_csr.py's
# cases, drawn here without jax
CSR_CASES = {
    "general": (lambda: random_coo(np.random.RandomState(1), 60, 60, 400,
                                   with_dups=True), {}),
    "sorted": (lambda: random_coo(np.random.RandomState(2), 60, 60, 400),
               {"sort_rows": True}),
    "symmetric": (lambda: random_coo(np.random.RandomState(3), 50, 50, 300,
                                     symmetric=True, with_dups=True),
                  {"sort_rows": True}),
    "rectangular": (lambda: random_coo(np.random.RandomState(4), 70, 40,
                                       300), {}),
    "separate_diagonal": (lambda: random_coo(np.random.RandomState(5), 60,
                                             60, 500, with_dups=True),
                          {"separate_diagonal": True}),
    "rectangular_separate_diagonal": (
        lambda: random_coo(np.random.RandomState(6), 40, 70, 300),
        {"separate_diagonal": True}),
    "int64_f32": (lambda: random_coo(np.random.RandomState(7), 60, 60, 400),
                  {"index_dtype": "int64", "value_dtype": "float32",
                   "sort_rows": True}),
    "empty_rows": (lambda: random_coo(np.random.RandomState(8), 200, 30,
                                      40), {}),
}

# name -> (COO factory, sell_from_coo keywords): tests/test_torch_sell.py's
# cases (the inputs of tests/test_sell.py), drawn here without jax
SELL_CASES = {
    "power_law_tail": (lambda: power_law(3000, 8, seed=1),
                       dict(slice_rows=256, tail_cap=16, split_rows=False)),
    "power_law_split": (lambda: power_law(3000, 8, seed=1),
                        dict(slice_rows=256, tail_cap=16)),
    "dense_rows_split": (lambda: dense_rows(1024, 3, num_dense=2,
                                            dense_nnz=500, seed=3),
                         dict(slice_rows=128, tail_cap=8)),
    "dense_rows_tail": (lambda: dense_rows(1024, 3, num_dense=2,
                                           dense_nnz=500, seed=3),
                        dict(slice_rows=128, tail_cap=8, split_rows=False)),
    "uniform": (lambda: random_coo(np.random.RandomState(31), 512, 512,
                                   2000), dict(slice_rows=128, tail_cap=64)),
    "length_sort": (lambda: power_law(2000, 8, seed=6),
                    dict(slice_rows=128, tail_cap=2048, length_sort=True,
                         split_rows=False)),
    "length_sort_split": (lambda: dense_rows(4096, 4, num_dense=3,
                                             dense_nnz=2000, seed=2),
                          dict(slice_rows=256, length_sort=True)),
    "symmetric": (lambda: random_coo(np.random.RandomState(32), 200, 200,
                                     900, symmetric=True, with_dups=True),
                  dict(slice_rows=128)),
    "rectangular": (lambda: random_coo(np.random.RandomState(33), 300, 150,
                                       700), dict(slice_rows=128)),
    "f32_int64": (lambda: power_law(1000, 6, seed=5),
                  dict(slice_rows=128, value_dtype="float32",
                       index_dtype="int64")),
    "banded_trivial": (lambda: fem_mesh_2d(32), {}),
}
