#!/usr/bin/env python3
"""Time variants of the K1 and K3 kernels' design choices, and the stream
path's designs, on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 scripts/kernel_variants.py

Each kernel variant is a copy of one source of ``ellspmv_tpu_torch/csrc/``
(with the headers beside it) in which one choice of the shipped source is
changed: a constant, a launch bound, the loop over the grid, the
predicated loads. It is built like the package's library
(``ellspmv_tpu_torch/ops/_build.build``, all variants at once) into
``build/kernel_variants/<name>/`` and loaded beside the package's own. Its
kernel is called through its C entry point with the arguments the wrapper
passes (``ell_cuda.kernel_call``, ``stream_sum.kernel_call``), held bit for
bit against the shipped kernel, and timed in a CUDA graph, in turns (each
variant, then again in reverse order): K1 at fem_mesh_2d(1440) and on the
config3 products, K3 per level of config3 (level 1 in place, the deeper
levels through their maps, as the path runs them). A change that no longer
applies to the source stops the run and names the variant.

Then the stream path's three designs at config3, each held bit for bit
against the shipped one and timed per SpMV in a CUDA graph, in turns, with
K1's part alone beside: the products in level 1's position order (K3 in
place on level 1, through its map on the deeper levels, one output buffer,
one gather: shipped); the products in column order with level 1 too read
through its map; and the products in column order with a gather per level
into position order, the levels' row sums concatenated, and one gather.

No path of the port runs this; PERF.md records what it measured. Prints
one line per variant and precision, and the card's name and power limit
first.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import pathlib
import re
import shutil
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the repository root, put on the path)

K1_SOURCE, K3_SOURCE = "ell_spmv.cu", "stream_sum.cu"
_SLOTS = "constexpr int kSlotBatch = 4;"
_BOUNDS = "__launch_bounds__(kThreads) ell_spmv_kernel("
# K1 over a grid of 132 SMs x 8 blocks, each striding over the rows
_ONE_PAIR = """const int64_t i =
      (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 2;
  if (i >= num_rows) return;"""
_STRIDING = """for (int64_t i =
           (static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x) * 2;
       i < num_rows; i += static_cast<int64_t>(gridDim.x) * kBlockRows) {"""
_LAST_STORE = "if (second) store(y_out + i + 1, acc1); }"
_GRID = "const auto grid = static_cast<unsigned>(blocks);"
_SM_GRID = ("const auto grid = static_cast<unsigned>(blocks < 132 * 8 ? "
            "blocks : 132 * 8);")
_BATCH = "constexpr int kBatch = sizeof(V) == 8 ? 8 : 4;"
_MAP_BATCH = "constexpr int kMapBatch = 8;"
_PARTS = "constexpr int kParts = 8;"
# K3 through a map as first written: a batch's map loads, then its values
_PIPELINED = """map_batch(0, nt, r, s_start, s_count, src, live, from);
      for (int s0 = 0; s0 < nt; s0 += kMapBatch) {
        V v[kMapBatch];
#pragma unroll
        for (int k = 0; k < kMapBatch; ++k)
          v[k] = load_nc_if(live[k], stream + from[k]);
        map_batch(s0 + kMapBatch, nt, r, s_start, s_count, src, live, from);"""
_TWO_TRIPS = """for (int s0 = 0; s0 < nt; s0 += kMapBatch) {
        map_batch(s0, nt, r, s_start, s_count, src, live, from);
        V v[kMapBatch];
#pragma unroll
        for (int k = 0; k < kMapBatch; ++k)
          v[k] = load_nc_if(live[k], stream + from[k]);"""
#: name -> [(text, replacement)] of csrc/ell_spmv.cu; the first is the
#: shipped source.
K1_VARIANTS = {
    "slots 4 (shipped)": [],
    "slots 8": [(_SLOTS, _SLOTS.replace("4", "8"))],
    "slots 16": [(_SLOTS, _SLOTS.replace("4", "16"))],
    "slots 4, 4 blocks/SM": [(_BOUNDS, _BOUNDS.replace(
        "(kThreads)", "(kThreads, 4)"))],
    "slots 4, grid of 132 SMs x 8 blocks": [
        (_ONE_PAIR, _STRIDING), (_LAST_STORE, _LAST_STORE + " }"),
        (_GRID, _SM_GRID)],
}


def _k3(batch: int, parts: int):
    return [(_BATCH, f"constexpr int kBatch = {batch};"),
            (_PARTS, f"constexpr int kParts = {parts};")], parts


#: name -> ([(text, replacement)] of csrc/stream_sum.cu, blocks per
#: subtile); the first is the shipped source. Level 1 reads the stream in
#: place (kBatch), the deeper levels through their maps (kMapBatch).
K3_VARIANTS = {
    "batch 8 fp64 / 4 f32, map batch 8 pipelined, 8 blocks/subtile "
    "(shipped)": ([], 8),
    "batch 4, 8 blocks/subtile": _k3(4, 8),
    "batch 8, 8 blocks/subtile": _k3(8, 8),
    "batch 16, 8 blocks/subtile": _k3(16, 8),
    "batch 8, 4 blocks/subtile": _k3(8, 4),
    "map batch 4": ([(_MAP_BATCH, "constexpr int kMapBatch = 4;")], 8),
    "map batch 16": ([(_MAP_BATCH, "constexpr int kMapBatch = 16;")], 8),
    "map batch 8, its map then its values (two trips a batch)": (
        [(_PIPELINED, _TWO_TRIPS)], 8),
    "map batch 16, two trips a batch": (
        [(_MAP_BATCH, "constexpr int kMapBatch = 16;"),
         (_PIPELINED, _TWO_TRIPS)], 8),
}


def edit(text: str, old: str, new: str, variant: str) -> str:
    """`text` with the one place that reads `old`, whatever its spacing and
    line breaks, replaced by `new`."""
    pattern = r"\s+".join(re.escape(word) for word in old.split())
    found = list(re.finditer(pattern, text))
    if len(found) != 1:
        raise RuntimeError(f"variant {variant!r}: {old!r} occurs "
                           f"{len(found)} times in the source, not once")
    return text[:found[0].start()] + new + text[found[0].end():]


def build_variant(name: str, source: str, edits) -> ctypes.CDLL:
    """Build the variant's copy of `source` and the headers into its own
    directory under build/kernel_variants/ and load it."""
    from ellspmv_tpu_torch.ops import _build
    root = _build.BUILD_DIR.parent / "kernel_variants" / re.sub(
        r"\W+", "_", name)
    shutil.rmtree(root, ignore_errors=True)
    (root / "csrc").mkdir(parents=True)
    for header in _build.CSRC_DIR.glob("*.cuh"):
        shutil.copy(header, root / "csrc" / header.name)
    text = (_build.CSRC_DIR / source).read_text()
    for old, new in edits:
        text = edit(text, old, new, name)
    (root / "csrc" / source).write_text(text)
    return _build.build(root / "csrc", root / "build")


def entry(lib: ctypes.CDLL, symbol: str, argtypes) -> ctypes._CFuncPtr:
    fn = getattr(lib, symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def in_turns(names, measure) -> dict:
    """measure(name) for each name, then again in reverse order; the
    means."""
    got = {}
    for name in list(names) + list(reversed(list(names))):
        got.setdefault(name, []).append(measure(name))
    return {n: np.mean(np.asarray(v), axis=0) for n, v in got.items()}


def stream_designs(sm, coo, prec):
    """name -> (the whole SpMV, K1's part alone) of each design, on `sm`'s
    plan; the first is the shipped `stream_spmv`."""
    import torch

    from ellspmv_tpu_torch.formats.stream import (column_order_products,
                                                  stream_spmv)
    from ellspmv_tpu_torch.ops import ell_cuda, permute, stream_sum
    plan = sm.ddsum
    col = column_order_products(coo, value_dtype=prec, device="cuda")
    maps = [torch.from_numpy(stream_sum.position_map(lv)).cuda()
            for lv in plan.levels]
    final = torch.from_numpy(stream_sum.final_map(plan)).cuda()

    def level1_through_map(x):
        v = ell_cuda.ell_spmv(col, x)
        buffer = torch.empty(plan.buffer_len, dtype=v.dtype, device="cuda")
        for lv, src in zip(plan.levels, maps):
            out = buffer[lv.out_offset:lv.out_offset + lv.out_len]
            if lv.src is None:
                stream_sum.stream_sum(lv.table, v, src, out)
            else:
                stream_sum.stream_sum(lv.table, buffer, lv.src, out)
        return permute.apply_permute(plan.final_src, buffer)

    def gather_per_level(x):
        v, parts = ell_cuda.ell_spmv(col, x), []
        for lv, src in zip(plan.levels, maps):
            out = stream_sum.stream_sum(lv.table,
                                        permute.apply_permute(src, v))
            parts.append(out[lv.multi_len:])
            v = out[:lv.multi_len]
        return permute.apply_permute(final, torch.cat(parts))

    return {
        "products in position order (shipped)": (
            lambda x: stream_spmv(sm, x),
            lambda x: ell_cuda.ell_spmv(sm.prod, x)),
        "products in column order, level 1 read through its map": (
            level1_through_map, lambda x: ell_cuda.ell_spmv(col, x)),
        "products in column order, a gather per level": (
            gather_per_level, lambda x: ell_cuda.ell_spmv(col, x)),
    }


def main() -> int:
    import torch

    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.formats.stream import stream_from_coo
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d, power_law
    from ellspmv_tpu_torch.ops import ell_cuda, stream_sum

    card = cs.phase_device()
    cs.phase_build()
    jobs = {**{("K1", n): (K1_SOURCE, e) for n, e in K1_VARIANTS.items()},
            **{("K3", n): (K3_SOURCE, e)
               for n, (e, _) in K3_VARIANTS.items()}}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        paths = {key: pool.submit(build_variant, key[1], *job)
                 for key, job in jobs.items()}
        libs = {key: ctypes.CDLL(str(p.result())) for key, p in paths.items()}
    cs.log(f"built {len(libs)} variants")
    coo = fem_mesh_2d(1440)
    x64 = np.random.RandomState(1).rand(coo.num_rows)
    pl = power_law(*cs.CONFIG3, seed=0)
    px64 = np.random.RandomState(2).rand(pl.num_columns)
    for prec in ("float64", "float32"):
        ell = ell_from_coo(coo, sort_rows=True, value_dtype=prec,
                           device="cuda")
        x = torch.from_numpy(x64).cuda().to(ell.values.dtype)
        sm = stream_from_coo(pl, value_dtype=prec, device="cuda")
        px = torch.from_numpy(px64).cuda().to(sm.values.dtype)
        k1_cases = ((ell, x), (sm.prod, px))
        k1_want = [ell_cuda.ell_spmv(m, v) for m, v in k1_cases]
        # each level as the path runs it: (its tables by blocks per
        # subtile, stream, map, the shipped sums), the outputs in one buffer
        buffer = torch.empty(sm.ddsum.buffer_len, dtype=px.dtype,
                             device="cuda")
        levels = []
        for lv in sm.ddsum.levels:
            out = buffer[lv.out_offset:lv.out_offset + lv.out_len]
            stream = k1_want[1] if lv.src is None else buffer
            stream_sum.stream_sum(lv.table, stream, lv.src, out)
            tables = {p: stream_sum._sum_table(lv.buckets, p).to("cuda")
                      for p in {p for _, p in K3_VARIANTS.values()}}
            levels.append((tables, stream, lv.src, out))

        def k1(name, mat, xx):
            symbol, args, out = ell_cuda.kernel_call(mat, xx, None)
            err = entry(libs["K1", name], symbol,
                        ell_cuda.SPMV_ARGTYPES)(*args)
            cs.check(err == 0, f"K1 variant {name}: launch error {err}")
            return out

        def k1_ms(name):
            for (mat, xx), want in zip(k1_cases, k1_want):
                cs.check(torch.equal(k1(name, mat, xx), want),
                         f"K1 variant {name} differs from the shipped K1")
            return [cs.graph_ms(lambda: k1(name, mat, xx))
                    for mat, xx in k1_cases]

        for name, (fem, prods) in in_turns(K1_VARIANTS, k1_ms).items():
            cs.log(f"K1 {prec} {name}: fem_mesh_2d(1440) {fem:.4f} ms, "
                   f"config3 products {prods:.4f} ms (CUDA graph)")

        def k3(name, table, stream, src):
            symbol, args, out = stream_sum.kernel_call(table, stream, src)
            argtypes = (stream_sum.SUM_ARGTYPES if src is None
                        else stream_sum.SUM_SRC_ARGTYPES)
            err = entry(libs["K3", name], symbol, argtypes)(*args)
            cs.check(err == 0, f"K3 variant {name}: launch error {err}")
            return out

        def k3_ms(name):
            parts = K3_VARIANTS[name][1]
            row = []
            for tables, stream, src, want in levels:
                t = tables[parts]
                cs.check(torch.equal(k3(name, t, stream, src), want),
                         f"K3 variant {name} differs from the shipped K3")
                row.append(cs.graph_ms(lambda: k3(name, t, stream, src)))
            return row

        for name, row in in_turns(K3_VARIANTS, k3_ms).items():
            cs.log(f"K3 {prec} {name}: levels "
                   f"{', '.join(f'{ms:.4f}' for ms in row)} ms, per SpMV "
                   f"{sum(row):.4f} ms (CUDA graph)")

        designs = stream_designs(sm, pl, prec)
        want = next(iter(designs.values()))[0](px)

        def design_ms(name):
            whole, products = designs[name]
            cs.check(torch.equal(whole(px), want),
                     f"design {name} differs from the shipped stream_spmv")
            return [cs.graph_ms(lambda: whole(px)),
                    cs.graph_ms(lambda: products(px))]

        for name, (whole, prods) in in_turns(designs, design_ms).items():
            cs.log(f"stream_spmv {prec} {name}: {whole:.4f} ms per SpMV, "
                   f"K1 over its products {prods:.4f} ms (CUDA graph)")
        del ell, sm, levels, k1_cases, k1_want, buffer, designs
    cs.log(f"variants timed on {card}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"kernel_variants: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
