#!/usr/bin/env python3
"""Time variants of the K1, K2 and K3 kernels' design choices, the stream
path's level 1 against the two launches it replaced, and K2's two forms,
on one CUDA card.

Run from the root of the repository:

    python3 scripts/kernel_variants.py [--graph500-scale 21] \
        [--rgg-scale 24] [--kernels K1,K2,K3]

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
config3 products; K3 per level of each stream matrix (level 1 as
products, the deeper levels through their maps, as the path runs them).
A change that no longer applies to the source stops the run and names the
variant. The stream matrices are config3 (power_law(1,000,000, 8)) and the
Graph500 Kronecker graph of the benchmark's cell (``spmv_bench/
generators/kronecker.py``, its configuration's parameters at
`--graph500-scale`; 0 leaves it out).

K1's layouts are timed in turns on the matrices of the benchmark's
ELLPACK cells, made by their generators with their configurations'
parameters (seed 1): NPB CG's class C matrix, and the random geometric
graph at `--rgg-scale` (0 leaves it out). Each is timed in the padded
layout (every row as wide as the longest) and in the sliced layout (the
shipped kernel and each K1 variant), held bit for bit against the padded
layout's y and each beside its own bytes' bound (``bench/traffic.py``) at
the card's peak.

Then, on each stream matrix, the whole `stream_spmv` and its level 1
against the same with level 1 as K1 over the products and K3 in place
(the two launches the products form replaced), held bit for bit and timed
in a CUDA graph, in turns.

K2's variants change the cache hints of its symmetric form. They run in
fp64 with y, as the chained multiply calls K2, on the benchmark's lynx68
matrix (``spmv_bench/generators/fem_mesh_2d.py`` with its configuration's
parameters, seed 1) and on HPCG's 27-point stencil at 128 cubed (the
cell's second level). On each, the shipped K2 in its symmetric form is then
timed in turns against its general form (the same matrix with the mark
cleared), each beside its own bytes' bound (``bench/traffic.py``) at the
card's peak.

No path of the port runs this; PERF.md records what it measured. Prints
one line per variant and precision, and the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import dataclasses
import json
import pathlib
import re
import shutil
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (the repository root, put on the path)

K1_SOURCE, K2_SOURCE, K3_SOURCE = "ell_spmv.cu", "dia_spmv.cu", "stream_sum.cu"
_SLOTS = "constexpr int kSlotBatch = 4;"
_BOUNDS = "__launch_bounds__(kThreads) ell_spmv_kernel("
_SLICED_THREADS = "constexpr int kSlicedThreads = 64;"
_SLICED_BOUNDS = "__launch_bounds__(kSlicedThreads, 16)"
_PROD_BATCH = "constexpr int kProdBatch = 4;"
_MAP_BATCH = "constexpr int kMapBatch = 8;"
_PARTS = "constexpr int kParts = 8;"
_K3_BOUNDS = "__launch_bounds__(kThreads)"
# K3 as products, the next batch's values and columns loaded only after
# this batch's adds
_OVERLAPPED = """product_batch(s0 + kProdBatch, nt, r, s_start, s_count, stream, cols,
                      lbase, live, val, col);
#pragma unroll
        for (int k = 0; k < kProdBatch; ++k) acc += mul_rn(a[k], b[k]);"""
_AFTER_ADDS = """#pragma unroll
        for (int k = 0; k < kProdBatch; ++k) acc += mul_rn(a[k], b[k]);
        product_batch(s0 + kProdBatch, nt, r, s_start, s_count, stream, cols,
                      lbase, live, val, col);"""
# K3 as products with x gathered under another cache hint than the
# read-only path's
_GATHER = "b[k] = load_nc_if(live[k], x + col[k]);"
_MUL = "// A product rounded once, never contracted into the add that takes it."


def _gather_hint(hint: str):
    """The edits that gather x with ``ld.global.<hint>``."""
    loads = "".join(
        f"""__device__ __forceinline__ {v} load_hint_if(bool p, const {v}* a) {{
  {v} v = 0;
  asm("{{\\n .reg .pred q;\\n setp.ne.u32 q, %2, 0;\\n"
      " @q ld.global.{hint}.{s} %0, [%1];\\n}}"
      : "+{c}"(v)
      : "l"(a), "r"(static_cast<unsigned>(p)));
  return v;
}}
""" for v, s, c in (("double", "f64", "d"), ("float", "f32", "f")))
    return [(_MUL, loads + _MUL),
            (_GATHER, "b[k] = load_hint_if(live[k], x + col[k]);")]


#: name -> [(text, replacement)] of csrc/ell_spmv.cu; the first is the
#: shipped source.
K1_VARIANTS = {
    "slots 4 (shipped)": [],
    "slots 8": [(_SLOTS, _SLOTS.replace("4", "8"))],
    "slots 16": [(_SLOTS, _SLOTS.replace("4", "16"))],
    "padded: 4 blocks/SM": [(_BOUNDS, _BOUNDS.replace(
        "(kThreads)", "(kThreads, 4)"))],
    "sliced: 12 blocks/SM": [(_SLICED_BOUNDS, _SLICED_BOUNDS.replace(
        "16", "12"))],
    "sliced: 24 blocks/SM": [(_SLICED_BOUNDS, _SLICED_BOUNDS.replace(
        "16", "24"))],
    "sliced: no bound on blocks/SM": [(_SLICED_BOUNDS, _SLICED_BOUNDS.replace(
        ", 16", ""))],
    "sliced: 128 threads": [
        (_SLICED_THREADS, _SLICED_THREADS.replace("64", "128")),
        (_SLICED_BOUNDS, _SLICED_BOUNDS.replace("16", "8"))],
    "sliced: 256 threads": [
        (_SLICED_THREADS, _SLICED_THREADS.replace("64", "256")),
        (_SLICED_BOUNDS, _SLICED_BOUNDS.replace("16", "4"))],
}


# K2's symmetric form: the loads of the terms with offset >= 0 (at row i)
# and of those with offset < 0 (the shifted re-reads, a line's last use)
_UPPER = "kSymmetric ? __ldg(p) :"
_LOWER = "__ldg(data + static_cast<size_t>(num_diags - 1 - d) *"
_LOWER_LOOP = "#pragma unroll 4\n    for (; d < terms.lower; ++d) {"
_UPPER_LOOP = "#pragma unroll 4\n  for (; d < num_diags; ++d) {"


def _k2_hints(upper: str, lower: str):
    return [(_UPPER, _UPPER.replace("ldg", upper)),
            (_LOWER, _LOWER.replace("ldg", lower))]


#: name -> [(text, replacement)] of csrc/dia_spmv.cu; the first is the
#: shipped source.
K2_VARIANTS = {
    "both loads through the read-only path (__ldg), unroll 4 (shipped)": [],
    "re-reads evict-first (__ldcs)": _k2_hints("ldg", "ldcs"),
    "offsets >= 0 in L2 only (__ldcg)": _k2_hints("ldcg", "ldg"),
    "both in L2 only (__ldcg)": _k2_hints("ldcg", "ldcg"),
    "unroll 8": [(_LOWER_LOOP, _LOWER_LOOP.replace("4", "8")),
                 (_UPPER_LOOP, _UPPER_LOOP.replace("4", "8"))],
    "unroll 2": [(_LOWER_LOOP, _LOWER_LOOP.replace("4", "2")),
                 (_UPPER_LOOP, _UPPER_LOOP.replace("4", "2"))],
}


def _prod_batch(batch: int):
    return [(_PROD_BATCH, f"constexpr int kProdBatch = {batch};")]


#: name -> ([(text, replacement)] of csrc/stream_sum.cu, blocks per
#: subtile); the first is the shipped source. Level 1 reads products
#: (kProdBatch), the deeper levels their maps (kMapBatch).
K3_VARIANTS = {
    "products batch 4, next batch's loads before the adds, map batch 8 "
    "pipelined, 8 blocks/subtile (shipped)": ([], 8),
    "products batch 2": (_prod_batch(2), 8),
    "products batch 8": (_prod_batch(8), 8),
    "products batch 16": (_prod_batch(16), 8),
    "products batch 4, next batch's loads after the adds": (
        [(_OVERLAPPED, _AFTER_ADDS)], 8),
    "12 blocks/SM": ([(_K3_BOUNDS, "__launch_bounds__(kThreads, 12)")], 8),
    "16 blocks/SM": ([(_K3_BOUNDS, "__launch_bounds__(kThreads, 16)")], 8),
    "4 blocks/subtile": ([(_PARTS, "constexpr int kParts = 4;")], 4),
    "x gathered through L2 only (ld.global.cg)": (_gather_hint("cg"), 8),
    "x gathered without L1 allocation": (
        _gather_hint("nc.L1::no_allocate"), 8),
    "x gathered, kept last in L1": (_gather_hint("nc.L1::evict_last"), 8),
    "map batch 4": ([(_MAP_BATCH, "constexpr int kMapBatch = 4;")], 8),
    "map batch 16": ([(_MAP_BATCH, "constexpr int kMapBatch = 16;")], 8),
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


def level1_designs(sm, x):
    """name -> (the whole SpMV, level 1 alone) of level 1 as products
    (shipped) and as K1 over the products, then K3 in place (the two
    launches it replaced), on `sm`'s plan."""
    from ellspmv_tpu_torch.formats.stream import stream_spmv
    from ellspmv_tpu_torch.ops import ell_cuda, stream_sum
    plan, table = sm.ddsum, sm.ddsum.levels[0].table
    products = stream_sum.Products(sm.prod, x)
    return {
        "level 1 as products (shipped)": (
            lambda: stream_spmv(sm, x),
            lambda: stream_sum.stream_sum(table, products)),
        "K1 over the products, then K3 in place": (
            lambda: stream_sum.apply_stream_sum(
                plan, ell_cuda.ell_spmv(sm.prod, x)),
            lambda: stream_sum.stream_sum(table,
                                          ell_cuda.ell_spmv(sm.prod, x))),
    }


def stream_matrices(graph500_scale: int) -> dict:
    """name -> host COO of each stream matrix: config3, and the Graph500
    graph of the benchmark's configuration at `graph500_scale` (seed 1)."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.models.generators import power_law
    out = {"config3": power_law(*cs.CONFIG3, seed=0)}
    if graph500_scale:
        from spmv_bench.generators import kronecker
        config = json.loads((REPO / "spmv_bench" / "configs" /
                             "graph500_s21.json").read_text())
        m = kronecker.generate({**config["params"], "scale": graph500_scale},
                               1, "cuda")
        out[f"graph500 scale {graph500_scale}"] = CooMatrix(
            m.num_rows, m.num_rows, m.rows.int().cpu().numpy(),
            m.cols.int().cpu().numpy(), m.values.cpu().numpy())
    return out


def dia_matrices() -> dict:
    """name -> host COO of each symmetric DIA matrix: the lynx68 cell's
    (seed 1), and HPCG's stencil at 128 cubed."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from ellspmv_tpu_torch.models.generators import hpcg_27pt
    from spmv_bench.generators import fem_mesh_2d
    config = json.loads((REPO / "spmv_bench" / "configs" /
                         "lynx68.json").read_text())
    m = fem_mesh_2d.generate(config["params"], 1, "cuda")
    return {"lynx68": CooMatrix(m.num_rows, m.num_rows,
                               m.rows.int().cpu().numpy(),
                               m.cols.int().cpu().numpy(),
                               m.values.cpu().numpy()),
            "hpcg_27pt(128^3)": hpcg_27pt(128)}


def main() -> int:
    import torch

    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.formats.stream import (stream_from_layout,
                                                  stream_layout)
    from ellspmv_tpu_torch.models.generators import fem_mesh_2d

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--graph500-scale", type=int, default=21)
    parser.add_argument("--rgg-scale", type=int, default=24)
    parser.add_argument("--kernels", default="K1,K2,K3",
                        help="the kernels whose variants are timed")
    args = parser.parse_args()
    kernels = set(args.kernels.split(","))
    card = cs.phase_device()
    cs.phase_build()
    variants = {("K1", n): (K1_SOURCE, e) for n, e in K1_VARIANTS.items()}
    variants.update({("K2", n): (K2_SOURCE, e)
                     for n, e in K2_VARIANTS.items()})
    variants.update({("K3", n): (K3_SOURCE, e)
                     for n, (e, _) in K3_VARIANTS.items()})
    jobs = {key: job for key, job in variants.items() if key[0] in kernels}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        paths = {key: pool.submit(build_variant, key[1], *job)
                 for key, job in jobs.items()}
        libs = {key: ctypes.CDLL(str(p.result())) for key, p in paths.items()}
    cs.log(f"built {len(libs)} variants")
    if "K2" in kernels:
        time_k2(libs, dia_matrices())
    if "K1" in kernels:
        time_k1_layouts(libs, layout_matrices(args.rgg_scale))
    if not kernels & {"K1", "K3"}:
        cs.log(f"variants timed on {card}")
        return 0
    coo = fem_mesh_2d(1440)
    x64 = np.random.RandomState(1).rand(coo.num_rows)
    layouts = {label: stream_layout(pl)
               for label, pl in stream_matrices(args.graph500_scale).items()}
    for prec in ("float64", "float32"):
        ell = ell_from_coo(coo, sort_rows=True, value_dtype=prec,
                           device="cuda")
        x = torch.from_numpy(x64).cuda().to(ell.values.dtype)
        for label, layout in layouts.items():
            sm = stream_from_layout(layout, prec, "cuda")
            px = torch.from_numpy(np.random.RandomState(2).rand(
                layout.num_columns)).cuda().to(sm.values.dtype)
            if label == "config3" and "K1" in kernels:
                time_k1(libs, prec, ((ell, x), (sm.prod, px)))
            if "K3" in kernels:
                time_k3(libs, prec, label, sm, px)
                time_level1(prec, label, sm, px)
            del sm
        del ell
    cs.log(f"variants timed on {card}")
    return 0


def layout_matrices(rgg_scale: int) -> dict:
    """label -> (host COO, whether the cell's multiply adds y) of the
    ELLPACK cells' matrices: NPB CG's class C matrix (no y: ``q = A·p``)
    and the random geometric graph at `rgg_scale` (the chained multiply,
    with y), from their configurations' parameters, seed 1."""
    from ellspmv_tpu_torch.formats.coo import CooMatrix
    from spmv_bench.generators import npb_cg, rgg

    def params(name):
        return json.loads((REPO / "spmv_bench" / "configs" /
                           f"{name}.json").read_text())["params"]

    def host(m):
        return CooMatrix(m.num_rows, m.num_rows, m.rows.int().cpu().numpy(),
                         m.cols.int().cpu().numpy(), m.values.cpu().numpy())
    out = {"npb_cg_c": (host(npb_cg.generate(params("npb_cg_c"), 1,
                                             "cuda")), False)}
    if rgg_scale:
        out[f"rgg scale {rgg_scale}"] = (host(rgg.generate(
            {**params("rgg_n_2_24"), "scale": rgg_scale}, 1, "cuda")), True)
    return out


def time_k1_layouts(libs, matrices):
    """K1 on each matrix of `layout_matrices` in the padded layout and in
    the sliced layout (the layout `ell_from_coo` builds on the card; each
    of `K1_VARIANTS`), in turns, beside each layout's bytes' bound."""
    import torch

    from ellspmv_tpu_torch import config
    from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
    from ellspmv_tpu_torch.formats.ell import ell_from_coo
    from ellspmv_tpu_torch.ops import _build, ell_cuda
    peak = config.hbm_peak_bytes_per_s("cuda")
    for label in list(matrices):
        coo, with_y = matrices.pop(label)
        shipped = ell_from_coo(coo, value_dtype="float64", device="cuda")
        padded = ell_from_coo(coo, value_dtype="float64").to("cuda")
        cs.check(shipped.slices is not None and padded.slices is None,
                 f"K1 {label}: the card's ELL is not sliced")
        del coo
        rng = np.random.RandomState(4)
        x = torch.from_numpy(rng.rand(padded.num_columns)).cuda()
        y = torch.from_numpy(rng.randn(padded.num_rows)).cuda() \
            if with_y else None
        want = ell_cuda.ell_spmv(padded, x, y)
        cases = {"padded": (padded, None)}
        for name in K1_VARIANTS:
            cases[f"sliced, {name}"] = (shipped, libs["K1", name])

        def k1(name):
            mat, lib = cases[name]
            symbol, args, out = ell_cuda.kernel_call(mat, x, y)
            fn = (_build.entry(symbol, ell_cuda.SPMV_ARGTYPES)[0]
                  if lib is None else
                  entry(lib, symbol, ell_cuda.SPMV_ARGTYPES))
            err = fn(*args)
            cs.check(err == 0, f"K1 {label} {name}: launch error {err}")
            return out

        def k1_ms(name):
            cs.check(torch.equal(k1(name), want),
                     f"K1 {label}: {name} differs from the padded layout")
            return cs.graph_ms(lambda: k1(name))

        for name, ms in in_turns(cases, k1_ms).items():
            mat = cases[name][0]
            nbytes = estimate_actual_bytes(mat, with_y)
            bound = nbytes / peak * 1e3
            slots = (mat.rowsize * mat.padded_rows if mat.slices is None
                     else mat.slices.stored)
            cs.log(f"K1 {label} float64 {name}: {ms:.4f} ms, "
                   f"{nbytes / 1e9:.4f} GB, its bytes' bound {bound:.4f} ms "
                   f"({bound / ms:.1%}; CUDA graph, {mat.num_rows:,} rows, "
                   f"{slots:,} slots, {mat.num_nonzeros:,} nonzeros, "
                   f"{'narrow' if mat.lcol is not None else 'wide'} "
                   f"columns, {'with' if with_y else 'without'} y)")
        del shipped, padded, cases, want


def time_k2(libs, matrices):
    """K2's variants on each symmetric DIA (`dia_matrices`), then the
    shipped K2 in its symmetric and its general form, in turns, each beside
    its own bytes' bound at the card's peak."""
    import torch

    from ellspmv_tpu_torch import config
    from ellspmv_tpu_torch.bench.traffic import estimate_actual_bytes
    from ellspmv_tpu_torch.formats.dia import dia_from_coo
    from ellspmv_tpu_torch.ops import dia_cuda
    peak = config.hbm_peak_bytes_per_s("cuda")
    for label in list(matrices):
        sym = dia_from_coo(matrices.pop(label), device="cuda")
        cs.check(sym.symmetric, f"K2 {label}: the DIA is not symmetric")
        rng = np.random.RandomState(3)
        x = torch.from_numpy(rng.rand(sym.num_rows)).cuda()
        y = torch.from_numpy(rng.randn(sym.num_rows)).cuda()
        want = dia_cuda.dia_spmv(sym, x, y)

        def k2(name):
            symbol, args, out = dia_cuda.kernel_call(sym, x, y)
            fn = entry(libs["K2", name], symbol, dia_cuda.SPMV_ARGTYPES)
            err = fn(*args)
            cs.check(err == 0, f"K2 variant {name}: launch error {err}")
            return out

        def k2_ms(name):
            cs.check(torch.equal(k2(name), want),
                     f"K2 variant {name} differs from the shipped K2")
            return cs.graph_ms(lambda: k2(name))

        bound = estimate_actual_bytes(sym) / peak * 1e3
        for name, ms in in_turns(K2_VARIANTS, k2_ms).items():
            cs.log(f"K2 {label} float64 {name}: {ms:.4f} ms, "
                   f"{bound / ms:.1%} of its bytes' bound (CUDA graph)")
        forms = {"symmetric form": sym,
                 "general form": dataclasses.replace(sym, symmetric=False)}

        def form_ms(name):
            cs.check(torch.equal(dia_cuda.dia_spmv(forms[name], x, y), want),
                     f"K2 {label}: the {name} differs from the shipped K2")
            return cs.graph_ms(lambda: dia_cuda.dia_spmv(forms[name], x, y))

        for name, ms in in_turns(forms, form_ms).items():
            nbytes = estimate_actual_bytes(forms[name])
            least = nbytes / peak * 1e3
            cs.log(f"K2 {label} float64 {name}: {ms:.4f} ms, "
                   f"{nbytes / 1e9:.4f} GB, its bytes' bound {least:.4f} ms "
                   f"({least / ms:.1%}; CUDA graph, {sym.num_rows:,} rows, "
                   f"{sym.num_diags} diagonals)")
        del sym, forms, want


def time_k1(libs, prec, cases):
    """K1's variants on fem_mesh_2d(1440) and the config3 products."""
    import torch

    from ellspmv_tpu_torch.ops import ell_cuda
    want = [ell_cuda.ell_spmv(m, v) for m, v in cases]

    def k1(name, mat, xx):
        symbol, args, out = ell_cuda.kernel_call(mat, xx, None)
        err = entry(libs["K1", name], symbol, ell_cuda.SPMV_ARGTYPES)(*args)
        cs.check(err == 0, f"K1 variant {name}: launch error {err}")
        return out

    def k1_ms(name):
        for (mat, xx), w in zip(cases, want):
            cs.check(torch.equal(k1(name, mat, xx), w),
                     f"K1 variant {name} differs from the shipped K1")
        return [cs.graph_ms(lambda: k1(name, mat, xx)) for mat, xx in cases]

    for name, (fem, prods) in in_turns(K1_VARIANTS, k1_ms).items():
        cs.log(f"K1 {prec} {name}: fem_mesh_2d(1440) {fem:.4f} ms, "
               f"config3 products {prods:.4f} ms (CUDA graph)")


def time_k3(libs, prec, label, sm, x):
    """K3's variants on each level of `sm`'s plan as the path runs it:
    level 1 as products, the deeper levels through their maps into one
    output buffer."""
    import torch

    from ellspmv_tpu_torch.ops import stream_sum
    buffer = torch.empty(sm.ddsum.buffer_len, dtype=x.dtype, device="cuda")
    levels = []
    for lv in sm.ddsum.levels:
        out = buffer[lv.out_offset:lv.out_offset + lv.out_len]
        stream = (stream_sum.Products(sm.prod, x) if lv.src is None
                  else buffer)
        stream_sum.stream_sum(lv.table, stream, lv.src, out)
        tables = {p: stream_sum._sum_table(lv.buckets, p).to("cuda")
                  for p in {p for _, p in K3_VARIANTS.values()}}
        levels.append((tables, stream, lv.src, out))

    def k3(name, table, stream, src):
        symbol, args, out = stream_sum.kernel_call(table, stream, src)
        fn = entry(libs["K3", name], symbol,
                   stream_sum.SUM_ARGTYPES[symbol.rsplit("_", 1)[0]])
        err = fn(*args)
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
        cs.log(f"K3 {label} {prec} {name}: levels "
               f"{', '.join(f'{ms:.4f}' for ms in row)} ms, per SpMV "
               f"{sum(row):.4f} ms (CUDA graph)")


def time_level1(prec, label, sm, x):
    """The whole `stream_spmv` and its level 1, as products and as the two
    launches they replaced, in turns."""
    import torch

    designs = level1_designs(sm, x)
    want = [f() for f in next(iter(designs.values()))]

    def design_ms(name):
        for f, w in zip(designs[name], want):
            cs.check(torch.equal(f(), w), f"{label}: {name} differs from "
                                          "the shipped stream_spmv")
        return [cs.graph_ms(f) for f in designs[name]]

    table = sm.ddsum.levels[0].table
    for name, (whole, level1) in in_turns(designs, design_ms).items():
        cs.log(f"stream_spmv {label} {prec} {name}: {whole:.4f} ms per "
               f"SpMV, level 1 {level1:.4f} ms (CUDA graph; "
               f"{sm.ddsum.in_positions:,} positions, "
               f"{int(table.run_start.shape[0]):,} runs, "
               f"{'narrow' if sm.prod.lcol is not None else 'int32'} "
               "columns)")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except cs.SmokeFailure as e:
        print(f"kernel_variants: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
