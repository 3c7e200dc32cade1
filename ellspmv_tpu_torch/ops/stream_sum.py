"""Stream-sum: per-row sums of a value stream whose entry -> row map is known
when the plan is built, the reassembly half of the stream format
(``formats/stream.py``).

Counterpart of ``ellspmv_tpu.ops.stream_sum``. The plan is the JAX
package's, built by this module's own NumPy copy of its host code and held
equal to it by the tests: every entry gets a position in a row-tiled,
slot-major layout (rows sorted by descending count within tiles of 1024,
tiles bucketed by power-of-two slot count, run starts aligned to 128), rows
longer than `cap` split into sub-rows whose sums feed a further level, and
a column-chunked stream builds its first level per chunk. What the plan
drives differs:

- the Pallas segmented-sum kernel (K3), launched per bucket, becomes one
  launch per level of the hand-written CUDA kernel ``csrc/stream_sum.cu``
  (`stream_sum`), over a table that flattens the level's buckets: one CSR
  list of runs per 1024-output subtile, and the kernel's grid of `Q`
  blocks per subtile (each with the runs that reach its outputs),
  launched longest first;
- the runtime key sort (or the TPU router of ``ops/permute.py``, K4 and
  K5) that delivers each level's entries to their positions becomes a map
  composed here from the positions, ``src[keys[k]] = k``
  (`position_map`), and is applied where it costs nothing per call. Level
  1's input comes in position order: the stream format's products
  a_k*x[col_k] have static values and columns, which it lays out by this
  map once, on the host, so level 1 carries no map on the card. K3 reads
  level 1 as those products (`Products`: each value times its gathered
  x, the kernel's `prod` entry points), so they are never stored. Each
  deeper level's K3 reads its input through its map (``in[src[p]]``, the
  kernel's `src` entry points);
- every level's outputs go to one buffer, back to back (level i's at
  ``out_offset``), so a deeper level's map points into the buffer and the
  terminal outputs need no concatenation;
- the final n-sized key sort becomes one gather from that buffer by
  ``final_src`` (``ops/permute.apply_permute``, K4's kernel).

Before it ships a map, the plan checks that every position a run reads
has a source and every source is read (`_check_sources`), so that K3
never reads a position that holds nothing.

Not ported: ``build_stream_sum_uniform`` (the SPMD plan of the sharded
stream: each rank of ``parallel/stream.py`` builds its own plan), the
router builds of ``_attach_perms``,
the cells layout's position hash (``scramble``), and the
``ELLSPMV_TPU_SKIP_FINAL`` ablation.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ellspmv_tpu_torch.formats.ell import LBLOCK, EllMatrix
from ellspmv_tpu_torch.io import native
from ellspmv_tpu_torch.ops import _build, ell_cuda
from ellspmv_tpu_torch.ops.ell_cuda import check_tensors
from ellspmv_tpu_torch.ops.permute import (BLOCK, apply_permute,
                                           gather_from_targets)
from ellspmv_tpu_torch.utils.timing import span

#: Kernel launches made by `stream_sum` in this process: of the entry points
#: that read the stream in place (`launches`), of those that read it
#: through a map (`src_launches`) and of those that read it as products
#: (`product_launches`).
launches = 0
src_launches = 0
product_launches = 0

_I32_SENTINEL = np.int32(np.iinfo(np.int32).max)   # a key with no position
G = 8                # 128-row groups per tile (R = G*128 = 1024)
R = G * 128

Q = 8                # kernel blocks per subtile, of R // Q outputs each
#: The argument types of the K3 entry points of ``csrc/stream_sum.cu``, by
#: the name before the type: ``stream_sum_<type>``, with the map
#: ``stream_sum_src_<type>``, and as products ``stream_sum_prod_<type>``.
SUM_ARGTYPES = {
    kind: (ctypes.c_void_p,) * pointers + (ctypes.c_int64, ctypes.c_void_p)
    for kind, pointers in (("stream_sum", 7), ("stream_sum_src", 8),
                           ("stream_sum_prod", 10))}

_VALUE_TAGS = {torch.float64: "f64", torch.float32: "f32"}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _pow2ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


@dataclasses.dataclass
class Products:
    """Level 1's input as the products it sums: position p is
    ``ell.values[0, p] * x[col(p)]``, the product rounded once, with col(p)
    the rowsize-1 ELL's column (``ell.columns()``: `colidx`, or
    ``lbase[p // LBLOCK] + lcol`` in the narrow layout). The stream format's
    products in level 1's position order (``formats/stream.py``) and its x,
    in their type."""
    ell: EllMatrix
    x: torch.Tensor

    @property
    def dtype(self) -> torch.dtype:
        return self.ell.values.dtype

    @property
    def device(self) -> torch.device:
        return self.ell.values.device

    @property
    def positions(self) -> int:
        return self.ell.padded_rows


# --------------------------------------------------------------------------
# Plan
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SumBucket:
    """One bucket of the JAX plan (kept on the host for the tests)."""
    estart: np.ndarray     # (T,) int32 window base row per step
    oc: np.ndarray         # (T, 2, sub*S) int32 [run start; count]
    S: int
    K: int
    T: int
    sub: int = 1           # tiles folded per step (_fold_buckets)


@dataclasses.dataclass
class SumTable:
    """The kernel's table of one level: subtile u's runs are
    ``slot_ptr[u] .. slot_ptr[u+1]`` of `run_start` (absolute stream
    positions) and `run_count`; its outputs are ``u*1024 .. u*1024+1023``.
    Runs of count 0 are left out. The kernel's grid of Q blocks per
    subtile: the block at launch position b sums outputs
    ``(j % Q) * R/Q ..`` of subtile ``j // Q``, j =
    ``order[b]``, over runs ``block_first[b] ..`` + ``block_runs[b]``, the
    subtile's first runs through the last whose count reaches those
    outputs; the positions go by live elements, descending (longest
    first)."""
    slot_ptr: torch.Tensor     # (U+1,) int32
    run_start: torch.Tensor    # (runs,) int32
    run_count: torch.Tensor    # (runs,) int32
    max_slots: int             # most runs of any subtile
    order: torch.Tensor        # (Q*U,) int32, a permutation of the blocks
    block_first: torch.Tensor  # (Q*U,) int32, by launch position
    block_runs: torch.Tensor   # (Q*U,) int32, by launch position

    @property
    def num_subtiles(self) -> int:
        return int(self.slot_ptr.shape[0]) - 1

    def to(self, device) -> "SumTable":
        return dataclasses.replace(
            self, slot_ptr=self.slot_ptr.to(device),
            run_start=self.run_start.to(device),
            run_count=self.run_count.to(device),
            order=self.order.to(device),
            block_first=self.block_first.to(device),
            block_runs=self.block_runs.to(device))


@dataclasses.dataclass
class SumLevel:
    keys: np.ndarray        # (>= in_len,) int32 position of each entry, then
                            # the alignment-gap positions (JAX's sort keys)
    tkeys: np.ndarray       # (out_len - multi_len,) int32 final row per
                            # terminal output position
    buckets: list           # list[SumBucket]
    in_rows: int            # stream rows of 128 the level reads
    out_len: int
    multi_len: int          # split rows' outputs: the next level's input
    in_len: int = 0         # entries in the level's input
    # (in_rows*128,) int32: each position's source in the plan's output
    # buffer, -1 at the gaps; None for level 1 (delivered in position order)
    src: torch.Tensor | None = None
    table: SumTable | None = None
    out_offset: int = 0     # where the level's outputs start in the buffer

    def to(self, device) -> "SumLevel":
        return dataclasses.replace(
            self, src=None if self.src is None else self.src.to(device),
            table=self.table.to(device))


@dataclasses.dataclass
class StreamSumPlan:
    levels: list                 # list[SumLevel]
    final_keys: np.ndarray       # concat of the levels' tkeys (int32 rows)
    num_rows: int
    # column-chunked level 1: each chunk's BLOCK-aligned stream base, C+1
    # cumulative entries; () when unchunked
    chunk_bases: tuple = ()
    # (num_rows,) int32: each row's sum in the output buffer, -1 for none
    final_src: torch.Tensor | None = None
    buffer_len: int = 0          # every level's outputs, back to back

    @property
    def in_positions(self) -> int:
        """The length of level 1's input in position order."""
        return self.levels[0].in_rows * 128

    def to(self, device) -> "StreamSumPlan":
        return dataclasses.replace(
            self, levels=[lv.to(device) for lv in self.levels],
            final_src=self.final_src.to(device))


def _build_level(dest: np.ndarray, n_rows: int, cap: int,
                 include_empty_rows: bool,
                 force_multi: np.ndarray | None = None,
                 empty_terminal: np.ndarray | None = None):
    """One sum level, as ``ellspmv_tpu.ops.stream_sum._build_level`` builds
    it without its SPMD and cells options. `dest` maps each input position
    to a row (-1 = pad).

    Rows with <= cap entries complete here: their sums land in the
    single-group SUFFIX of the output, `tkeys` naming the row. Rows with
    more split into sub-rows whose sums land in the multi-group PREFIX
    [0, multi_len); `out_dest` (length multi_len) maps those positions to
    parent rows for the next level. `include_empty_rows` gives 0-entry rows
    a terminal zero (level 1 only). For a column chunk of level 1,
    `force_multi` (bool per row) marks rows with entries in other chunks,
    whose partial sums must feed the merge level, and `empty_terminal`
    (bool per row) names the count-0 rows owed a terminal zero by this
    chunk. Returns (level, out_dest or None, the aligned stream's top)."""
    E = len(dest)
    valid = dest >= 0
    vpos = np.flatnonzero(valid)
    idt = np.int32 if max(E, n_rows) < 2**31 else np.int64
    rows_v = dest[vpos].astype(idt, copy=False)
    counts = np.bincount(rows_v, minlength=n_rows).astype(np.int64,
                                                          copy=False)

    # rank of each entry within its row, by position order (stable)
    order = native.argsort(rows_v)
    starts = np.concatenate([[0], np.cumsum(counts)]).astype(idt)
    rank_sorted = np.arange(len(vpos), dtype=idt) - starts[rows_v[order]]
    rank = np.empty(len(vpos), idt)
    rank[order] = rank_sorted

    # split rows longer than cap into sub-rows of <= cap entries
    nsub = np.maximum(-(-counts // cap), 1)
    if empty_terminal is not None:
        nsub[(counts == 0) & ~empty_terminal] = 0
    elif not include_empty_rows:
        nsub[counts == 0] = 0
    sub_base = np.concatenate([[0], np.cumsum(nsub)])
    n_vrows = int(sub_base[-1])
    vrow = (sub_base[rows_v] + rank // cap).astype(idt)
    vrank = rank % cap
    vcounts = np.full(n_vrows, cap, np.int64)
    has = nsub > 0
    last = (sub_base[:-1] + nsub - 1)[has]
    vcounts[last] = (counts - (nsub - 1) * cap)[has]  # 0 for empty rows
    parent = np.repeat(np.arange(n_rows, dtype=np.int64), nsub)

    # sigma order: split ("multi") rows' sub-rows first, then completed
    # ("single") rows, each group padded to whole tiles, so that counts
    # descend within a tile and the multi group is a prefix of the output
    vrow_multi = (counts > cap)[parent]
    if force_multi is not None:
        vrow_multi |= force_multi[parent]
    sigperm = np.lexsort((-vcounts, np.where(vrow_multi, 0, 1)))
    n_multi_v = int(vrow_multi.sum())
    n_multi_pad = _round_up(n_multi_v, R) if n_multi_v else 0
    n_single_v = n_vrows - n_multi_v
    n_sig = n_multi_pad + _round_up(n_single_v, R)
    n_sig = max(n_sig, R)
    sig_pos_of_rank = np.arange(n_vrows)
    sig_pos_of_rank = np.where(sig_pos_of_rank < n_multi_v,
                               sig_pos_of_rank,
                               n_multi_pad + sig_pos_of_rank - n_multi_v)
    sig_of = np.empty(n_vrows, idt)
    sig_of[sigperm] = sig_pos_of_rank
    T_all = n_sig // R
    T0 = n_multi_pad // R                            # multi-group tiles
    counts_sig = np.zeros(n_sig, np.int64)
    counts_sig[sig_of] = vcounts
    vrow_at_sig = np.full(n_sig, -1, np.int64)
    vrow_at_sig[sig_of] = np.arange(n_vrows)
    S_tile = counts_sig.reshape(T_all, R)[:, 0]      # descending => max
    S_bucket_of = np.array([_pow2ceil(max(int(s), 1)) for s in S_tile])

    # concat order: multi tiles first, bucket-major within each group
    ct_of_tile = np.empty(T_all, np.int64)
    pos = 0
    bucket_list = []                                 # [(S, tiles, T_b)]
    for g_tiles in (np.arange(T0), np.arange(T0, T_all)):
        for S in sorted(set(int(b) for b in S_bucket_of[g_tiles])):
            tl = g_tiles[S_bucket_of[g_tiles] == S]
            ct_of_tile[tl] = pos + np.arange(len(tl))
            pos += len(tl)
            bucket_list.append((S, tl, len(tl)))
    T_concat = pos

    # per-(tile, slot) counts via a per-tile count histogram (counts descend
    # within a tile, so slot s's lanes are the prefix [0, c))
    capp = int(S_bucket_of.max())
    H = np.zeros((T_all, capp + 2), np.int64)
    tile_of_sig = np.arange(n_sig) // R
    real_sig = vrow_at_sig >= 0
    np.add.at(H, (tile_of_sig[real_sig],
                  np.clip(counts_sig[real_sig], 0, capp + 1)), 1)
    suffix = H[:, ::-1].cumsum(axis=1)[:, ::-1]      # suffix[t,v] = #(>= v)

    # aligned run starts: exclusive cumsum of ceil(c/128)*128 in concat
    # (group, bucket, tile, slot) order
    buckets = []
    align_base = 0
    n_real = 0
    per_bucket_runs = []
    start_of = np.zeros((T_all, capp), np.int64)      # tile, slot -> start
    for S, tl, T_b in bucket_list:
        c = np.zeros((T_b, S), np.int64)
        if len(tl):
            c[:len(tl)] = suffix[tl][:, 1:S + 1]     # (T_b, S): #(> s)
        ca = -(-c // 128) * 128                      # aligned run sizes
        o = align_base + np.concatenate(
            [[0], np.cumsum(ca.ravel())[:-1]]).reshape(T_b, S)
        align_base += int(ca.sum())
        n_real += int(c.sum())
        if len(tl):
            start_of[tl, :S] = o[:len(tl)]
        per_bucket_runs.append((S, tl, T_b, o, c, ca))
    assert n_real == len(vpos)
    stream_top = align_base

    if stream_top + 1 >= np.iinfo(np.int32).max:
        raise ValueError("stream-sum aligned position space exceeds int32")

    # each entry's position: its run's start plus its lane (rows within a
    # tile are sorted by descending count, so run (t, s) holds exactly the
    # lanes [0, c_ts))
    keys = np.full(E, _I32_SENTINEL, np.int32)
    tg = sig_of[vrow] // R
    lane = sig_of[vrow] % R
    keys[vpos] = (start_of[tg, vrank] + lane).astype(np.int32)

    # the alignment-gap positions, after the entries (the JAX sort path
    # needs them; the gather leaves them at -1)
    gap_parts = []
    for S, tl, T_b, o, c, ca in per_bucket_runs:
        cr, car, orr = c.ravel(), ca.ravel(), o.ravel()
        part = car > cr
        if part.any():
            lens = (car - cr)[part]
            starts_g = (orr + cr)[part]
            idx = np.arange(int(lens.sum()), dtype=np.int64) - np.repeat(
                np.cumsum(lens) - lens, lens)
            gap_parts.append((np.repeat(starts_g, lens) + idx))
    gaps = (np.concatenate(gap_parts).astype(np.int32) if gap_parts
            else np.zeros(0, np.int32))
    keys = np.concatenate([keys, gaps])

    # per-bucket metadata (the TPU kernel's window base row and height)
    in_rows_needed = _round_up(max(len(keys), 1), 128) // 128
    for S, tl, T_b, o, c, ca in per_bucket_runs:
        end = o[:, -1] + ca[:, -1]                   # aligned run end
        wrow = np.maximum((o[:, 0] >> 7) & ~7, 0)
        K = int(np.max(-(-(end - wrow * 128) // 128) + G + 2))
        K = _round_up(max(K, 8), 8)
        in_rows_needed = max(in_rows_needed, int(np.max(wrow)) + K)
        oc = np.stack([(o - wrow[:, None] * 128), c], axis=1)
        buckets.append(SumBucket(
            estart=wrow.astype(np.int32), oc=oc.astype(np.int32),
            S=S, K=K, T=T_b))

    out_len = T_concat * R
    multi_len = T0 * R

    # output position -> sigma position -> vrow
    ct_inv = np.full(T_concat, -1, np.int64)
    ct_inv[ct_of_tile] = np.arange(T_all)            # concat tile -> tile
    pos_tile = np.repeat(ct_inv, R)
    sig_pos = pos_tile * R + np.tile(np.arange(R), T_concat)
    vr = np.where(pos_tile >= 0,
                  vrow_at_sig[np.clip(sig_pos, 0, n_sig - 1)], -1)

    # terminal suffix: completed rows (or pads) -> final row keys
    vr_term = vr[multi_len:]
    tkeys = np.where(vr_term >= 0, parent[np.maximum(vr_term, 0)],
                     _I32_SENTINEL).astype(np.int32)
    level = SumLevel(keys=keys, tkeys=tkeys, buckets=buckets,
                     in_rows=in_rows_needed, out_len=out_len,
                     multi_len=multi_len, in_len=E)
    if multi_len == 0:
        return level, None, stream_top
    vr_multi = vr[:multi_len]
    out_dest = np.where(vr_multi >= 0, parent[np.maximum(vr_multi, 0)], -1)
    return level, out_dest, stream_top


def _fold_buckets(level: SumLevel, max_k: int = 1024) -> None:
    """Fold `sub` consecutive tiles of small-S buckets into one step of the
    TPU kernel (one shared window), as the JAX plan does; tail tiles
    (T % sub) become a second sub=1 bucket. The raveled output order is
    unchanged. The port's kernel does not need the folding (its table
    lists every subtile's runs), but the plan stays JAX's, field for
    field."""
    new = []
    for b in level.buckets:
        sub = next((cand for cand in (16, 8, 4, 2)
                    if b.S * cand <= 32 and b.T >= 2 * cand), 1)
        if sub == 1 or b.sub != 1:
            new.append(b)
            continue
        T_s = b.T // sub
        main_T = T_s * sub
        es = np.asarray(b.estart, np.int64)
        oc = np.asarray(b.oc, np.int64)
        es_g = es[:main_T].reshape(T_s, sub)
        base = es_g[:, 0]                    # run starts ascend in-bucket
        K_s = _round_up(int(((es_g - base[:, None]).max(axis=1)
                             + b.K).max()), 8)
        if K_s > max_k:
            new.append(b)
            continue
        level.in_rows = max(level.in_rows, int(base.max()) + K_s)
        oc_g = oc[:main_T].reshape(T_s, sub, 2, b.S).copy()
        oc_g[:, :, 0, :] += (es_g - base[:, None])[:, :, None] * 128
        oc_s = np.ascontiguousarray(
            oc_g.transpose(0, 2, 1, 3)).reshape(T_s, 2, sub * b.S)
        new.append(SumBucket(estart=base.astype(np.int32),
                             oc=oc_s.astype(np.int32),
                             S=b.S, K=K_s, T=T_s, sub=sub))
        if b.T > main_T:
            new.append(SumBucket(estart=es[main_T:].astype(np.int32),
                                 oc=oc[main_T:].astype(np.int32),
                                 S=b.S, K=b.K, T=b.T - main_T))
    level.buckets = new


def _splice_chunk_levels(parts):
    """Merge per-chunk level-1 builds into ONE SumLevel over a global stream
    whose chunk regions are consecutive BLOCK-aligned slices.

    `parts` is a chunk-ordered list of (level, out_dest, stream_top,
    seg_len); level is None for a chunk with no entries and no owed
    terminals. Output tiles are regrouped (multi buckets first, then single,
    S ascending, chunks interleaved within equal S) so that same-S buckets
    of all chunks merge into one bucket. Returns (level, out_dest_global or
    None, chunk_bases)."""
    bases, pos = [], 0
    for (lv, od, top, seg_len) in parts:
        bases.append(pos)
        if lv is not None:
            pos += _round_up(max(int(top), 1), BLOCK)
    bases.append(pos)
    if pos + 1 >= np.iinfo(np.int32).max:
        raise ValueError("chunked stream position space exceeds int32")

    key_parts, gap_parts = [], []
    tiles = []          # (group, S, chunk, estart_glob, oc, K, seg)
    in_rows_glob = _round_up(max(pos, 128), 128) // 128
    for ci, (lv, od, top, seg_len) in enumerate(parts):
        if lv is None:
            key_parts.append(np.full(seg_len, _I32_SENTINEL, np.int32))
            continue
        base = bases[ci]
        base_rows = base // 128
        k = np.asarray(lv.keys)
        ent = k[:lv.in_len]
        key_parts.append(np.where(
            ent == _I32_SENTINEL, np.int32(_I32_SENTINEL),
            (ent.astype(np.int64) + base).astype(np.int32)))
        # gap positions: the level's own aligned-run pad, plus the
        # inter-chunk BLOCK pad [top, base_next)
        g = k[lv.in_len:].astype(np.int64) + base
        top_i = max(int(top), 1)
        inter = np.arange(base + top_i, bases[ci + 1], dtype=np.int64)
        gap_parts.append(np.concatenate([g, inter]).astype(np.int32))
        in_rows_glob = max(in_rows_glob, base_rows + lv.in_rows)
        off = 0
        tk = np.asarray(lv.tkeys)
        for b in lv.buckets:
            assert b.sub == 1, "splice happens before folding"
            span = b.T * R
            is_multi = off < lv.multi_len
            est = (np.asarray(b.estart, np.int64)
                   + base_rows).astype(np.int32)
            seg = (od[off:off + span] if is_multi
                   else tk[off - lv.multi_len:off - lv.multi_len + span])
            tiles.append((0 if is_multi else 1, b.S, ci, est,
                          np.asarray(b.oc), b.K, seg))
            off += span

    tiles.sort(key=lambda t: (t[0], t[1], t[2]))
    buckets, od_parts, tk_parts = [], [], []
    multi_tiles = 0
    i = 0
    while i < len(tiles):
        j = i
        while (j < len(tiles) and tiles[j][0] == tiles[i][0]
               and tiles[j][1] == tiles[i][1]):
            j += 1
        grp = tiles[i:j]
        is_multi, S = grp[0][0], grp[0][1]
        # pad each chunk's tile segment to a multiple of the fold factor,
        # so that no folded group straddles a chunk boundary; pad tiles
        # emit zero-count runs with -1/sentinel destinations
        fold = next((c for c in (16, 8, 4, 2) if S * c <= 32), 1)
        est_parts, oc_parts, seg_parts = [], [], []
        for ti, t in enumerate(grp):
            est_c, oc_c, seg_c = t[3], t[4], t[6]
            T_c = len(est_c)
            if fold > 1 and ti + 1 < len(grp) and T_c % fold:
                n_pad = fold - T_c % fold
                est_c = np.concatenate(
                    [est_c, np.full(n_pad, est_c[-1], est_c.dtype)])
                oc_c = np.concatenate(
                    [oc_c, np.zeros((n_pad,) + oc_c.shape[1:],
                                    oc_c.dtype)])
                fill = np.int64(-1) if is_multi == 0 else _I32_SENTINEL
                seg_c = np.concatenate(
                    [seg_c, np.full(n_pad * R, fill, seg_c.dtype)])
            est_parts.append(est_c)
            oc_parts.append(oc_c)
            seg_parts.append(seg_c)
        est = np.concatenate(est_parts)
        oc = np.concatenate(oc_parts).astype(np.int32)
        K = max(t[5] for t in grp)
        buckets.append(SumBucket(estart=est, oc=oc, S=S, K=K, T=len(est)))
        in_rows_glob = max(in_rows_glob, int(est.max()) + K)
        if is_multi == 0:
            multi_tiles += len(est)
            od_parts.extend(seg_parts)
        else:
            tk_parts.extend(seg_parts)
        i = j

    keys = np.concatenate(key_parts + gap_parts) if key_parts else \
        np.zeros(0, np.int32)
    in_rows_glob = max(in_rows_glob,
                       _round_up(max(len(keys), 1), 128) // 128)
    in_len = sum(seg_len for (_, _, _, seg_len) in parts)
    multi_len = multi_tiles * R
    out_len = sum(b.T for b in buckets) * R
    tkeys = (np.concatenate(tk_parts) if tk_parts
             else np.zeros(0, np.int32))
    level = SumLevel(keys=keys, tkeys=tkeys, buckets=buckets,
                     in_rows=in_rows_glob, out_len=out_len,
                     multi_len=multi_len, in_len=in_len)
    out_dest = (np.concatenate(od_parts) if od_parts else None)
    return level, out_dest, tuple(bases)


def _build_chunked_level1(dest: np.ndarray, n_rows: int, cap: int,
                          chunk_starts):
    """Per-column-chunk level-1 builds spliced into one global SumLevel.

    Each chunk's entries (a contiguous slice of `dest`) reduce into partial
    sums over their own aligned stream region. Rows touched by a single
    chunk terminate here; rows spanning chunks forward partials to the
    merge level."""
    chunk_starts = [int(s) for s in chunk_starts]
    C = len(chunk_starts) - 1
    with span("stream.chunk_counts", chunks=C):
        valid = dest >= 0
        counts_global = np.bincount(dest[valid], minlength=n_rows)
        empty_mask = counts_global == 0
        if not empty_mask.any():
            empty_mask = None

        touch = np.zeros(n_rows, np.int16)
        for c in range(C):
            seg = dest[chunk_starts[c]:chunk_starts[c + 1]]
            segv = seg[seg >= 0]
            if len(segv):
                touch += (np.bincount(segv, minlength=n_rows) > 0)
        force_multi = touch >= 2

    parts = []
    for c in range(C):
        seg = dest[chunk_starts[c]:chunk_starts[c + 1]]
        emp = empty_mask if c == 0 else None
        if not (seg >= 0).any() and emp is None:
            parts.append((None, None, 0, len(seg)))
            continue
        with span("stream.level", level=1, chunk=c):
            level, od, top = _build_level(
                seg, n_rows, cap, include_empty_rows=False,
                force_multi=force_multi, empty_terminal=emp)
        parts.append((level, od, top, len(seg)))
    with span("stream.chunk_splice"):
        return _splice_chunk_levels(parts)


def _sum_table(buckets: list, parts: int = Q) -> SumTable:
    """Flatten a level's buckets into the kernel's table: subtile j of step
    t of each bucket, in the output's order, with its runs' absolute
    starts ``estart[t]*128 + o`` and counts, runs of count 0 left out; the
    grid of `parts` blocks per subtile (`Q`, the kernel's; another count
    only for a build of variant sources)."""
    starts, counts, per_subtile = [], [], [np.zeros(0, np.int64)]
    for b in buckets:
        oc = np.asarray(b.oc, np.int64).reshape(b.T, 2, b.sub, b.S)
        base = np.asarray(b.estart, np.int64)[:, None, None] * 128
        start = (oc[:, 0] + base).reshape(-1, b.S)
        count = oc[:, 1].reshape(-1, b.S)
        live = count > 0
        starts.append(start[live])
        counts.append(count[live])
        per_subtile.append(live.sum(axis=1))
    per_subtile = np.concatenate(per_subtile)
    slot_ptr = np.concatenate([[0], np.cumsum(per_subtile)])
    count = np.concatenate([np.zeros(0, np.int64)] + counts)
    with span("stream.block_schedule"):
        order, block_first, block_runs = _block_schedule(slot_ptr, count,
                                                         parts)
    return SumTable(
        slot_ptr=torch.from_numpy(slot_ptr.astype(np.int32)),
        run_start=torch.from_numpy(
            np.concatenate([np.zeros(0, np.int64)] + starts)
            .astype(np.int32)),
        run_count=torch.from_numpy(count.astype(np.int32)),
        max_slots=int(per_subtile.max(initial=0)),
        order=torch.from_numpy(order.astype(np.int32)),
        block_first=torch.from_numpy(block_first.astype(np.int32)),
        block_runs=torch.from_numpy(block_runs.astype(np.int32)))


def _block_schedule(slot_ptr: np.ndarray, count: np.ndarray,
                    parts: int = Q):
    """The kernel's grid over a level of U subtiles, `parts` blocks each,
    block j = (subtile j // parts, outputs (j % parts) * R/parts ..):
    `order`, the blocks by live
    elements, descending (ties by index), for a longest-first launch, and
    by launch position each block's first run and run count, the
    subtile's first runs through the last whose count reaches the block's
    first output (the others add nothing there)."""
    U = len(slot_ptr) - 1
    width = R // parts
    subtile = np.repeat(np.arange(U, dtype=np.int64), np.diff(slot_ptr))
    index = np.arange(len(count), dtype=np.int64) - slot_ptr[subtile]
    runs = np.zeros(parts * U, np.int64)
    live = np.zeros(parts * U, np.int64)
    for q in range(parts):
        reach = count > q * width
        np.maximum.at(runs, subtile[reach] * parts + q, index[reach] + 1)
        live[q::parts] = np.bincount(
            subtile, weights=np.clip(count - q * width, 0, width),
            minlength=U).astype(np.int64)
    order = np.argsort(-live, kind="stable")
    return order, np.asarray(slot_ptr)[order // parts], runs[order]


def position_map(level: SumLevel) -> np.ndarray:
    """The map that delivers a level's input entries to its positions: an
    int32 array of ``in_rows * 128`` with ``src[keys[k]] = k``, and -1 at
    the positions no entry takes (the alignment gaps)."""
    keys = np.asarray(level.keys)[:level.in_len]
    target = np.where(keys == _I32_SENTINEL, np.int64(-1),
                      keys.astype(np.int64))
    return gather_from_targets(target, level.in_rows * 128, validate=False)


def final_map(plan: StreamSumPlan) -> np.ndarray:
    """The map from each row to its sum among the levels' terminal outputs
    taken in level order (``final_src[final_keys[p]] = p``), -1 for none."""
    fk = np.asarray(plan.final_keys)
    target = np.where(fk == _I32_SENTINEL, np.int64(-1), fk.astype(np.int64))
    return gather_from_targets(target, plan.num_rows, validate=False)


def _check_sources(table: SumTable, src: np.ndarray) -> None:
    """Raise unless the positions the table's runs read (``run_start + r``,
    r below the run's count) are exactly those `src` gives a source: K3
    reads no position that holds nothing, and drops no entry."""
    count = table.run_count.numpy().astype(np.int64)
    first = np.repeat(table.run_start.numpy().astype(np.int64), count)
    lane = np.arange(len(first)) - np.repeat(np.cumsum(count) - count,
                                             count)
    live = first + lane
    if len(live) and (live.max() >= len(src) or (src[live] < 0).any()):
        raise ValueError("stream-sum plan: a position that a run reads has "
                         "no source")
    if len(live) != int((src >= 0).sum()):
        raise ValueError("stream-sum plan: an entry's position lies outside "
                         "every run")


def _attach_maps(plan: StreamSumPlan) -> None:
    """Build each level's kernel table, check each level's map against it,
    place the levels' outputs in one buffer, and compose each deeper
    level's map and the final one into that buffer; all on the CPU. Spans
    ``stream.tables`` (`_sum_table`, holding ``stream.block_schedule``) and
    ``stream.check_sources``, one of each a level (`level`)."""
    offset = 0
    terminal = []       # buffer index of each terminal output, level order
    for i, lv in enumerate(plan.levels):
        with span("stream.tables", level=i + 1):
            lv.table = _sum_table(lv.buckets)
        src = position_map(lv)
        with span("stream.check_sources", level=i + 1):
            _check_sources(lv.table, src)
        if i > 0:    # input k is output k of the level before
            lv.src = torch.from_numpy(np.where(
                src >= 0, src + plan.levels[i - 1].out_offset,
                -1).astype(np.int32))
        lv.out_offset = offset
        terminal.append(np.arange(offset + lv.multi_len, offset + lv.out_len,
                                  dtype=np.int64))
        offset += lv.out_len
    if offset >= np.iinfo(np.int32).max:
        raise ValueError("stream-sum output buffer exceeds int32")
    plan.buffer_len = offset
    terminal = np.concatenate(terminal)
    fm = final_map(plan)
    plan.final_src = torch.from_numpy(np.where(
        fm >= 0, terminal[np.maximum(fm, 0)], -1).astype(np.int32))


def build_stream_sum(dest: np.ndarray, n_rows: int, cap: int = 128,
                     chunk_starts=None) -> StreamSumPlan:
    """Build the (possibly multi-level) sum plan for a value stream whose
    position k carries an addend for row `dest[k]` (-1 = padding), on the
    CPU (`StreamSumPlan.to` moves it).

    `chunk_starts` (C+1 cumulative entry boundaries; entries must be
    chunk-contiguous) builds a column-chunked level 1: per-chunk partial
    sums in per-chunk stream regions, merged by the deeper levels.

    Its steps are spans (inside the stream layout's ``stream.sum_plan``):
    a chunked level 1's ``stream.chunk_counts``, a ``stream.level`` a
    chunk (`level` 1, `chunk`) and ``stream.chunk_splice``; a
    ``stream.level`` for each further level (`level`); ``stream.fold``
    after each level (`level`); and ``stream.attach_maps``."""
    levels = []
    cur = np.asarray(dest, np.int64)
    first = True
    chunk_bases = ()
    if chunk_starts is not None and len(chunk_starts) > 2:
        level, cur, chunk_bases = _build_chunked_level1(cur, n_rows, cap,
                                                        chunk_starts)
        with span("stream.fold", level=1):
            _fold_buckets(level)
        levels.append(level)
        first = False
    while cur is not None:
        with span("stream.level", level=len(levels) + 1):
            level, cur, _ = _build_level(cur, n_rows, cap,
                                         include_empty_rows=first)
        with span("stream.fold", level=len(levels) + 1):
            _fold_buckets(level)
        levels.append(level)
        first = False
    plan = StreamSumPlan(levels=levels,
                         final_keys=np.concatenate([lv.tkeys
                                                    for lv in levels]),
                         num_rows=n_rows, chunk_bases=chunk_bases)
    with span("stream.attach_maps"):
        _attach_maps(plan)
    return plan


# --------------------------------------------------------------------------
# The segmented sums and the pipeline
# --------------------------------------------------------------------------

def stream_sum_torch(table: SumTable, stream: torch.Tensor | Products,
                     src: torch.Tensor | None = None) -> torch.Tensor:
    """The plain PyTorch version of the kernel: per subtile, its runs added
    in order into one accumulator per output, as masked gathers; each
    position p read as ``stream[p]``, as ``stream[src[p]]`` given `src`,
    or, given `Products`, as its value times its gathered x."""
    U = table.num_subtiles
    r = torch.arange(R, device=stream.device)
    first, last = table.slot_ptr[:-1].long(), table.slot_ptr[1:].long()
    n_runs = int(table.run_start.shape[0])
    if isinstance(stream, Products):
        values, cols = stream.ell.values[0], stream.ell.columns()[0].long()
    acc = torch.zeros((U, R), dtype=stream.dtype, device=stream.device)
    for s in range(table.max_slots):
        run = first + s
        live = run < last
        run = run.clamp(max=max(n_runs - 1, 0))
        count = torch.where(live, table.run_count[run].long(), 0)
        pos = table.run_start[run].long()[:, None] + r
        mask = r < count[:, None]
        pos = torch.where(mask, pos, 0)
        if src is not None:
            pos = torch.where(mask, src[pos].long(), 0)
        if isinstance(stream, Products):
            term = values[pos] * stream.x[cols[pos]]
        else:
            term = stream[pos]
        acc = acc + torch.where(mask, term, 0)
    return acc.reshape(-1)


def _products_named(prod: Products) -> list:
    """`check_tensors`' entries of the products: a rowsize-1 ELL's values
    and columns (int32, or the narrow layout's int16 offsets and int32
    bases) and x, in the values' type."""
    ell = prod.ell
    if ell.rowsize != 1:
        raise ValueError(f"stream_sum: the products are a rowsize-1 ELL, "
                         f"not of rowsize {ell.rowsize}")
    shape = (1, ell.padded_rows)
    named = [("values", ell.values, shape, prod.dtype),
             ("x", prod.x, (ell.num_columns,), prod.dtype)]
    if ell.lcol is None:
        return named + [("colidx", ell.colidx, shape, torch.int32)]
    return named + [("lcol", ell.lcol, shape, torch.int16),
                    ("lbase", ell.lbase, (-(-ell.padded_rows // LBLOCK),),
                     torch.int32)]


def _check(table: SumTable, stream, src, out):
    if stream.dtype not in _VALUE_TAGS:
        raise TypeError(f"stream_sum: unsupported stream dtype "
                        f"{stream.dtype}")
    if isinstance(stream, Products):
        if src is not None:
            raise ValueError("stream_sum: products are read in place, not "
                             "through a map")
        inputs = _products_named(stream)
    elif stream.dim() != 1:
        raise ValueError("stream_sum: the stream must be a vector")
    else:
        inputs = [("stream", stream, tuple(stream.shape), stream.dtype)]
    blocks = (Q * table.num_subtiles,)
    named = [
        ("slot_ptr", table.slot_ptr, tuple(table.slot_ptr.shape),
         torch.int32),
        ("run_start", table.run_start, tuple(table.run_start.shape),
         torch.int32),
        ("run_count", table.run_count, tuple(table.run_start.shape),
         torch.int32),
        ("order", table.order, blocks, torch.int32),
        ("block_first", table.block_first, blocks, torch.int32),
        ("block_runs", table.block_runs, blocks, torch.int32), *inputs]
    if src is not None:
        if src.dim() != 1:
            raise ValueError("stream_sum: src must be a vector")
        named.append(("src", src, tuple(src.shape), torch.int32))
    if out is not None:
        named.append(("out", out, (table.num_subtiles * R,), stream.dtype))
    check_tensors("stream_sum", stream.device, named)


def stream_sum(table: SumTable, stream: torch.Tensor | Products,
               src: torch.Tensor | None = None,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """One level's segmented sums, ``num_subtiles * 1024`` outputs in the
    stream's type (float64 or float32), written to `out` (a contiguous
    vector, which may be a slice of a larger buffer) or to a new vector;
    returns them. Position p of the level is read as ``stream[p]``,
    through the map as ``stream[src[p]]``, or as the products' p-th
    product (`Products`, read in place). The table's runs must lie inside
    the stream (or `src`), and every position they read must have a source
    in `src`; a level's plan guarantees both for ``in_rows * 128``
    positions. On a card the fp64 products' first call probes it (K7), as
    K1 does: the fp64 path's stated accuracy assumes multiply-adds that
    round once."""
    global launches, src_launches, product_launches
    _check(table, stream, src, out)
    device = stream.device
    if device.type == "cpu":
        sums = stream_sum_torch(table, stream, src)
        return sums if out is None else out.copy_(sums)
    if device.type != "cuda":
        raise ValueError(f"stream_sum: no kernel for tensors on {device}")
    products = isinstance(stream, Products)
    if products and stream.dtype == torch.float64 \
            and not ell_cuda.fma_contraction_available(device):
        raise RuntimeError(
            f"stream_sum: the fused multiply-add on {device} does not round "
            "once (fma_probe disagrees with the exact residual)")
    if table.num_subtiles == 0:
        return torch.empty(0, dtype=stream.dtype, device=device) \
            if out is None else out
    _build.check_constants(("stream_sum_rows", R), ("stream_sum_parts", Q),
                           ("stream_sum_rows_per_base", LBLOCK))
    symbol, args, out = kernel_call(table, stream, src, out)
    kind = symbol.rsplit("_", 1)[0]
    fn, error_string = _build.entry(symbol, SUM_ARGTYPES[kind])
    err = fn(*args)
    if err != 0:
        raise RuntimeError(f"stream_sum kernel launch failed: "
                           f"{error_string(err).decode()} (error {err})")
    if products:
        product_launches += 1
    elif src is None:
        launches += 1
    else:
        src_launches += 1
    return out


def kernel_call(table: SumTable, stream: torch.Tensor | Products,
                src: torch.Tensor | None = None,
                out: torch.Tensor | None = None):
    """K3's call for a checked table, stream, map and output on a card: the
    name of its entry point in ``csrc/stream_sum.cu`` (its argument types
    are ``SUM_ARGTYPES[name less its type]``), the arguments (one block per
    entry of ``table.order``) and the output they fill (`out`, or a new
    vector), on the current stream. The wrapper launches it; scripts that
    time builds of variant sources call the same entry point of their own
    library."""
    if out is None:
        out = torch.empty(table.num_subtiles * R, dtype=stream.dtype,
                          device=stream.device)
    if isinstance(stream, Products):
        ell, kind = stream.ell, "stream_sum_prod"
        narrow = ell.lcol is not None
        inputs = (ell.values.data_ptr(),
                  (ell.lcol if narrow else ell.colidx).data_ptr(),
                  ell.lbase.data_ptr() if narrow else None,
                  stream.x.data_ptr())
    else:
        kind = "stream_sum" if src is None else "stream_sum_src"
        inputs = (() if src is None else (src.data_ptr(),)) \
            + (stream.data_ptr(),)
    args = (table.run_start.data_ptr(), table.run_count.data_ptr(),
            table.order.data_ptr(), table.block_first.data_ptr(),
            table.block_runs.data_ptr(), *inputs, out.data_ptr(),
            table.order.numel(),
            torch.cuda.current_stream(stream.device).cuda_stream)
    return f"{kind}_{_VALUE_TAGS[stream.dtype]}", args, out


def apply_stream_sum(plan: StreamSumPlan,
                     v: torch.Tensor | Products) -> torch.Tensor:
    """Run the plan on `v`, level 1's input in position order
    (``plan.in_positions`` values, or as many `Products`; `position_map`
    of level 1 delivers a stream of entries there): the per-row sums in
    natural row order, in v's type.

    Level 1 sums `v` in place; each deeper level sums its input through its
    map from the output buffer, where every level writes its outputs; one
    final gather (`apply_permute`) takes each row's sum from the buffer."""
    shape = ((v.positions,) if isinstance(v, Products)
             else tuple(v.shape))
    if shape != (plan.in_positions,):
        raise ValueError(f"apply_stream_sum: level 1's input has shape "
                         f"{shape}, expected ({plan.in_positions},)")
    buffer = torch.empty(plan.buffer_len, dtype=v.dtype, device=v.device)
    for lv in plan.levels:
        out = buffer[lv.out_offset:lv.out_offset + lv.out_len]
        if lv.src is None:
            stream_sum(lv.table, v, out=out)
        else:
            stream_sum(lv.table, buffer, lv.src, out)
    return apply_permute(plan.final_src, buffer)
