"""The NAS Parallel Benchmarks' CG matrix (``makea`` in NPB's cg.f / cg.c;
Bailey et al., RNR-91-002 and NAS-95-020): a fixed random symmetric
pattern made of outer products of sparse random vectors, with SHIFT taken
off the diagonal, so that NPB's inverse power iteration finds the
smallest eigenvalue of ``A + SHIFT·I``.

The random numbers are NPB's ``randlc``: ``x <- 5^13·x mod 2^46``,
returning ``x·2^-46``, from ``tran = 314159265``; ``main`` draws one
before ``makea``. For each outer vector ``iouter`` = 1..NA:

- ``sprnvc`` draws pairs (``vecelt``, ``vecloc``), in that order, and takes
  ``i = ⌊nn1·vecloc⌋ + 1`` (nn1 the least power of two ≥ NA), rejecting
  ``i > NA`` and an ``i`` already in this vector, until NONZER entries are
  accepted;
- ``vecset`` sets the entry at ``i = iouter`` to 0.5, replacing its value
  or appending it;
- for each entry ``b`` (the column) and then each entry ``a`` (the row),
  the entry ``(iv[a], iv[b], v[a]·(size·v[b]))``; then ``size <-
  size·ratio`` with ``ratio = RCOND^(1/NA)``, from ``size = 1``.

After the loop, ``RCOND - SHIFT`` on every diagonal entry. ``sparse`` then
sums duplicate entries in the order they were made, and drops a sum that
is exactly 0. This definition reproduced NPB's published ζ at classes S,
W, A and C to within 1e-13.

The random stream is drawn on the host (it is sequential, with
rejections): ``randlc``'s values in bulk by jumps of the multiplier,
exact in 64-bit integers, then the vectors filled a block at a time. The
outer products and the sums are made on `device`. Rows come out sorted,
columns sorted within each row, no duplicates. NPB's matrix is fixed: the
seed changes nothing. Its values are not bitwise symmetric (``size·v[b]``
is rounded before the product), so `distinct_values` is the nonzeros.

params: ``na``, ``nonzer``, ``rcond``, ``shift``; ``niter`` and
``zeta_verify`` are read by the driver (``drivers/npb_cg.py``) through
`made`.
"""

from __future__ import annotations

import numpy as np
import torch

from spmv_bench.generators import Matrix, referenced_columns

#: randlc's multiplier (5^13), modulus bits and NPB's seed.
AMULT = 5**13
BITS = 46
SEED = 314159265
MASK = (1 << BITS) - 1
#: randlc's values made at a time, as a block of `JUMP` bases by `JUMP`
#: powers.
JUMP = 4096
#: Outer vectors filled at a time before the stream is looked at for a
#: repeated index.
BLOCK = 4096

#: The params of each matrix made in this process, by its row count: the
#: harness hands a driver the row count alone, and the CPU self-checks
#: make smaller classes than the configuration's.
made: dict[int, dict] = {}


def randlc_after(x: int, count: int) -> np.ndarray:
    """The next `count` states of randlc after state `x`, as uint64
    integers below 2^46 (the value returned is a state times 2^-46).
    Products wrap modulo 2^64, of which 2^46 is a factor, so masking them
    gives the product modulo 2^46 exactly."""
    powers = np.empty(JUMP, np.uint64)
    p = 1
    for j in range(JUMP):
        p = p * AMULT & MASK
        powers[j] = p
    blocks = -(-count // JUMP)
    bases = np.empty(blocks, np.uint64)
    for t in range(blocks):
        bases[t] = x
        x = x * int(powers[-1]) & MASK
    out = (bases[:, None] * powers[None, :]) & np.uint64(MASK)
    return out.reshape(-1)[:count]


def _candidates(x: int, pairs: int, n: int, shift_bits: int):
    """`pairs` draws of (vecelt, vecloc) after state `x`: the accepted
    entries' values and 0-based indices, in order, and the state after."""
    states = randlc_after(x, 2 * pairs)
    elt, loc = states[0::2], states[1::2]
    index = (loc >> np.uint64(shift_bits)).astype(np.int64)
    keep = index < n
    return (elt[keep].astype(np.float64) * 2.0**-BITS, index[keep],
            int(states[-1]))


def vectors(n: int, nonzer: int):
    """NPB's sparse vectors, ``sprnvc`` then ``vecset`` for each outer
    vector: values (n, nonzer + 1), 0-based indices (n, nonzer + 1) and
    the entries each holds (nonzer or nonzer + 1; the last slot is unused
    where ``vecset`` replaced an entry)."""
    nn1 = 1 << max(n - 1, 0).bit_length()
    shift_bits = BITS - (nn1.bit_length() - 1)
    state = SEED * AMULT & MASK          # main's draw before makea
    # about nonzer·nn1 pairs in all; more are drawn where these run out
    vals, idx, state = _candidates(state, nonzer * nn1 // 16 * 17 + 64, n,
                                   shift_bits)
    v = np.zeros((n, nonzer + 1))
    iv = np.zeros((n, nonzer + 1), np.int64)
    pos = outer = 0
    while outer < n:
        rows = min(BLOCK, n - outer)
        if pos + rows * nonzer > idx.size:
            more_v, more_i, state = _candidates(
                state, nonzer * nn1 // 16 * 17 + 64, n, shift_bits)
            vals = np.concatenate([vals[pos:], more_v])
            idx = np.concatenate([idx[pos:], more_i])
            pos = 0
            continue
        block = idx[pos:pos + rows * nonzer].reshape(rows, nonzer)
        ordered = np.sort(block, axis=1)
        repeats = np.flatnonzero((ordered[:, 1:] == ordered[:, :-1]).any(1))
        clean = int(repeats[0]) if repeats.size else rows
        iv[outer:outer + clean, :nonzer] = block[:clean]
        v[outer:outer + clean, :nonzer] = vals[
            pos:pos + clean * nonzer].reshape(clean, nonzer)
        pos += clean * nonzer
        outer += clean
        if clean < rows:                 # a repeat: taken one draw at a time
            seen, k = [], pos
            while len(seen) < nonzer:
                if k == idx.size:
                    more_v, more_i, state = _candidates(state, 1024, n,
                                                        shift_bits)
                    vals = np.concatenate([vals, more_v])
                    idx = np.concatenate([idx, more_i])
                if idx[k] not in seen:
                    seen.append(int(idx[k]))
                    v[outer, len(seen) - 1] = vals[k]
                k += 1
            iv[outer, :nonzer] = seen
            pos = k
            outer += 1
    # vecset: the diagonal's 0.5, in place or appended
    at = iv[:, :nonzer] == np.arange(n)[:, None]
    v[:, :nonzer][at] = 0.5
    has = at.any(1)
    v[~has, nonzer] = 0.5
    iv[~has, nonzer] = np.flatnonzero(~has)
    iv[has, nonzer] = np.flatnonzero(has)    # unused slots point home
    return v, iv, np.where(has, nonzer, nonzer + 1)


def sum_in_order(keys: torch.Tensor, values: torch.Tensor):
    """The distinct keys, sorted, and each one's values summed in the
    order they come, one at a time, as NPB's ``sparse`` adds them: the sum
    is the same on any device and in any run."""
    keys, order = torch.sort(keys, stable=True)
    values = values[order]
    new = torch.ones_like(keys, dtype=torch.bool)
    new[1:] = keys[1:] != keys[:-1]
    group = torch.cumsum(new, 0) - 1
    starts = torch.nonzero(new).squeeze(1)
    rank = torch.arange(keys.numel(), device=keys.device) - starts[group]
    sums = values[starts].clone()
    for r in range(1, int(rank.max()) + 1 if rank.numel() else 0):
        at = rank == r
        sums[group[at]] += values[at]
    return keys[starts], sums


def generate(params: dict, seed: int, device) -> Matrix:
    del seed                       # NPB's matrix is the same for any seed
    n, nonzer = int(params["na"]), int(params["nonzer"])
    rcond, shift = float(params["rcond"]), float(params["shift"])
    made[n] = dict(params)
    v, iv, count = vectors(n, nonzer)
    size = np.cumprod(np.r_[1.0, np.full(n - 1, rcond ** (1.0 / n))])
    v = torch.from_numpy(v).to(device)
    iv = torch.from_numpy(iv).to(device)
    slots = torch.arange(nonzer + 1, device=device)
    used = slots[None, :] < torch.from_numpy(count).to(device)[:, None]
    scale = torch.from_numpy(size).to(device)[:, None] * v
    # entry [outer, column entry b, row entry a], in makea's order
    values = v[:, None, :] * scale[:, :, None]
    keep = used[:, :, None] & used[:, None, :]
    rows = iv[:, None, :].expand_as(values)[keep]
    cols = iv[:, :, None].expand_as(values)[keep]
    values = values[keep]
    del v, scale, keep
    diag = torch.arange(n, device=device)
    rows = torch.cat([rows, diag])
    keys = rows * n + torch.cat([cols, diag])
    del rows, cols
    values = torch.cat([values, torch.full((n,), rcond - shift,
                                           dtype=torch.float64,
                                           device=device)])
    keys, values = sum_in_order(keys, values)
    nonzero = values != 0
    keys, values = keys[nonzero], values[nonzero]
    rows, cols = keys // n, keys % n
    return Matrix(n, rows, cols, values, int(values.numel()),
                  referenced_columns(cols, n))
