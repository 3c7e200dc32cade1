"""The yardstick of ``npb_cg_c.cg``'s roofline: the least bytes of one of
NPB CG's outer steps, from the matrix's counts alone.

A multiply ``q = A·p`` reads the matrix's values once (no storage holds
fewer: NPB's values are not bitwise symmetric, so `distinct_values` is the
nonzeros), p's referenced entries once, and writes q once; it takes no
index bytes, as ``least_bytes.py`` counts them. Each vector is read or
written once in each of NPB's statements (cg.f's ``conj_grad`` and
``main``):

- the start: z = 0 (1), r = x (2), p = r (2), ρ = r·r (1);
- each iteration: q = A·p (the multiply), p·q (2), z += α·p (3),
  r -= α·q (3), ρ = r·r (1), p = r + β·p (3);
- the end: A·z (the multiply), ‖x - A·z‖ (2), x·z (2), z·z (1),
  x = z/‖z‖ (2).

At class C the vectors (1.2 MB each) stay in the card's L2, so their
passes are a small part of the step at HBM's rate and the multiplies
nearly all of it. fp64: 8 bytes a value.
"""

from __future__ import annotations

VALUE_BYTES = 8
#: Vector passes of the start, of each iteration and of the end.
START_PASSES = 6
ITERATION_PASSES = 12
END_PASSES = 7


def multiply_bytes(distinct_values: int, referenced_columns: int,
                   n: int) -> int:
    """One ``q = A·p``: the values once, p's referenced entries, q."""
    return VALUE_BYTES * (distinct_values + referenced_columns + n)


def step_bytes(distinct_values: int, referenced_columns: int, n: int,
               iterations: int) -> int:
    """One outer step of `iterations` CG iterations: ``iterations + 1``
    multiplies and every vector pass."""
    passes = START_PASSES + ITERATION_PASSES * iterations + END_PASSES
    return (iterations + 1) * multiply_bytes(distinct_values,
                                             referenced_columns, n) \
        + VALUE_BYTES * passes * n
