"""The benchmark's self-checks (``python -m pytest spmv_bench/tests``):
the small sizes that ``tests/test_bench_correct.py`` runs each cell at,
for the cells that its table ``SMALL`` predates.

``hpcg_256`` runs at 32³, the smallest cube on which HPCG's four levels
are all DIA: the coarsest is then 4³; at 16³ it is 2³, one dense 8×8
block, which the chooser rightly sends to ELL and the hierarchy refuses.
"""

LATER_CELLS = {"hpcg_256": {"nx": 32}}


def pytest_collection_modifyitems(items):
    for item in items:
        small = getattr(item.module, "SMALL", None)
        if isinstance(small, dict) and item.module.__name__.endswith(
                "test_bench_correct"):
            for config, params in LATER_CELLS.items():
                small.setdefault(config, params)
