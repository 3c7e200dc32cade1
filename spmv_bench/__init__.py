"""The benchmark of the PyTorch and CUDA port (``ellspmv_tpu_torch``).

``python3 spmv_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` on one card and prints
one JSON line. Everything a cell is made of is found by name from that
file: ``configs/<config>.json`` (its generator in ``generators/``),
``traffic/<mix>.json`` (its driver in ``drivers/``) and
``metrics/<metric>.py``. Nothing here imports JAX or the JAX package, and
nothing imports ``ellspmv_tpu_torch.bench``.
"""
