"""setup_unspanned_s (s, host clock less program spans): the part of
``setup_s`` that no set-up entry of the port covers: imports, the matrix
made and handed over as a host COO, and the drivers' own warm-ups and
captures outside an entry. ``setup_s`` less the seconds of every tree the
port logs in the run (``setup_split.py``)."""

from spmv_bench import setup_split


def read(run):
    return setup_split.reading(run, "setup_unspanned_s")
