"""upload_s (s, program span): the kept format's copy to the card and what
is laid out there (K1's slices), the outermost ``formats.upload`` spans in
the port's logged tree of ``formats/auto.auto_from_coo``
(``setup_split.py``)."""

from spmv_bench import setup_split


def read(run):
    return setup_split.reading(run, "upload_s")
