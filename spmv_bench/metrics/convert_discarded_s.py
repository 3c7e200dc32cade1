"""convert_discarded_s (s, program span): the chooser's work on the formats
it did not keep, priced or built on the host and thrown away: the
outermost ``formats.price.*`` and ``formats.build.*`` spans of other
formats than the root's `choice`, in the port's logged tree of
``formats/auto.auto_from_coo`` (``setup_split.py``)."""

from spmv_bench import setup_split


def read(run):
    return setup_split.reading(run, "convert_discarded_s")
