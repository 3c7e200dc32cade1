"""convert_build_s (s, program span): the chooser's work on the format it
kept, priced and built on the host: the outermost ``formats.price.<fmt>``
and ``formats.build.<fmt>`` spans of the root's `choice`, in the port's
logged tree of ``formats/auto.auto_from_coo`` (``setup_split.py``)."""

from spmv_bench import setup_split


def read(run):
    return setup_split.reading(run, "convert_build_s")
