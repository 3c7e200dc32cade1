"""first_call_s (s, program span): ``ops/dispatch.traceable_spmv``'s first
call on a zero x, the kernels' library loaded (and built, where
``ops.library_load`` says `built`) and K7's probe included: the first
``dispatch.first_call`` tree the port logs after the chooser's
(``setup_split.py``)."""

from spmv_bench import setup_split


def read(run):
    return setup_split.reading(run, "first_call_s")
