"""convert_s (s, host clock): the chooser and the conversion it picks,
``formats/auto.auto_from_coo`` from a host COO to the matrix on the
card."""


def read(run):
    return run.convert_s
