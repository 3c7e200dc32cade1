"""setup_s (s, host clock): from the start of the process to the start
of the window: imports, the matrix made, the conversion, the first call,
the captures and warm-up."""


def read(run):
    return run.setup_s
