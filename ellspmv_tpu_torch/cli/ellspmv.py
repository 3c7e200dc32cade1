"""`ellspmv` on PyTorch: the ELLPACK SpMV benchmark program (the reference's
ellspmv.c:1226 main). Run as ``python -m ellspmv_tpu_torch.cli.ellspmv``."""

from __future__ import annotations

import sys

from ellspmv_tpu_torch.cli.common import run


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    return run(argv, "ellspmv")


if __name__ == "__main__":
    raise SystemExit(main())
