"""`csrspmv` on PyTorch: the CSR SpMV benchmark program (the reference's
csrspmv.c:1766 main). The CSR runs through its sliced-ELL repack on the ELL
kernel, as the JAX program runs it on the TPU. Run as
``python -m ellspmv_tpu_torch.cli.csrspmv``."""

from __future__ import annotations

import sys

from ellspmv_tpu_torch.cli.common import run


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    return run(argv, "csrspmv", csr=True)


if __name__ == "__main__":
    raise SystemExit(main())
