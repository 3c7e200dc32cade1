"""The benchmark's CPU self-checks: ``python -m pytest spmv_bench/tests``
from the root of the repository. They need no card."""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
