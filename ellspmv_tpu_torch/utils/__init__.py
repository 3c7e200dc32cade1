"""Phase timing and device tracing (``ellspmv_tpu.utils``'s counterparts)."""

from ellspmv_tpu_torch.utils.timing import PhaseTimer
from ellspmv_tpu_torch.utils.trace import device_trace

__all__ = ["PhaseTimer", "device_trace"]
