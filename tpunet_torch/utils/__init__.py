"""Logging in the reference's format, the per-step random streams, and
the wall-clock ``Timer``."""

from tpunet_torch.utils.logging import epoch_line, log0  # noqa: F401
from tpunet_torch.utils.timing import Timer  # noqa: F401
