"""Logging in the reference's format, and the per-step random streams."""

from tpunet_torch.utils.logging import epoch_line, log0  # noqa: F401
