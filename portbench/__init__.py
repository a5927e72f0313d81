"""The benchmark of tpunet_torch on NVIDIA H100 cards (README.md)."""
