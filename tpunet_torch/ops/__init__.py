"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``depthwise``: the 3x3 depthwise convolution forward of MobileNetV2
  (CUDA C++, ``csrc/depthwise.cu``), port of ``tpunet/ops/depthwise.py``.

Kernels are built by ``_build`` at first use on a CUDA tensor; a CPU
tensor always takes the plain version.
"""

from tpunet_torch.ops.depthwise import (depthwise_conv3x3,
                                        depthwise_conv3x3_reference)

__all__ = ["depthwise_conv3x3", "depthwise_conv3x3_reference"]
