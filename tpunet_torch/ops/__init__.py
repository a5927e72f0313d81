"""Hand-written Hopper kernels, each beside its plain PyTorch version.

- ``depthwise``: the 3x3 depthwise convolution of MobileNetV2, forward
  and backward (CUDA C++, ``csrc/depthwise.cu``), port of
  ``tpunet/ops/depthwise.py``;
- ``fused_ir``: the fused 1x1 conv + train-mode BN statistics forward
  and its backward (CUDA C++, ``csrc/fused_ir.cu``), port of
  ``tpunet/ops/fused_ir.py``;
- ``flash``: flash attention, the forward with optional lse, dQ and
  dK/dV (CUDA C++, ``csrc/flash.cu``), port of ``tpunet/ops/flash.py``;
  ``attention`` holds the plain dense and blockwise attentions of
  ``tpunet/ops/attention.py`` and its sequence-parallel ring and
  Ulysses attentions, which run the flash kernels inside.

Kernels are built by ``_build`` at first use on a CUDA tensor; a CPU
tensor always takes the plain version.
"""

from tpunet_torch.ops.depthwise import (depthwise_conv3x3,
                                        depthwise_conv3x3_backward,
                                        depthwise_conv3x3_reference,
                                        depthwise_conv3x3_train)
from tpunet_torch.ops.fused_ir import conv1x1_bn_act

__all__ = ["conv1x1_bn_act", "depthwise_conv3x3",
           "depthwise_conv3x3_backward", "depthwise_conv3x3_reference",
           "depthwise_conv3x3_train"]
