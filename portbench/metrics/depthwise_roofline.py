"""Share of the roofline of the depthwise 3x3 convolutions
(``ops/depthwise.py`` over ``csrc/depthwise.cu``), forward and backward,
over the traced steps: their least time at the layers' shapes over the
device time of the family's kernels."""

from portbench.readers import roofline_share

KERNELS = (r"\bdepthwise3x3_(fwd|bwd|dw_sum)\b",)
COUNTERS = {
    "depthwise_fwd": "tpunet_torch.ops.depthwise:depthwise_conv3x3.launches",
    "depthwise_bwd":
        "tpunet_torch.ops.depthwise:depthwise_conv3x3_backward.launches",
}


def read(ctx):
    return roofline_share(ctx, "depthwise", KERNELS, COUNTERS)
