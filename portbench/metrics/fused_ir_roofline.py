"""Share of the roofline of the 1x1 convolutions with their batch norm
(``ops/fused_ir.py`` over ``csrc/fused_ir.cu``), forward and backward,
over the traced steps."""

from portbench.readers import roofline_share

KERNELS = (r"\bfused_ir_(fwd|bwd)\w*",)
COUNTERS = {
    "fused_ir_fwd": "tpunet_torch.ops.fused_ir:fused_ir_forward.launches",
    "fused_ir_bwd": "tpunet_torch.ops.fused_ir:fused_ir_backward.launches",
}


def read(ctx):
    return roofline_share(ctx, "fused_ir", KERNELS, COUNTERS)
