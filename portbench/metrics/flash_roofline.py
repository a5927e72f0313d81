"""Share of the roofline of the attention (``ops/flash.py`` over
``csrc/flash.cu``), forward and backward, over the traced steps."""

from portbench.readers import roofline_share

KERNELS = (r"\bflash_(fwd|bwd_dq|bwd_dkv)\w*",)
COUNTERS = {
    "flash_fwd": "tpunet_torch.ops.flash:flash_attention_forward.launches",
    "flash_dq": "tpunet_torch.ops.flash:flash_attention_dq.launches",
    "flash_dkv": "tpunet_torch.ops.flash:flash_attention_dkv.launches",
}


def read(ctx):
    return roofline_share(ctx, "flash", KERNELS, COUNTERS)
