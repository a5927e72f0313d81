"""The chip's peaks and the least time of each hand-kernel op.

Peaks: NVIDIA's H100 SXM data sheet, dense rates: 989 TFLOP/s bf16 on
the tensor cores, 67 TFLOP/s float32 outside them, 3.35 TB/s of HBM. A
card whose name matches no row has no peaks, and no roofline or MFU is
read on it.

An op's least time is the larger of its operations over the rate that
can run them and its bytes over the memory rate, counting each input
byte read once and each output byte written once, and the work the op's
shapes need, whatever a kernel reads again or recomputes. The
arithmetic of each op is that of the port's per-kernel bounds (its
kernel table), except the attention's backward, which is counted as one
op, as the op's interface fixes it, however many kernels run it.
"""

from __future__ import annotations

from typing import Dict, Optional

# (substring of torch.cuda.get_device_name, lower case; peaks)
PEAKS = (
    ("h100 pcie", {"bf16": 756e12, "f32": 51e12, "hbm": 2.0e12}),
    ("h100 nvl", {"bf16": 835e12, "f32": 60e12, "hbm": 3.9e12}),
    ("h100", {"bf16": 989e12, "f32": 67e12, "hbm": 3.35e12}),
)
BF16 = 2                   # bytes an activation element
F32 = 4


def peaks(device_name: str) -> Optional[Dict[str, float]]:
    name = device_name.lower()
    for key, p in PEAKS:
        if key in name:
            return p
    return None


def _least(nbytes: float, flops: float, rate: float, pk: dict) -> float:
    return max(nbytes / pk["hbm"], flops / pk[rate])


def depthwise(call: tuple, pk: dict) -> float:
    """Seconds of the forward and the backward of one depthwise 3x3 layer
    (n, h, w, c, stride), bf16: 9 multiply-adds an output element at the
    float32 rate (the forward; dx and dw, 36 FLOPs a gradient element,
    the backward)."""
    n, h, w, c, s = call
    ho, wo = (h - 1) // s + 1, (w - 1) // s + 1
    x, y, k = n * h * w * c, n * ho * wo * c, 9 * c
    fwd = _least((x + k + y) * BF16, 18 * y, "f32", pk)
    bwd = _least((2 * x + y + 2 * k) * BF16, 36 * y, "f32", pk)
    return fwd + bwd


def fused_ir(call: tuple, pk: dict) -> float:
    """Seconds of the forward and the backward of one 1x1 convolution with
    its batch norm (m, ci, co), bf16. Forward: x and w read, y and the
    float32 [2, co] sums written, one product. Backward: x, g, y, w and
    the [6, co] channel terms read, dx and the float32 dw written, two
    products (dx and dw)."""
    m, ci, co = call
    flops = 2 * m * ci * co
    fwd = _least((m * ci + ci * co + m * co) * BF16 + 2 * co * F32, flops,
                 "bf16", pk)
    bwd = _least((2 * m * ci + 2 * m * co + ci * co) * BF16 + 6 * co * F32
                 + ci * co * F32, 2 * flops, "bf16", pk)
    return fwd + bwd


def flash(call: tuple, pk: dict) -> float:
    """Seconds of the forward and the backward of one attention (b, t,
    heads, head_dim), bf16, no mask. Forward: q, k, v read, o and the
    float32 log-sum-exp written; QK^T and PV. Backward: q, k, v, o, dO and
    the log-sum-exp read, dq, dk, dv written; QK^T again (the forward
    keeps only the log-sum-exp), dO V^T, P^T dO, dS K and dS^T Q."""
    b, t, h, d = call
    x = b * t * h * d * BF16
    row = b * h * t * F32
    product = 2 * b * h * t * t * d
    fwd = _least(4 * x + row, 2 * product, "bf16", pk)
    bwd = _least(8 * x + row, 5 * product, "bf16", pk)
    return fwd + bwd


OPS = {"depthwise": depthwise, "fused_ir": fused_ir, "flash": flash}


def least_seconds(family: str, calls: list, pk: dict) -> float:
    return sum(OPS[family](c, pk) for c in calls)
