"""Throughput and efficiency accounting: analytic model FLOPs, the
card's peak-FLOPs lookup, and the MFU estimate. The port's counterpart
of ``tpunet/obs/perf.py``: the FLOPs arithmetic is a copy; the peak
table holds NVIDIA's cards in place of TPU generations.

The FLOPs numbers are *analytic* (closed-form from the config, the
standard 6ND-style accounting), not measured from the kernels — they
exist to turn examples/s into a hardware-utilization fraction, so
~percent-level fidelity is the bar. A family we cannot model returns
0.0 and MFU is simply omitted from the record rather than guessed.
"""

from __future__ import annotations

from typing import Optional

import torch

# Dense bf16 peak TFLOP/s of one card by ``torch.cuda.get_device_name``
# substring: NVIDIA's H100 datasheet, half its with-sparsity figures.
# Matched case-insensitively in ORDER, so more specific strings come
# first ("NVIDIA H100 80GB HBM3", the SXM card, matches "h100").
# Unknown hardware (the CPU included) -> None -> no MFU claim.
_PEAK_TFLOPS = (
    ("h100 pcie", 756.0),
    ("h100 nvl", 835.0),
    ("h100", 989.0),
)


def device_peak_flops(device=None) -> Optional[float]:
    """Peak dense FLOP/s of one device (a ``torch.device``, a device
    string or a CUDA index; default: the current CUDA device), or None
    when unknown."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    if isinstance(device, int):
        device = torch.device("cuda", device)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    kind = torch.cuda.get_device_name(device).lower()
    for key, tflops in _PEAK_TFLOPS:
        if key in kind:
            return tflops * 1e12
    return None


def _transformer_train_flops_per_token(n_params: float, depth: int,
                                       hidden: int, seq_len: int) -> float:
    """6*N per token (fwd 2N + bwd 4N) plus the attention-score term
    the parameter count misses: per token per layer, QK^T and AV are
    each 2*T*H MACs -> 12*L*T*H FLOPs for fwd+bwd (causal masking
    halves the realized work; we charge the dense figure, matching the
    convention MFU tables use)."""
    return 6.0 * n_params + 12.0 * depth * seq_len * hidden


def train_flops_per_unit(model_cfg, data_cfg,
                         n_params: Optional[int] = None) -> float:
    """Analytic training FLOPs per *metric unit* — per next-token
    prediction for the LM family (matching the trainer's token-count
    metric), per image for the vision families. 0.0 == unknown."""
    name = model_cfg.name
    if name in ("lm", "lm_pp"):
        if n_params is None:
            return 0.0
        # Embedding rows do no FLOPs; the tied readout projection does
        # (2*H*V fwd per token), and n_params already includes the
        # embedding once — the 6N convention absorbs this.
        return _transformer_train_flops_per_token(
            float(n_params), model_cfg.vit_depth, model_cfg.vit_hidden,
            data_cfg.seq_len)
    if name.startswith("vit"):
        if n_params is None:
            return 0.0
        tokens = (data_cfg.image_size // max(1, model_cfg.vit_patch)) ** 2 + 1
        return tokens * _transformer_train_flops_per_token(
            float(n_params), model_cfg.vit_depth, model_cfg.vit_hidden,
            tokens)
    if name == "mobilenet_v2":
        # Conv FLOPs are not proportional to params: anchor on the
        # published 0.30 GMACs inference cost at width 1.0 / 224px and
        # scale by resolution (activations are O(HW)) and width^2
        # (channel pairs). Training ~= 3x inference (fwd + 2x bwd).
        gmacs_224 = 0.30e9
        scale = (data_cfg.image_size / 224.0) ** 2 * model_cfg.width_mult ** 2
        return 3.0 * 2.0 * gmacs_224 * scale
    return 0.0


def mfu(units_per_sec: float, flops_per_unit: float,
        n_devices: Optional[int] = None, device=None) -> Optional[float]:
    """Model FLOPs utilization in [0, 1], or None when either the model
    FLOPs or the hardware peak is unknown (never a fabricated number).
    ``n_devices`` defaults to the world size (one card a rank): the
    trainer's epoch counts are summed over the ranks."""
    if not flops_per_unit or units_per_sec <= 0:
        return None
    peak = device_peak_flops(device)
    if peak is None:
        return None
    if n_devices is None:
        from tpunet_torch.parallel.dist import process_count
        n_devices = process_count()
    return (units_per_sec * flops_per_unit) / (peak * n_devices)
