"""Model registry of the port: ``create_model(cfg, device, generator, image_size)``.

Dispatches on ``ModelConfig.name`` as ``tpunet/models/__init__.py``
does: MobileNetV2, the ViT family (``vit`` from the ``vit_*`` fields, or
the ``vit_tiny``/``vit_small``/``vit_base`` presets), the LM (``lm``)
and the pipelined ViT and LM (``vit_pp``, ``lm_pp``: the same weights,
this rank's stage of the blocks on the current mesh's 'pipe' axis).
Weights are drawn from an
explicit ``torch.Generator`` on the CPU and then moved, so one seed
gives the same weights on every device. MobileNetV2 follows
torchvision's initialisation (kaiming-normal fan_out convs, N(0, 0.01)
classifier, unit/zero BN); the ViT and the LM follow Flax's
(``init_vit``, ``init_lm``). ``param_dtype`` bfloat16 stores the
parameters (and so the optimizer state) in bf16.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from tpunet_torch.config import ModelConfig
from tpunet_torch.models.lm import create_lm
from tpunet_torch.models.mobilenetv2 import Conv, Linear, MobileNetV2
from tpunet_torch.models.vit import create_vit


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> None:
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                o, _, kh, kw = m.weight.shape
                std = math.sqrt(2.0 / (o * kh * kw))  # kaiming, fan_out
                m.weight.normal_(0.0, std, generator=generator)
            elif isinstance(m, Linear):
                m.weight.normal_(0.0, 0.01, generator=generator)
                m.bias.zero_()


def create_model(cfg: ModelConfig, device: str = "cuda",
                 generator: Optional[torch.Generator] = None,
                 image_size: int = 224) -> torch.nn.Module:
    """Build the model of ``cfg`` on ``device`` in eval mode, with weights
    drawn from ``generator`` (a CPU generator seeded with 0 when None).
    ``image_size`` sizes the ViT's position embedding; MobileNetV2 takes
    any size, and the LM reads ``max_seq_len``."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    if cfg.name == "mobilenet_v2":
        model = MobileNetV2(num_classes=cfg.num_classes,
                            width_mult=cfg.width_mult,
                            dropout_rate=cfg.dropout_rate,
                            use_pallas=cfg.use_pallas_depthwise,
                            fused_ir=cfg.fused_ir,
                            dtype=getattr(torch, cfg.dtype),
                            block_remat=cfg.block_remat)
        init_weights(model, generator)
    elif cfg.name == "lm":
        model = create_lm(cfg, generator)
    elif cfg.name == "lm_pp":
        from tpunet_torch.models.lm_pp import create_lm_pp
        model = create_lm_pp(cfg, generator)
    elif cfg.name == "vit_pp":
        from tpunet_torch.models.vit_pp import create_vit_pp
        model = create_vit_pp(cfg, image_size, generator)
    else:
        model = create_vit(cfg, image_size, generator)
    model = model.to(device=device)
    if cfg.param_dtype != "float32":
        # Parameters only: tpunet keeps the BN running statistics in
        # float32 whatever the parameters' dtype.
        dt = getattr(torch, cfg.param_dtype)
        for p in model.parameters():
            p.data = p.data.to(dt)
    return model.eval()


def num_params(model: torch.nn.Module) -> int:
    """The model's parameter count (a pipeline stage's: the whole
    model's)."""
    full = getattr(model, "n_params_full", None)
    return full if full is not None else sum(
        p.numel() for p in model.parameters())
