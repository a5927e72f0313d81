"""Configuration for the PyTorch port: the fields the ported slices honour.

A copy of the matching parts of ``tpunet/config.py`` with identical
defaults (the reference project's literals: 224 px, 10 classes,
ImageNet normalization, MobileNetV2 width 1.0 with dropout 0.2, bf16
activations over f32 parameters, batch 128 (64 for ``serial``), Adam
1e-4 with StepLR(10, 0.1), 20 epochs, seed 42, classify micro-batching
of 8 images in a 2 ms window). Fields of the JAX config that no ported
module reads are left out. Fields that the JAX config has and that a
later slice ports are kept at their defaults, and setting one away from
its default raises with the ROADMAP item that ports it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ImageNet normalization statistics: the reference trains with these,
# and serving reuses the training stats (one constant everywhere).
IMAGENET_MEAN: Tuple[float, float, float] = (0.485, 0.456, 0.406)
IMAGENET_STD: Tuple[float, float, float] = (0.229, 0.224, 0.225)

CIFAR10_CLASSES: Tuple[str, ...] = (
    "airplane", "automobile", "bird", "cat", "deer",
    "dog", "frog", "horse", "ship", "truck",
)

# Model names of the JAX package that the port does not build yet, and
# the ROADMAP item that ports them.
_NOT_PORTED = {
    "vit_pp": "Queue A item 8 (parallelism beyond DP)",
    "lm_pp": "Queue A item 8 (parallelism beyond DP)",
}
VIT_NAMES = ("vit", "vit_tiny", "vit_small", "vit_base")
IMAGE_DATASETS = ("cifar10", "synthetic")
TOKEN_DATASETS = ("synthetic_lm", "text_lm")
ATTENTIONS = ("auto", "dense", "blockwise", "flash", "ring", "ulysses")


def _refuse_unported(obj, items) -> None:
    """Raise when a field that no ported module honours is set away from
    its default. ``items`` maps field name -> the ROADMAP item."""
    for name, item in items.items():
        f = next(f for f in dataclasses.fields(obj) if f.name == name)
        if getattr(obj, name) != f.default:
            raise NotImplementedError(
                f"{type(obj).__name__}.{name}={getattr(obj, name)!r} is not "
                f"ported to tpunet_torch yet; it comes with ROADMAP {item}")


@dataclass(frozen=True)
class DataConfig:
    """Data pipeline config: the reference's transforms and loaders."""

    data_dir: str = "data"
    dataset: str = "cifar10"  # cifar10 | synthetic | synthetic_lm | text_lm
    download: bool = True
    image_size: int = 224
    batch_size: int = 128             # GLOBAL batch
    eval_batch_size: int = 0          # 0 -> same as batch_size
    num_classes: int = 10
    rrc_scale: Tuple[float, float] = (0.7, 1.0)
    rrc_ratio: Tuple[float, float] = (0.75, 4.0 / 3.0)
    jitter_brightness: float = 0.3
    jitter_contrast: float = 0.3
    jitter_saturation: float = 0.3
    jitter_hue: float = 0.1
    rotation_degrees: float = 15.0
    mean: Tuple[float, float, float] = IMAGENET_MEAN
    std: Tuple[float, float, float] = IMAGENET_STD
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    synthetic_train_size: int = 50_000
    synthetic_test_size: int = 10_000
    # Token datasets (model "lm"): "synthetic_lm" is seeded bigram data
    # of this sequence length and vocab; "text_lm" chunks the raw bytes
    # of ``text_path`` (byte-level, vocab 256), and with ``pack_docs``
    # packs its newline-delimited documents into ``seq_len`` rows with
    # per-token segment ids. vocab_size must equal the model's.
    seq_len: int = 128
    vocab_size: int = 256
    text_path: str = ""
    pack_docs: bool = False
    # The train remainder is dropped, and the test set is evaluated
    # exactly (the last batch padded with masked examples).
    drop_remainder: bool = True
    # The JAX package uses its native C++ prefetcher when it can build
    # it and numpy otherwise. The port has no prefetcher yet (ROADMAP
    # Queue A item 2b): its loader is numpy, in the same order, and the
    # field that chooses between the two waits for that item.
    native_loader: bool = True

    def __post_init__(self):
        if self.dataset not in IMAGE_DATASETS + TOKEN_DATASETS:
            raise ValueError(f"unknown dataset {self.dataset!r}; expected "
                             f"one of {IMAGE_DATASETS + TOKEN_DATASETS}")
        if self.pack_docs and self.dataset != "text_lm":
            raise ValueError(f"--pack-docs packs text_lm documents; "
                             f"dataset is {self.dataset!r} (its labels are "
                             "not segment ids)")
        if self.dataset == "text_lm" and self.vocab_size < 256:
            raise ValueError(f"text_lm is byte-level: vocab_size must be "
                             f">= 256, got {self.vocab_size}")
        if not self.drop_remainder:
            raise ValueError("drop_remainder=False is not a mode of the "
                             "JAX pipeline either: the train remainder is "
                             "always dropped")
        _refuse_unported(self, {
            "mixup_alpha": "Queue A item 2b (mixup/CutMix)",
            "cutmix_alpha": "Queue A item 2b (mixup/CutMix)",
            "native_loader": "Queue A item 2b (the native C++ prefetcher "
                             "and the choice between it and numpy)",
        })

    @property
    def effective_eval_batch_size(self) -> int:
        return self.eval_batch_size or self.batch_size


@dataclass(frozen=True)
class ModelConfig:
    """Model config: MobileNetV2 (torchvision's model with a 10-class
    head), the ViT family (``vit`` from the ``vit_*`` fields, or the
    ``vit_tiny``/``vit_small``/``vit_base`` presets) or the decoder-only
    LM (``lm``: the ``vit_hidden``/``vit_depth``/``vit_heads`` blocks
    over ``vocab_size`` tokens and ``max_seq_len`` learned positions).

    MobileNetV2 only: ``use_pallas_depthwise`` keeps the JAX package's
    name: it routes the 17 depthwise convs through the hand-written
    depthwise kernels (``tpunet_torch.ops.depthwise``) instead of
    ``F.conv2d``. ``fused_ir`` (train mode only) routes the 33
    expand/project 1x1 convs through the fused conv + BN-statistics
    kernels (``tpunet_torch.ops.fused_ir``); eval mode never does.
    ``fused_bn`` is carried for config parity: the port's BN is always
    FusedBNAct's math, one per-channel FMA + clamp. ``pretrained_path``
    is a local ``.pth`` in the port's layout.

    ViT: ``attention`` picks the core, ``auto`` and ``flash`` the flash
    kernels (``tpunet_torch.ops.flash``), ``dense`` or ``blockwise`` the
    plain versions; ``attention_block`` is the blockwise chunk and the
    flash call's TPU block size (the LM's core is causal). The
    sequence-parallel cores, MoE, the vocab-sharded cross-entropy and
    remat wait for their ROADMAP items and raise when set.
    """

    name: str = "mobilenet_v2"  # mobilenet_v2 | vit | vit_{tiny,small,base}
    num_classes: int = 10
    width_mult: float = 1.0
    dropout_rate: float = 0.2
    use_pallas_depthwise: bool = False
    fused_bn: bool = True
    fused_ir: bool = True
    block_remat: bool = False
    pretrained_path: Optional[str] = None
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    vit_patch: int = 16
    vit_hidden: int = 192
    vit_depth: int = 6
    vit_heads: int = 3
    vit_mlp_ratio: float = 4.0
    attention: str = "auto"
    attention_block: int = 512
    attention_core: str = "auto"
    moe_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_dispatch: str = "auto"
    remat: bool = False
    vocab_size: int = 256
    max_seq_len: int = 1024
    vocab_ce: str = "auto"

    def __post_init__(self):
        if self.name in _NOT_PORTED:
            raise NotImplementedError(
                f"model {self.name!r} is not ported to tpunet_torch yet; "
                f"it comes with ROADMAP {_NOT_PORTED[self.name]}")
        if self.name not in ("mobilenet_v2", "lm") + VIT_NAMES:
            raise ValueError(f"unknown model {self.name!r}")
        if self.vocab_ce not in ("auto", "full", "sharded"):
            raise ValueError(f"unknown vocab_ce {self.vocab_ce!r}; expected "
                             "auto|full|sharded")
        if self.vocab_ce == "sharded":
            # "auto" resolves to "full" without a mesh 'model' axis, and
            # the port has none.
            raise NotImplementedError(
                "vocab_ce='sharded' (the vocab-parallel cross-entropy over "
                "a mesh 'model' axis) is not ported to tpunet_torch yet; it "
                "comes with ROADMAP Queue A item 8")
        if self.vocab_size < 1 or self.max_seq_len < 1:
            raise ValueError(f"vocab_size {self.vocab_size} and max_seq_len "
                             f"{self.max_seq_len} must be >= 1")
        if not self.fused_bn:
            raise ValueError("fused_bn=False (nn.BatchNorm + clamp) computes "
                             "the same function; the port runs only the "
                             "fused form")
        if self.attention not in ATTENTIONS:
            raise ValueError(f"unknown attention {self.attention!r}; "
                             f"expected one of {ATTENTIONS}")
        if self.attention in ("ring", "ulysses"):
            raise NotImplementedError(
                f"attention={self.attention!r} (sequence parallelism over a "
                "mesh) is not ported to tpunet_torch yet; it comes with "
                "ROADMAP Queue A item 8")
        if self.attention_block < 1:
            raise ValueError(f"attention_block must be >= 1, got "
                             f"{self.attention_block}")
        moe = "Queue A item 8 (MoE and expert parallelism)"
        _refuse_unported(self, {
            "block_remat": "Queue A item 2b (block remat)",
            "remat": "Queue A item 2b (block remat)",
            "attention_core": "Queue A item 8 (the ring/Ulysses cores)",
            "moe_experts": moe, "moe_every": moe, "moe_top_k": moe,
            "moe_capacity_factor": moe, "moe_aux_weight": moe,
            "moe_dispatch": moe})
        if self.name != "mobilenet_v2":
            for f in ("width_mult", "use_pallas_depthwise", "fused_ir"):
                default = next(x.default for x in dataclasses.fields(self)
                               if x.name == f)
                if getattr(self, f) != default:
                    raise ValueError(f"ModelConfig.{f} is a MobileNetV2 "
                                     f"field; model {self.name!r} does not "
                                     "read it")
        if self.pretrained_path == "auto":
            raise NotImplementedError(
                "pretrained_path='auto' downloads torchvision's ImageNet "
                "checkpoint; the port takes a local .pth only until ROADMAP "
                "Queue A item 2b (CIFAR-10 and the ImageNet .pth on the "
                "card's machine)")


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer config (reference: Adam 1e-4 + StepLR(10, 0.1)).

    ``grad_accum``: microbatches a step (strided rows of the batch), one
    update; ``clip_norm``: optax's ``clip_by_global_norm`` before the
    update, 0 = off."""

    name: str = "adam"
    learning_rate: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    schedule: str = "step"            # step | cosine | constant
    step_size_epochs: int = 10
    gamma: float = 0.1
    warmup_epochs: float = 0.0
    label_smoothing: float = 0.0
    clip_norm: float = 0.0
    ema_decay: float = 0.0
    grad_accum: int = 1

    def __post_init__(self):
        if self.grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {self.grad_accum}")
        if self.clip_norm < 0:
            raise ValueError(f"clip_norm must be >= 0, got {self.clip_norm}")
        _refuse_unported(self, {"ema_decay": "Queue A item 2b (EMA)"})


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "checkpoints"
    resume: bool = False


@dataclass(frozen=True)
class ServeConfig:
    """The classifier micro-batching fields of ``tpunet.config.ServeConfig``:
    hold a request at most ``classify_window_ms`` to coalesce up to
    ``classify_batch_max`` images into one batched forward."""

    classify_batch_max: int = 8
    classify_window_ms: float = 2.0


@dataclass(frozen=True)
class TrainConfig:
    """Top-level training config."""

    epochs: int = 20                  # reference EPOCHS
    seed: int = 42                    # reference torch.manual_seed(42)
    eval_only: bool = False
    log_every_steps: int = 0          # 0 -> per-epoch only, like the reference
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)

    def __post_init__(self):
        # tpunet's cross-checks (tpunet/train/loop.py:55-66, 159-176).
        is_lm = self.model.name == "lm"
        if is_lm != (self.data.dataset in TOKEN_DATASETS):
            raise ValueError(
                f"model {self.model.name!r} and dataset "
                f"{self.data.dataset!r} are different families (the 'lm' "
                "model needs token data, e.g. --dataset synthetic_lm)")
        if is_lm and self.model.vocab_size != self.data.vocab_size:
            raise ValueError(
                f"model vocab {self.model.vocab_size} != data vocab "
                f"{self.data.vocab_size}; out-of-range tokens would index "
                "past the embedding")
        if self.data.pack_docs and self.model.attention not in (
                "dense", "flash", "auto"):
            raise ValueError(
                f"--pack-docs needs a segment-capable attention core "
                f"(dense/flash/auto), got {self.model.attention!r}")

    @property
    def is_lm(self) -> bool:
        return self.model.name == "lm"

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


def preset(name: str) -> TrainConfig:
    """The config of a named launch mode.

    - ``serial``: the reference's serial script, batch 64;
    - ``single``: the reference's one-accelerator script, batch 128;
    - ``distributed``: the reference's MPI script, data parallelism over
      NCCL: the ``single`` config, 128 a rank (the CLI multiplies the
      batch by the world size).
    """
    base = TrainConfig()
    if name == "serial":
        return base.replace(data=dataclasses.replace(base.data, batch_size=64))
    if name in ("single", "distributed"):
        return base
    raise ValueError(f"unknown preset {name!r}; expected "
                     "serial|single|distributed")
