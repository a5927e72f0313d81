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

VIT_NAMES = ("vit", "vit_tiny", "vit_small", "vit_base")
# The pipelined models (tpunet's ``vit_pp`` and ``lm_pp``): the ViT's and
# the LM's blocks split into stages over the mesh's 'pipe' axis.
PIPE_NAMES = ("vit_pp", "lm_pp")
LM_NAMES = ("lm", "lm_pp")
PP_SCHEDULES = ("gpipe", "1f1b", "interleaved")
IMAGE_DATASETS = ("cifar10", "synthetic")
TOKEN_DATASETS = ("synthetic_lm", "text_lm")
ATTENTIONS = ("auto", "dense", "blockwise", "flash", "ring", "ulysses")
SEQ_ATTENTIONS = ("ring", "ulysses")      # sequence-parallel over 'seq'
ATTENTION_CORES = ("auto", "flash", "blockwise")


# Why ``--aot-cache`` / ``ServeConfig.aot_cache`` is refused for good (it
# is not a port still to come): the serve CLI, the config and the ROADMAP
# give this reason.
AOT_CACHE_SCOPED_OUT = (
    "--aot-cache (ServeConfig.aot_cache) is out of scope for tpunet_torch: "
    "tpunet's warm start persists compiled XLA executables so that a "
    "restarted replica skips compiling, but eager PyTorch compiles no "
    "per-shape program; the port's only compile step, the nvcc build of "
    "its hand kernels, is already cached under build/tpunet_torch/ at "
    "first use; CUDA graphs cannot be serialised to disk, and capturing "
    "the decode step in a graph is a performance lever (ROADMAP Queue "
    "B' H1), not a port of this feature")


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
    # The native C++ prefetcher (``tpunet_torch/data/native.py``, the
    # unchanged ``cxx/batcher.cc``) when it can be built, the numpy
    # loader otherwise or when off (``--no-native-loader``); both give
    # the same batches in the same order.
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
    flash call's TPU block size (the LM's core is causal). ``ring`` and
    ``ulysses`` are sequence-parallel over the mesh's 'seq' axis, with
    ``attention_core`` the local core inside them (``auto`` and
    ``flash`` the flash kernels, ``blockwise`` the plain online
    softmax). ``remat``
    recomputes each encoder block of the ViT and the LM in the backward
    (training only; never the decode path), ``block_remat`` each
    MobileNetV2 inverted-residual block's BN/ReLU6 epilogues from the
    saved conv outputs and (C,) statistics. ``param_dtype`` is the
    storage dtype of the parameters and the optimizer state (float32 or
    bfloat16; the BN running statistics stay float32). ``moe_experts`` >
    0 makes every ``moe_every``-th block of the ViT family and the LM a
    top-``moe_top_k`` MoE block (``tpunet_torch.models.moe``) of
    ``moe_capacity_factor``, its load-balance term weighted by
    ``moe_aux_weight`` in the loss, its experts split over the mesh's
    'model' axis under ``moe_dispatch`` (``auto``/``alltoall``/
    ``replicated``). ``vit_pp`` and ``lm_pp`` are the ViT and the LM
    with their blocks split into stages over the mesh's 'pipe' axis
    (``tpunet_torch.models.vit_pp``/``lm_pp``): ``pp_microbatches``
    microbatches a step under ``pp_schedule`` (``gpipe``, ``1f1b`` or
    ``interleaved`` with ``pp_virtual`` chunks a stage). ``vocab_ce``
    (``auto``/``sharded``/``full``) is resolved against the mesh by
    ``tpunet_torch.ops.vocab_ce.resolve_vocab_ce``.
    """

    name: str = "mobilenet_v2"  # mobilenet_v2 | vit | vit_{tiny,small,base} | vit_pp | lm | lm_pp
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
    # Pipeline parallelism (vit_pp, lm_pp): microbatches a step, the
    # schedule, and the chunks a stage of the interleaved schedule.
    pp_microbatches: int = 4
    pp_schedule: str = "gpipe"
    pp_virtual: int = 2
    remat: bool = False
    vocab_size: int = 256
    max_seq_len: int = 1024
    vocab_ce: str = "auto"

    def __post_init__(self):
        if self.name not in ("mobilenet_v2",) + LM_NAMES + VIT_NAMES + (
                "vit_pp",):
            raise ValueError(f"unknown model {self.name!r}")
        if self.pp_schedule not in PP_SCHEDULES:
            raise ValueError(f"unknown pp_schedule {self.pp_schedule!r}; "
                             "expected gpipe|1f1b|interleaved")
        if self.pp_microbatches < 1:
            raise ValueError(f"pp_microbatches must be >= 1, got "
                             f"{self.pp_microbatches}")
        if self.vocab_ce not in ("auto", "full", "sharded"):
            raise ValueError(f"unknown vocab_ce {self.vocab_ce!r}; expected "
                             "auto|full|sharded")
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
        if self.attention_core not in ATTENTION_CORES:
            raise ValueError(f"unknown attention_core {self.attention_core!r}"
                             f"; expected one of {ATTENTION_CORES}")
        if self.attention_block < 1:
            raise ValueError(f"attention_block must be >= 1, got "
                             f"{self.attention_block}")
        if self.param_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown param_dtype {self.param_dtype!r}; "
                             "expected float32|bfloat16")
        if self.moe_dispatch not in ("auto", "alltoall", "replicated"):
            raise ValueError(f"unknown moe_dispatch {self.moe_dispatch!r}; "
                             "expected auto|alltoall|replicated")
        if self.moe_experts < 0:
            raise ValueError(f"moe_experts must be >= 0, got "
                             f"{self.moe_experts}")
        if self.moe_experts > 0 and self.name == "mobilenet_v2":
            raise ValueError("ModelConfig.moe_experts is a field of the ViT "
                             "family and the LM; model 'mobilenet_v2' does "
                             "not read it")
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
                "checkpoint; the port takes a local .pth only, until ROADMAP "
                "Queue A item 2b's remainder (CIFAR-10 and the ImageNet .pth "
                "in the repository)")


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer config (reference: Adam 1e-4 + StepLR(10, 0.1)).

    ``grad_accum``: microbatches a step (strided rows of the batch), one
    update; ``clip_norm``: optax's ``clip_by_global_norm`` before the
    update, 0 = off; ``ema_decay``: an exponential moving average of
    the parameters and BN running statistics after every update, which
    eval and the best checkpoint read, 0 = off."""

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


@dataclass(frozen=True)
class MeshConfig:
    """The process mesh, tpunet's ``MeshConfig``: axes ``('data', 'seq',
    'pipe', 'model')``, one process (one card) a point. ``data`` -1 takes
    the processes the other axes leave. ``model`` > 1 is tensor
    parallelism (Megatron blocks for the ViT family and the LM);
    ``zero1`` shards the Adam moments over 'data' with the parameters
    replicated; ``fsdp`` shards the parameters, both moments and the EMA
    copies over 'data' and subsumes ``zero1``. ``seq`` > 1 is sequence
    parallelism (ring or Ulysses attention: the ranks of a 'seq' group
    read the same rows and each holds ``T / seq`` of the positions).
    ``pipe`` > 1 is pipeline parallelism (``vit_pp``/``lm_pp``: each
    rank of a 'pipe' group holds one stage's blocks)."""

    data: int = -1                    # -1 -> all remaining processes
    seq: int = 1                      # sequence/context-parallel axis
    pipe: int = 1                     # pipeline-parallel axis
    model: int = 1                    # tensor-parallel axis
    zero1: bool = False
    fsdp: bool = False

    def __post_init__(self):
        if (self.data == 0 or self.data < -1 or self.model < 1
                or self.seq < 1 or self.pipe < 1):
            raise ValueError(f"mesh axes must be >= 1 (data may be -1), "
                             f"got data={self.data} seq={self.seq} "
                             f"pipe={self.pipe} model={self.model}")

    def shape(self, n_devices: int) -> Tuple[int, int, int, int]:
        """(data, seq, pipe, model) for ``n_devices`` processes."""
        seq, pipe, model = max(1, self.seq), max(1, self.pipe), \
            max(1, self.model)
        data = (self.data if self.data > 0
                else max(1, n_devices // (seq * pipe * model)))
        return (data, seq, pipe, model)


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = "checkpoints"
    resume: bool = False


@dataclass(frozen=True)
class ServeConfig:
    """The production inference server (``tpunet_torch/serve/``), a copy
    of ``tpunet.config.ServeConfig`` with its defaults to the letter: a
    fixed pool of KV slots decoded together by one masked step
    (continuous batching), a bounded admission queue with backpressure,
    and a stdlib HTTP frontend. The comments below are tpunet's. int8 KV
    pages, the prefix spill store, speculative decoding and serve-tier
    chaos are ported; only the AOT warm start (``aot_cache``) is refused,
    with the reason in ``AOT_CACHE_SCOPED_OUT``."""

    host: str = "127.0.0.1"
    port: int = 8000
    # KV-slot pool size = max in-flight decodes = the jitted step's
    # batch dimension. Compiled once; sizing it is the HBM/latency
    # trade (docs/serving.md capacity guidance).
    slots: int = 8
    # Bounded admission: requests beyond this many waiting are REJECTED
    # (429 queue-full) instead of growing latency unboundedly.
    queue_max: int = 64
    # Prefill programs are compiled per padded prompt-length bucket —
    # the compile count is len(buckets), not one per prompt length.
    # Prompts longer than the largest bucket are rejected.
    prefill_buckets: Tuple[int, ...] = (32, 128, 512)
    # Paged KV cache (default ON; --no-paged-kv restores the dense
    # [slots, max_seq_len] pool): per layer, K/V live in a SHARED pool
    # of fixed-size pages addressed through per-slot page tables, so a
    # slot pins HBM proportional to its prompt+generated length — the
    # concurrent-slot multiplier at fixed HBM (docs/serving.md "Paged
    # KV cache & device-side sampling").
    paged_kv: bool = True
    # Usable data pages in the pool (0 = auto: slots *
    # ceil(max_seq_len / kv_page_tokens), i.e. dense-equivalent
    # capacity). Size it DOWN to oversubscribe slots against typical
    # request lengths; exhaustion defers admissions and, when nothing
    # can advance, preempts the youngest slot back to the queue with
    # its progress kept.
    kv_pages: int = 0
    # Tokens per KV page: the allocation granule. Smaller pages track
    # request length tighter (less tail waste) at more gather/table
    # overhead per step.
    kv_page_tokens: int = 16
    # KV page payload dtype: "auto" stores at the model compute dtype;
    # "bf16" halves float32 payloads; "int8" quantizes each written
    # token row against its own absmax (float32 scale stored with the
    # page, dequantized on gather; eval-parity-gated in
    # tests/test_serve_paged.py). Requires paged_kv.
    kv_dtype: str = "auto"
    # Device-side batched sampling (default ON; --no-device-sampling
    # restores the host loop): temperature/top-k/top-p and the
    # categorical draw run as one [slots]-wide jitted step fused onto
    # decode (per-slot PRNG keys folded per step) — only sampled
    # tokens cross the host boundary. Greedy output is token-identical
    # either way (parity-tested).
    device_sampling: bool = True
    # Prefix KV cache (default ON with paged_kv; --no-prefix-cache
    # disables): finished prefill pages stay in the pool as immutable,
    # content-addressed, refcounted objects keyed by token-prefix
    # digest at page granularity. Admission pins the longest cached
    # page-aligned prefix into the new slot's table and re-prefills
    # only the suffix (COW at the divergence page); LRU-evicted under
    # pool pressure — docs/serving.md "Prefix KV cache".
    prefix_cache: bool = True
    # Pool pages the prefix cache may hold (pinned + idle); 0 = auto
    # (half the usable pool). Bounding it below the pool keeps paying
    # slots from ever being starved by cached pages.
    prefix_cache_pages: int = 0
    # Shared-filesystem prefix spill/warm-start (--prefix-store DIR):
    # freshly-cached pages publish to DIR (content-digest tmp+rename,
    # flock first-writer-wins — the AOT store's commit discipline via
    # tpunet/utils/fsatomic.py), and a respawned or scaled-up replica
    # adopts the fleet's prefix set at boot so its first shared-prefix
    # request prefills only the suffix. Entries are scoped by model
    # config + kv levers + runtime, so a lever change is a clean miss.
    # Empty = per-replica cache only.
    prefix_store: str = ""
    # Per-request caps: default/max new tokens, and a wall-clock
    # deadline after which a request is cancelled and its slot freed
    # (0 = no deadline).
    default_max_new_tokens: int = 128
    max_new_tokens_cap: int = 1024
    default_deadline_s: float = 0.0
    # Classifier micro-batching: hold a /v1/classify request at most
    # this long to coalesce a batch, up to classify_batch_max images
    # per jitted batched forward.
    classify_batch_max: int = 8
    classify_window_ms: float = 2.0
    # Emit an ``obs_serve`` record (SLO counters/gauges/histograms)
    # every this many seconds; 0 disables periodic emission (records
    # still flush once on drain).
    emit_every_s: float = 10.0
    # Graceful-drain budget on SIGTERM: stop admitting, finish
    # in-flight work for up to this long, then cancel survivors.
    drain_timeout_s: float = 30.0
    # Replica identity on obs_serve records (fleet SLO rollups route
    # by it). Empty = "serve-<host>-<pid>".
    run_id: str = ""
    # AOT warm-start (--aot-cache DIR): tpunet's persistence of compiled
    # XLA executables. Out of scope here, and refused with the reason in
    # AOT_CACHE_SCOPED_OUT.
    aot_cache: str = ""
    # Serve-tier fault injection (--chaos, tpunet/serve/chaos.py):
    # deterministic SIGKILL/stall/probe-drop/slow-stream faults
    # addressed by generated-token count or prefill ordinal —
    # docs/serving.md "Mid-stream failover & serve-tier chaos". Empty
    # = no injector installed.
    chaos: str = ""
    # Standalone-serve request tracing (--trace-sample, docs/serving.md
    # "Request tracing"): head-sample this fraction of requests that
    # arrive WITHOUT trace headers, minting a trace_id locally. Under
    # a router the router decides (its headers win); a client-supplied
    # ``X-Trace-Id`` is always sampled. 0 = only header-carried traces.
    trace_sample: float = 0.0
    # Speculative decoding (--spec-decode, docs/serving.md
    # "Speculative decoding"): a small drafter model proposes spec_k
    # tokens per active slot against its OWN paged KV pool, then the
    # main model verifies every slot's drafts in ONE [slots, K+1]-wide
    # jitted forward over the existing pool — up to K+1 verified
    # tokens per slot per verify. Every emitted token comes from the
    # VERIFY distribution, so greedy output is bitwise-identical to
    # spec-off and sampled output stays deterministic per (seed, step)
    # (failover/replay safe). Rejection rewinds the slot's page-table
    # cursor to the last accepted position and recycles the tail
    # pages. Requires paged_kv AND device_sampling.
    spec_decode: bool = False
    # Draft tokens proposed per verify cycle (the K in draft-then-
    # verify). Higher K amortizes the verify gather over more tokens
    # but wastes drafter work when acceptance is low — docs/serving.md
    # "Speculative decoding" has the tuning math.
    spec_k: int = 4
    # Drafter width multiplier on the serving model's vit_hidden
    # (rounded to stay divisible by vit_heads). 1.0 shares the main
    # model's parameters (self-speculation — useful for parity tests,
    # never a throughput win); < 1.0 builds a second, narrower model
    # instance whose parameters come from --spec-draft-checkpoint or
    # a deterministic init.
    spec_draft_width_mult: float = 0.5
    # Drafter parameters (.npz from tpunet/serve/spec.py
    # ``save_drafter_params``; empty = deterministic random init,
    # which accepts ~nothing — fit or distill a drafter against real
    # traffic, e.g. ``spec.fit_drafter`` as bench_serve.py --spec
    # does).
    spec_draft_checkpoint: str = ""

    def __post_init__(self):
        # The engine checks the item-5 levers against each other (int8
        # and spec need the paged pool, spec needs device sampling), as
        # tpunet's does; only the AOT warm start stays out.
        if self.aot_cache:
            raise NotImplementedError(AOT_CACHE_SCOPED_OUT)


@dataclass(frozen=True)
class RouterConfig:
    """Routing + autoscaling front tier (tpunet_torch/router/,
    docs/serving.md "Routing & autoscaling"): a stdlib-threaded HTTP
    proxy that spreads /v1/generate + /v1/classify over N serve
    replicas (least-loaded with session/prefix affinity), evicts and
    respawns unhealthy replicas, and emits hysteresis scale-up/down
    decisions as ``obs_router`` records. tpunet's fields and defaults,
    plus ``aot_cache``, which is refused."""

    host: str = "127.0.0.1"
    port: int = 8100
    # Health/load probe cadence against each replica's /healthz +
    # /metrics; a probe slower than probe_timeout_s counts as a
    # failure, and unhealthy_after consecutive failures evict.
    probe_interval_s: float = 1.0
    probe_timeout_s: float = 2.0
    unhealthy_after: int = 3
    # Session/prefix affinity: requests with the same "session" field
    # (or the same first affinity_prefix prompt tokens/bytes) hash to
    # a stable preferred replica so shared-prompt traffic lands on
    # warm KV — unless the preferred replica's load score exceeds the
    # least-loaded replica's by more than affinity_slack (fraction of
    # its pool), in which case least-loaded wins.
    affinity_prefix: int = 16
    affinity_slack: float = 0.5
    # Re-route budget: a request that hits a dead/draining replica is
    # retried against another replica up to route_retries times (only
    # before any response byte reached the client).
    route_retries: int = 2
    # Per-proxied-request socket timeout toward a replica.
    request_timeout_s: float = 600.0
    # obs_router window record cadence (0 = final record only).
    emit_every_s: float = 10.0
    # Autoscale hysteresis over fleet queue depth per slot (and TTFT
    # SLO burn when ttft_slo_ms > 0): the condition must hold for
    # scale_window_probes consecutive probe rounds to fire, and after
    # any action the policy holds for scale_cooldown_s.
    scale_up_queue_per_slot: float = 1.0
    scale_down_queue_per_slot: float = 0.1
    scale_window_probes: int = 5
    scale_cooldown_s: float = 60.0
    min_replicas: int = 1
    max_replicas: int = 8
    # TTFT SLO (ms): fleet TTFT p99 above it counts as SLO burn > 1
    # and arms scale-up like queue pressure; 0 disables the term.
    ttft_slo_ms: float = 0.0
    # Drain-then-restart budget: SIGTERM -> graceful drain for up to
    # this long -> SIGKILL; in-flight streams finish inside it.
    drain_grace_s: float = 30.0
    # Boot grace: probe failures while a replica is STARTING (loading
    # weights, warming/deserializing programs) don't count toward
    # eviction until this much time has passed since its (re)spawn.
    boot_timeout_s: float = 120.0
    # Backoff before respawning an evicted/dead replica child.
    respawn_backoff_s: float = 1.0
    # Mid-stream failover (--failover / --no-failover, docs/serving.md
    # "Mid-stream failover & serve-tier chaos"): the frontend journals
    # every streamed /v1/generate request (prompt, sampling params,
    # relayed tokens) and, when the serving replica dies mid-stream,
    # re-submits to a survivor with ``resume_tokens`` — the client's
    # ndjson stream continues with no error frame (greedy:
    # token-identical; sampled: deterministic per (seed, step)).
    failover: bool = True
    # Per-request journal bound: a stream that has relayed more than
    # this many tokens is no longer failover-protected (on replica
    # death it gets the honest error frame — the documented
    # degradation mode). Bounds router memory per in-flight stream.
    failover_journal_tokens: int = 4096
    # Resume attempts per request after a mid-stream replica death
    # (each attempt picks a different surviving replica).
    failover_retries: int = 2
    # Serve-tier fault injection forwarded to spawned replicas
    # (--chaos, tpunet_torch/serve/chaos.py grammar plus a
    # ``:replica=I`` scope key naming the child index; unscoped events
    # reach every child). Empty = no injection.
    chaos: str = ""
    # End-to-end request tracing (--trace-sample, docs/serving.md
    # "Request tracing"): the frontend mints a trace_id per request
    # and head-samples this fraction of them (deterministic on the
    # id); sampled requests carry ``X-Trace-Id`` to every replica hop
    # — including failover re-submits — and every layer records trace
    # breadcrumbs + an ``obs_trace`` record. A client-supplied
    # ``X-Trace-Id`` is always sampled (explicit opt-in).
    trace_sample: float = 0.01
    # Tail capture for the requests sampling missed
    # (--no-trace-all-on-error disables): an UNsampled request that
    # hits a mid-stream failover or errors still gets a router-hop
    # ``obs_trace`` record — replica-side phases are absent (the
    # replicas never saw trace context), but the seam and outcome are
    # on the books.
    trace_all_on_error: bool = True
    # Synthetic canary probing (--probe-every-s,
    # tpunet_torch/router/prober.py, docs/serving.md "SLOs & probing"):
    # every this many seconds the router issues a pinned greedy
    # known-answer request through its OWN public endpoint — the full
    # proxy path — and judges availability, TTFT/e2e latency, and
    # bitwise golden-output correctness from the client's side, feeding
    # the SLO engine's SLI streams. Each probe carries a minted
    # always-sampled X-Trace-Id, so a failed or slow probe points at a
    # replayable trace. 0 = off.
    probe_every_s: float = 0.0
    # SLO policy file (--slo-policy, docs/slos.json format:
    # objectives + compliance windows + multi-window burn-rate alert
    # rules; full-line // comments allowed). Arming it (or the
    # prober) starts the tpunet_torch/obs/slo.py engine: obs_slo
    # records, slo_* gauges, and edge-latched fast-burn pages / slow-burn
    # tickets through the obs_alert webhook path. Empty = built-in
    # default policy when the prober is armed, otherwise off.
    slo_policy: str = ""
    # Router identity on obs_router records (empty =
    # "router-<host>-<pid>").
    run_id: str = ""
    # The shared AOT program store that tpunet's router forwards to its
    # children (its --aot-cache); out of scope here, as in ServeConfig.
    aot_cache: str = ""

    def __post_init__(self):
        if self.aot_cache:
            raise NotImplementedError(AOT_CACHE_SCOPED_OUT)


@dataclass(frozen=True)
class ExportConfig:
    """Live telemetry export (tpunet_torch/obs/export/): push finished obs
    records to off-host endpoints through a bounded queue drained by a
    background thread — a dead endpoint can never stall a step; full
    queues drop and count (``export_*_dropped``). Coordinator-only,
    like the metrics.jsonl writes."""

    statsd: str = ""                  # "HOST:PORT" UDP statsd endpoint
    statsd_prefix: str = "tpunet"
    http: str = ""                    # line-JSON POST URL
    # Alert webhook (tpunet_torch/obs/export/webhook.py): POST one templated
    # JSON payload per obs_alert / obs_crash / obs_regression record
    # (--obs-webhook URL). Retries with backoff; exhausted pages land
    # in the dead-letter list and the webhook_dead_letter counter.
    webhook: str = ""
    webhook_max_retries: int = 3
    webhook_backoff_s: float = 0.25
    # Bounded export queue: put_nowait from the step path; overflow
    # drops (counted) rather than blocking.
    queue_size: int = 1024
    # close() flush budget and the per-request HTTP socket timeout.
    flush_timeout_s: float = 5.0
    http_timeout_s: float = 1.0


@dataclass(frozen=True)
class ObsConfig:
    """Step-level observability (tpunet_torch/obs/): per-step timing
    histograms, throughput/MFU and input-stall accounting, epoch-
    boundary device-memory gauges and multi-host heartbeat, all
    emitted as ``obs_epoch`` records into ``metrics.jsonl``.

    The default path is deliberately sync-free: every number is a
    host-side ``perf_counter`` lap or an epoch-boundary runtime query,
    so enabling it adds no device round-trips to the step loop."""

    enabled: bool = True
    # Emit an ``obs_step`` record every N steps (0 = per-epoch records
    # only). Host-side values only — no device sync either way.
    step_records_every: int = 0
    # Windowed profiling: capture a torch.profiler trace for exactly
    # [profile_start_step, profile_start_step + profile_num_steps).
    # num_steps == 0 traces from start_step to the end of the run
    # (with both at 0 and --profile-dir set: the old whole-run trace);
    # either knob without --profile-dir writes under
    # <checkpoint-dir>/profile.
    profile_start_step: int = 0
    profile_num_steps: int = 0
    # Histogram memory bound: windows beyond this many observations
    # switch from exact percentiles to seeded reservoir sampling
    # (count/mean stay exact; the summary carries ``approx: 1``).
    histogram_max_samples: int = 65536
    # --obs-hbm-attrib: once, at the first step, AOT-compile the train
    # step and decompose its cost-analysis HBM bytes by op category
    # into the hbm_bytes_per_image_* gauge family
    # (tpunet/obs/hlo_bytes.py). Off by default: the extra lowering is
    # one redundant compile (cheap under the persistent cache, not
    # free).
    hbm_attrib: bool = False
    # -- run-health watchdog (tpunet_torch/obs/health.py) -----------
    # A step slower than stall_factor x the rolling median (and at
    # least stall_min_s) emits a step_stall obs_alert. 0 disables.
    stall_factor: float = 10.0
    stall_min_s: float = 1.0
    # A host-available loss above loss_spike_factor x its warmed-up
    # EMA emits a loss_spike alert (non-finite always alerts). 0
    # disables spike detection.
    loss_spike_factor: float = 5.0
    # No heartbeat for this long emits stale_heartbeat; 0 (default)
    # disables — epoch length varies too much for a universal budget.
    heartbeat_timeout_s: float = 0.0
    # Same-reason alerts within this many steps are suppressed
    # (counted in obs_alerts_suppressed) so a stall pages once.
    alert_cooldown_steps: int = 50
    # Fatal alerts raise RunUnhealthyError instead of just recording:
    # the --halt-on-unhealthy knob, for runs nobody is watching.
    halt_on_unhealthy: bool = False
    # Run identity (docs/metrics_schema.md "Run identity"): every
    # emitted record is stamped run_id/process_index/host so a fleet
    # aggregator can route streams. Empty = generate (and persist
    # under <checkpoint-dir>/run_id; --resume reuses it, so a
    # preemption restore continues the same stream).
    run_id: str = ""
    # Operator GaugePredicate alert rules over exported gauges,
    # evaluated each epoch against registry.snapshot(): "NAME > N",
    # "NAME < N", or "NAME + N/s" (growth rate). Fired rules emit
    # gauge_predicate obs_alerts (--obs-rule, repeatable).
    gauge_rules: Tuple[str, ...] = ()
    # Proactive checkpoint-and-evict (--evict-on-straggler,
    # docs/elasticity.md): a straggler-shaped watchdog alert on THIS
    # replica (step_stall / thread_stalled) triggers the agreed stop
    # with an evict marker — the pod checkpoints now and re-meshes
    # without the slow host instead of letting it stall every step.
    # Off by default; meaningful under the elastic agent
    # (tpunet_torch/elastic/).
    evict_on_straggler: bool = False
    # -- flight recorder (tpunet_torch/obs/flightrec/) --------------
    # Always-on black box: a crash-durable mmap ring of recent
    # structured events, faulthandler + native SIGSEGV/SIGABRT/SIGBUS
    # hooks, the host-thread registry, and a post-mortem watcher that
    # materializes <checkpoint-dir>/flightrec/crash_report.json when
    # the process dies uncleanly. Near-zero cost (~1-2 us per event,
    # no syscalls on the step path); --no-flightrec disables.
    flightrec: bool = True
    # Event-ring capacity (slots; the file is ~120 bytes per slot).
    flightrec_events: int = 1024
    export: ExportConfig = field(default_factory=ExportConfig)

    def __post_init__(self):
        if self.hbm_attrib:
            raise NotImplementedError(
                "ObsConfig.hbm_attrib (--obs-hbm-attrib) is scoped out of "
                "tpunet_torch: it parses XLA HLO and xprof output and has "
                "no torch counterpart")


@dataclass(frozen=True)
class TrainConfig:
    """Top-level training config."""

    epochs: int = 20                  # reference EPOCHS
    seed: int = 42                    # reference torch.manual_seed(42)
    # Fault injection (--chaos, tpunet_torch/elastic/chaos.py):
    # deterministic SIGKILL/SIGTERM/slow-host/checkpoint-IO faults
    # addressed by step or save ordinal — docs/elasticity.md "Chaos spec
    # grammar". Empty = no injector installed.
    chaos: str = ""
    eval_only: bool = False
    log_every_steps: int = 0          # 0 -> per-epoch only, like the reference
    profile_dir: str = ""             # non-empty -> torch.profiler traces
    # Preemption grace window (--preempt-grace-s): seconds the platform
    # grants after SIGTERM; the preemption save's wait is bounded by
    # what remains of it (0 = unbounded).
    preempt_grace_s: float = 0.0
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    def __post_init__(self):
        # tpunet's cross-checks (tpunet/train/loop.py:55-66, 159-176).
        is_lm = self.model.name in LM_NAMES
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
                "dense", "flash", "auto", "ulysses"):
            raise ValueError(
                f"--pack-docs needs a segment-capable attention core "
                f"(dense/flash/auto, or ulysses for packed x SP), got "
                f"{self.model.attention!r} — ring's state-merging core has "
                "no segment operands")
        if self.mesh.seq > 1 and (self.model.attention not in SEQ_ATTENTIONS
                                  or self.model.name == "mobilenet_v2"):
            # The port shards the tokens over 'seq' (tpunet leaves them
            # to GSPMD): a local core would attend within a shard only.
            raise ValueError(
                f"--mesh-seq {self.mesh.seq} shards a ViT's or the LM's "
                "token sequence over the 'seq' axis; it needs --attention "
                f"ring or ulysses, got model {self.model.name!r} with "
                f"attention {self.model.attention!r}")

    @property
    def is_lm(self) -> bool:
        return self.model.name in LM_NAMES

    @property
    def is_pipelined(self) -> bool:
        return self.model.name in PIPE_NAMES

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
