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
    """The production inference server (``tpunet_torch/serve/``), a copy
    of ``tpunet.config.ServeConfig`` with its defaults to the letter: a
    fixed pool of KV slots decoded together by one masked step
    (continuous batching), a bounded admission queue with backpressure,
    and a stdlib HTTP frontend. The comments below are tpunet's. Fields
    of the features not ported yet are refused away from their defaults,
    each with its ROADMAP item: int8 KV pages, the prefix spill store,
    speculative decoding, the AOT warm start and serve-tier chaos."""

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
    # Off by default; meaningful under the elastic agent.
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
        _refuse_unported(self, {
            "evict_on_straggler": "Queue A item 9 (the elastic agent)"})


@dataclass(frozen=True)
class TrainConfig:
    """Top-level training config."""

    epochs: int = 20                  # reference EPOCHS
    seed: int = 42                    # reference torch.manual_seed(42)
    eval_only: bool = False
    log_every_steps: int = 0          # 0 -> per-epoch only, like the reference
    profile_dir: str = ""             # non-empty -> torch.profiler traces
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    obs: ObsConfig = field(default_factory=ObsConfig)

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
