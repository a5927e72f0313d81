"""``python -m tpunet_torch.train``: the training CLI, port of
``tpunet/main.py`` over the flags the port honours.

    python -m tpunet_torch.train --preset single              # on the card
    python -m tpunet_torch.train --preset serial --dataset synthetic \\
        --image-size 32 --width-mult 0.5 --dtype float32 --device cpu
    python -m tpunet_torch.train --model vit_base                 # ViT-B/16
    python -m tpunet_torch.train --model lm --dataset synthetic_lm  # the LM
    python -m tpunet_torch.train --model lm --dataset text_lm \
        --text-file corpus.txt --pack-docs                    # packed docs
    python -m tpunet_torch.train --pretrained w.pth --mixup 0.2 \\
        --cutmix 1.0 --ema-decay 0.999 --block-remat         # fine-tuning
    torchrun --standalone --nproc-per-node N -m tpunet_torch.train \
        --preset distributed                                  # N ranks
    torchrun --standalone --nproc-per-node 4 -m tpunet_torch.train \
        --preset distributed --model vit_base --mesh-model 2 --fsdp
                                            # data 2 x model 2, FSDP
    torchrun --standalone --nproc-per-node 8 -m tpunet_torch.train \
        --preset distributed --model lm --dataset synthetic_lm \
        --attention ring --mesh-data 2 --mesh-seq 4   # data 2 x seq 4
    torchrun --standalone --nproc-per-node 8 -m tpunet_torch.train \
        --preset distributed --model vit --attention ring \
        --moe-experts 8 --mesh-data 2 --mesh-seq 2 --mesh-model 2
                                            # ViT-MoE, experts over 'model'
    torchrun --standalone --nproc-per-node 2 -m tpunet_torch.train \
        --preset distributed --model lm_pp --dataset synthetic_lm \
        --mesh-pipe 2 --pp-schedule 1f1b --pp-microbatches 4
                                            # two pipeline stages

Presets: ``serial`` (batch 64), ``single`` (batch 128), ``distributed``
(128 a rank: data parallelism, the reference's MPI script). Under
``distributed`` each process joins the process group first, even alone
(one card still reduces through NCCL), from the launcher's ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``;
``--batch-size`` is per rank of the mesh's 'data' axis, and the global
batch is that times the axis (the world divided by ``--mesh-model``);
rank 0 materialises the dataset while the others wait; the group is
left on exit. ``--mesh-data``/``--mesh-model`` lay the ranks out as
tpunet's mesh, ``--zero1`` and ``--fsdp`` shard the state over 'data',
``--vocab-ce`` picks the LM's loss; ``--moe-experts E`` (with
``--moe-top-k``, ``--moe-every``, ``--moe-capacity-factor``,
``--moe-aux-weight`` and ``--moe-dispatch``) makes every second block of
the ViT family and the LM an MoE block, its experts split over
``--mesh-model``; ``--mesh-seq S`` with ``--attention
ring`` or ``ulysses`` (and ``--attention-core``) is sequence parallelism:
the S ranks of a 'seq' group read the same rows and each holds T / S of
the positions; ``--mesh-pipe P`` with ``--model vit_pp`` or ``lm_pp``
is pipeline parallelism (``--pp-microbatches``, ``--pp-schedule
gpipe|1f1b|interleaved``, ``--pp-virtual``): the P ranks of a 'pipe'
group read the same rows and each holds one stage of the blocks.
SIGTERM stops a run at a step boundary with its
state saved (every rank at the same step) and exits 0; ``--resume``
re-runs the interrupted epoch. ``--chaos SPEC`` injects tpunet's
faults (docs/elasticity.md) and ``--evict-on-straggler`` evicts a slow
replica, both for runs under ``python -m tpunet_torch.elastic``, which
gives each generation's child its world and ``--resume``. Any other flag of tpunet's CLI is refused
with an error, never ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys

from tpunet_torch.config import preset
from tpunet_torch.parallel import dist
from tpunet_torch.parallel.mesh import set_mesh
from tpunet_torch.utils import log0


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m tpunet_torch.train",
                                description="tpunet_torch trainer")
    p.add_argument("--preset", default="single",
                   choices=["serial", "single", "distributed"])
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="batch a step; per rank under --preset distributed")
    p.add_argument("--eval-batch-size", type=int, default=None,
                   help="eval batch (default: --batch-size)")
    p.add_argument("--image-size", type=int, default=None)
    p.add_argument("--lr", type=float, default=None)
    p.add_argument("--lr-schedule", default=None,
                   choices=["step", "cosine", "constant"],
                   help="step = the reference's StepLR(10, 0.1)")
    p.add_argument("--warmup-epochs", type=float, default=None)
    p.add_argument("--label-smoothing", type=float, default=None)
    p.add_argument("--optimizer", default=None,
                   choices=["adam", "adamw", "sgd"],
                   help="adam is the reference stack; adamw activates "
                        "--weight-decay; sgd uses momentum 0.9")
    p.add_argument("--weight-decay", type=float, default=None)
    p.add_argument("--clip-norm", type=float, default=None,
                   help="global gradient-norm clip; 0 = off")
    p.add_argument("--grad-accum", type=int, default=None,
                   help="microbatches accumulated per optimizer step "
                        "(strided rows of the batch)")
    p.add_argument("--ema-decay", type=float, default=None,
                   help="parameter EMA decay (e.g. 0.999); eval and the "
                        "best checkpoint use the EMA weights; 0 = off")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--dataset", default=None,
                   choices=["cifar10", "synthetic", "synthetic_lm",
                            "text_lm"])
    p.add_argument("--text-file", default=None,
                   help="byte-level corpus file for --dataset text_lm")
    p.add_argument("--pack-docs", action="store_true",
                   help="text_lm: pack newline-delimited documents into "
                        "seq_len rows with segment-masked attention and "
                        "loss (no cross-document attention/prediction)")
    p.add_argument("--seq-len", type=int, default=None,
                   help="sequence length for token datasets (model lm)")
    p.add_argument("--max-seq-len", type=int, default=None,
                   help="LM position-table size (defaults to at least "
                        "--seq-len)")
    p.add_argument("--vocab-size", type=int, default=None,
                   help="vocab for the lm model + synthetic_lm data")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--no-download", action="store_true",
                   help="never fetch CIFAR-10/pretrained weights over "
                        "the network; fail with drop-in instructions "
                        "instead (reference auto-downloads, :97)")
    p.add_argument("--pretrained", default=None, metavar="PATH|auto",
                   help="torch MobileNetV2 state_dict to load (the "
                        "backbone; a head of another class count is "
                        "left fresh); 'auto' fetches torchvision's "
                        "ImageNet checkpoint, which the port refuses "
                        "(a download)")
    p.add_argument("--no-native-loader", action="store_true",
                   help="force the pure-numpy host batch path")
    p.add_argument("--mixup", type=float, default=None, metavar="ALPHA",
                   help="mixup Beta(a,a) strength for image models; "
                        "0 = off")
    p.add_argument("--cutmix", type=float, default=None, metavar="ALPHA",
                   help="CutMix Beta(a,a) strength; with --mixup, each "
                        "step picks one at random")
    p.add_argument("--synthetic-size", type=int, default=None,
                   help="train-set size when --dataset synthetic (test: "
                        "a quarter of it)")
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--eval-only", action="store_true",
                   help="evaluate the saved checkpoint (best.pth if "
                        "present, else state.pt) and exit")
    p.add_argument("--pallas-depthwise", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="route the 3x3 depthwise convs through the "
                        "hand-written kernels (tpunet's flag name)")
    p.add_argument("--fused-ir", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="train-mode expand/project 1x1 convs through the "
                        "fused conv + BN-statistics kernels (default on)")
    p.add_argument("--model", default=None,
                   choices=["mobilenet_v2", "vit", "vit_tiny", "vit_small",
                            "vit_base", "vit_pp", "lm", "lm_pp"])
    p.add_argument("--pp-microbatches", type=int, default=None,
                   help="GPipe microbatches per step (vit_pp)")
    p.add_argument("--pp-schedule", default=None,
                   choices=["gpipe", "1f1b", "interleaved"],
                   help="pipeline schedule: gpipe (AD backward), 1f1b "
                        "(manual-VJP backward, bounded activation "
                        "memory), or interleaved (virtual stages: "
                        "--pp-virtual chunks per device, ~v-fold "
                        "smaller bubble at 1F1B-style memory)")
    p.add_argument("--pp-virtual", type=int, default=None,
                   help="chunks per device for --pp-schedule "
                        "interleaved (depth must divide pipe x v)")
    p.add_argument("--vit-patch", type=int, default=None)
    p.add_argument("--vit-hidden", type=int, default=None)
    p.add_argument("--vit-depth", type=int, default=None)
    p.add_argument("--vit-heads", type=int, default=None)
    p.add_argument("--vit-mlp-ratio", type=float, default=None)
    p.add_argument("--attention", default=None,
                   choices=["auto", "dense", "blockwise", "flash", "ring",
                            "ulysses"],
                   help="ViT/LM attention core: auto and flash run the "
                        "hand-written flash kernels on the card; ring and "
                        "ulysses are sequence-parallel over the mesh "
                        "'seq' axis")
    p.add_argument("--attention-block", type=int, default=None,
                   help="K/V chunk for --attention blockwise; the TPU "
                        "block size of --attention flash")
    p.add_argument("--attention-core", default=None,
                   choices=["auto", "flash", "blockwise"],
                   help="local core inside --attention ring/ulysses: auto "
                        "and flash run the flash kernels on the card, "
                        "blockwise the plain online softmax")
    p.add_argument("--remat", action="store_true",
                   help="rematerialize encoder blocks (less activation "
                        "memory, ~1/3 more backward FLOPs)")
    p.add_argument("--zero1", action="store_true",
                   help="shard optimizer moments over the 'data' axis "
                        "(ZeRO-1); params stay replicated")
    p.add_argument("--fsdp", action="store_true",
                   help="fully-sharded data parallelism (ZeRO-3): shard "
                        "params and optimizer moments over 'data'; "
                        "weights are all-gathered just-in-time")
    p.add_argument("--vocab-ce", default=None,
                   choices=["auto", "sharded", "full"],
                   help="LM loss lowering: vocab-sharded logits + CE "
                        "over the mesh 'model' axis (full [B,T,V] "
                        "logits never materialize) vs the full-logits "
                        "path (auto shards when the axis divides the "
                        "vocab)")
    p.add_argument("--moe-experts", type=int, default=None,
                   help="experts per MoE block (vit/lm); 0 = dense MLPs")
    p.add_argument("--moe-top-k", type=int, default=None)
    p.add_argument("--moe-every", type=int, default=None)
    p.add_argument("--moe-capacity-factor", type=float, default=None)
    p.add_argument("--moe-aux-weight", type=float, default=None)
    p.add_argument("--moe-dispatch", default=None,
                   choices=["auto", "alltoall", "replicated"],
                   help="expert-parallel token dispatch: GShard "
                        "all_to_all capacity buffers vs replicated "
                        "routing + psum (auto prefers alltoall when "
                        "shapes divide)")
    p.add_argument("--mesh-data", type=int, default=None)
    p.add_argument("--mesh-seq", type=int, default=None,
                   help="sequence-parallel axis size (ring/ulysses "
                        "attention)")
    p.add_argument("--mesh-pipe", type=int, default=None,
                   help="pipeline-parallel axis size (vit_pp/lm_pp)")
    p.add_argument("--mesh-model", type=int, default=None,
                   help="tensor-parallel axis size")
    p.add_argument("--block-remat", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="MobileNetV2: recompute inverted-residual "
                        "elementwise epilogues in backward, saving "
                        "only conv outputs + BN stats as residuals "
                        "(default off)")
    p.add_argument("--width-mult", type=float, default=None)
    p.add_argument("--dropout-rate", type=float, default=None)
    p.add_argument("--dtype", default=None, choices=["bfloat16", "float32"])
    p.add_argument("--param-dtype", default=None,
                   choices=["float32", "bfloat16"],
                   help="parameter/optimizer-state storage dtype "
                        "(default float32 master params; --dtype "
                        "stays the compute dtype)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--log-every-steps", type=int, default=None,
                   help="a step/loss/lr line every N steps (0 = per epoch "
                        "only, like the reference)")
    # Observability (tpunet_torch/obs/): tpunet's flags, names and help.
    p.add_argument("--profile-dir", default=None,
                   help="torch.profiler trace output directory; combine "
                        "with --profile-start-step/--profile-num-steps "
                        "to capture a step window instead of the run")
    p.add_argument("--profile-start-step", type=int, default=None,
                   help="global step at which the profiler trace "
                        "starts (alone: traces to the end of the run, "
                        "under <checkpoint-dir>/profile unless "
                        "--profile-dir is set)")
    p.add_argument("--profile-num-steps", type=int, default=None,
                   help="steps to trace from --profile-start-step "
                        "(0 = until the end of the run); without "
                        "--profile-dir the trace lands under "
                        "<checkpoint-dir>/profile")
    p.add_argument("--no-obs", action="store_true",
                   help="disable the observability subsystem (no "
                        "obs_* records, spans, or step timing)")
    p.add_argument("--obs-step-every", type=int, default=None,
                   help="emit a per-step obs_step record every N "
                        "steps (0 = per-epoch obs records only)")
    p.add_argument("--flightrec", default=None,
                   action=argparse.BooleanOptionalAction,
                   help="black-box flight recorder (default on): "
                        "crash-durable event ring + crash handlers "
                        "that leave <checkpoint-dir>/flightrec/"
                        "crash_report.json (ring tail, per-thread "
                        "stacks) when the "
                        "process dies; render with "
                        "python -m tpunet_torch.obs.cli.crash_report")
    p.add_argument("--flightrec-events", type=int, default=None,
                   help="flight-recorder event-ring capacity (slots)")
    p.add_argument("--obs-hbm-attrib", action="store_true",
                   help="decompose the compiled train step's HBM "
                        "bytes by op category into the "
                        "hbm_bytes_per_image_* gauges once at the "
                        "first step (one extra AOT lowering)")
    p.add_argument("--statsd", default=None, metavar="HOST:PORT",
                   help="stream obs records as statsd/UDP gauges to "
                        "this endpoint (non-blocking: bounded queue + "
                        "background sender; drops are counted)")
    p.add_argument("--obs-http", default=None, metavar="URL",
                   help="POST obs records as line-JSON to this URL "
                        "(same non-blocking queue; pair with "
                        "'scripts/obs_dashboard.py --listen PORT')")
    p.add_argument("--obs-webhook", default=None, metavar="URL",
                   help="POST one templated JSON payload per alert "
                        "record (obs_alert/obs_crash/obs_regression) "
                        "to this URL — retried with backoff, "
                        "dead-lettered after webhook_max_retries "
                        "(wire format in docs/metrics_schema.md)")
    p.add_argument("--obs-queue-size", type=int, default=None,
                   help="bounded export queue depth (overflow drops "
                        "records and counts them, never blocks a step)")
    p.add_argument("--obs-hist-samples", type=int, default=None,
                   help="histogram reservoir bound "
                        "(histogram_max_samples): windows beyond this "
                        "many observations switch from exact "
                        "percentiles to seeded reservoir sampling")
    p.add_argument("--alert-cooldown-steps", type=int, default=None,
                   help="suppress same-reason obs_alerts within this "
                        "many steps (counted in obs_alerts_suppressed) "
                        "so a stall pages once")
    p.add_argument("--evict-on-straggler", action="store_true",
                   help="straggler-shaped watchdog alerts (step_stall"
                        "/thread_stalled) on this replica trigger "
                        "checkpoint-now-then-evict through the agreed "
                        "stop — the elastic agent re-meshes the pod "
                        "without the slow host (docs/elasticity.md)")
    p.add_argument("--chaos", default=None, metavar="SPEC",
                   help="deterministic fault injection "
                        "(docs/elasticity.md): e.g. 'kill@step=5', "
                        "'kill@ckpt=2', 'sigterm@step=8:again=1', "
                        "'slow@step=10:delay=1:steps=3', "
                        "'ioerr@save=1:fails=2'; ';'-separated, "
                        "host=H scopes one process")
    p.add_argument("--preempt-grace-s", type=float, default=None,
                   help="SIGTERM grace window the platform grants: "
                        "the preemption save's durability wait is "
                        "bounded by what remains of it, and a second "
                        "SIGTERM escalates to immediate "
                        "checkpoint-abandon exit (0 = unbounded)")
    p.add_argument("--halt-on-unhealthy", action="store_true",
                   help="abort the run (RunUnhealthyError) on a fatal "
                        "obs_alert: step stall, NaN/spiking loss, or "
                        "missing processes — after the alert record "
                        "is written")
    p.add_argument("--stall-factor", type=float, default=None,
                   help="step_stall alert threshold: a step slower "
                        "than FACTOR x the rolling median (and at "
                        "least --stall-min-s); 0 disables")
    p.add_argument("--stall-min-s", type=float, default=None,
                   help="absolute floor (seconds) a step must exceed "
                        "to count as stalled")
    p.add_argument("--loss-spike-factor", type=float, default=None,
                   help="loss_spike alert threshold: loss above "
                        "FACTOR x its EMA; 0 disables")
    p.add_argument("--heartbeat-timeout", type=float, default=None,
                   metavar="SECONDS",
                   help="stale_heartbeat alert when no epoch "
                        "heartbeat lands for this long (0 = off)")
    p.add_argument("--run-id", default=None,
                   help="explicit run identity stamped on every obs "
                        "record (default: generated and persisted "
                        "under <checkpoint-dir>/run_id; --resume "
                        "reuses it)")
    p.add_argument("--obs-rule", action="append", default=None,
                   metavar="RULE",
                   help="GaugePredicate alert rule over any registry "
                        "snapshot key, e.g. 'mfu < 0.3', "
                        "'step_time_s_p99 > 2', "
                        "'mem_peak_bytes_in_use + 1e6/s' (growth per "
                        "second); repeatable, checked each epoch")
    return p


def _parse(argv=None) -> argparse.Namespace:
    parser = build_argparser()
    args, unknown = parser.parse_known_args(argv)
    if unknown:
        parser.error(f"unrecognized arguments: {' '.join(unknown)} "
                     "(tpunet flags that tpunet_torch does not honour yet "
                     "are refused; ROADMAP Queue A lists what is ported)")
    return args


def config_from_args(argv=None):
    """(TrainConfig, device) of the command line ``argv``."""
    args = _parse(argv)
    return _config(args), args.device


def _config(args: argparse.Namespace):
    cfg = preset(args.preset)
    data, model, optim, ckpt = cfg.data, cfg.model, cfg.optim, cfg.checkpoint
    for dest, obj_field in (("batch_size", "batch_size"),
                            ("eval_batch_size", "eval_batch_size"),
                            ("image_size", "image_size"),
                            ("dataset", "dataset"), ("data_dir", "data_dir")):
        val = getattr(args, dest)
        if val is not None:
            data = dataclasses.replace(data, **{obj_field: val})
    if args.synthetic_size is not None:
        data = dataclasses.replace(
            data, synthetic_train_size=args.synthetic_size,
            synthetic_test_size=max(1, args.synthetic_size // 4))
    if args.text_file is not None:
        data = dataclasses.replace(data, text_path=args.text_file)
    if args.pack_docs:
        data = dataclasses.replace(data, pack_docs=True)
    if args.seq_len is not None:
        data = dataclasses.replace(data, seq_len=args.seq_len)
    if args.no_native_loader:
        data = dataclasses.replace(data, native_loader=False)
    if args.no_download:
        data = dataclasses.replace(data, download=False)
    if args.mixup is not None:
        data = dataclasses.replace(data, mixup_alpha=args.mixup)
    if args.cutmix is not None:
        data = dataclasses.replace(data, cutmix_alpha=args.cutmix)
    fields = {}
    for dest, obj_field in (("model", "name"),
                            ("pallas_depthwise", "use_pallas_depthwise"),
                            ("fused_ir", "fused_ir"),
                            ("width_mult", "width_mult"),
                            ("dropout_rate", "dropout_rate"),
                            ("dtype", "dtype"),
                            ("param_dtype", "param_dtype"),
                            ("pretrained", "pretrained_path"),
                            ("block_remat", "block_remat")) + tuple(
            (f, f) for f in ("vit_patch", "vit_hidden", "vit_depth",
                             "vit_heads", "vit_mlp_ratio", "attention",
                             "attention_block", "attention_core",
                             "moe_experts", "moe_top_k", "moe_every",
                             "moe_capacity_factor", "moe_aux_weight",
                             "moe_dispatch", "pp_microbatches",
                             "pp_schedule", "pp_virtual")):
        val = getattr(args, dest)
        if val is not None:
            fields[obj_field] = val
    if args.remat:
        fields["remat"] = True
    if args.max_seq_len is not None:
        fields["max_seq_len"] = args.max_seq_len
    # tpunet grows the position table to cover the requested length.
    fields["max_seq_len"] = max(fields.get("max_seq_len", model.max_seq_len),
                                data.seq_len)
    if args.vocab_size is not None:
        data = dataclasses.replace(data, vocab_size=args.vocab_size)
        fields["vocab_size"] = args.vocab_size
    if args.vocab_ce is not None:
        fields["vocab_ce"] = args.vocab_ce
    model = dataclasses.replace(model, **fields)
    for dest, obj_field in (("lr", "learning_rate"),
                            ("lr_schedule", "schedule"),
                            ("warmup_epochs", "warmup_epochs"),
                            ("label_smoothing", "label_smoothing"),
                            ("optimizer", "name"),
                            ("weight_decay", "weight_decay"),
                            ("clip_norm", "clip_norm"),
                            ("grad_accum", "grad_accum"),
                            ("ema_decay", "ema_decay")):
        val = getattr(args, dest)
        if val is not None:
            optim = dataclasses.replace(optim, **{obj_field: val})
    if args.checkpoint_dir is not None:
        ckpt = dataclasses.replace(ckpt, directory=args.checkpoint_dir)
    if args.resume:
        ckpt = dataclasses.replace(ckpt, resume=True)
    mesh = cfg.mesh
    for dest, obj_field in (("mesh_data", "data"), ("mesh_seq", "seq"),
                            ("mesh_pipe", "pipe"), ("mesh_model", "model")):
        val = getattr(args, dest)
        if val is not None:
            mesh = dataclasses.replace(mesh, **{obj_field: val})
    if args.zero1:
        mesh = dataclasses.replace(mesh, zero1=True)
    if args.fsdp:
        mesh = dataclasses.replace(mesh, fsdp=True)
    cfg = cfg.replace(data=data, model=model, optim=optim, checkpoint=ckpt,
                      mesh=mesh)
    for dest in ("epochs", "seed", "log_every_steps", "preempt_grace_s",
                 "chaos"):
        val = getattr(args, dest)
        if val is not None:
            cfg = cfg.replace(**{dest: val})
    if args.eval_only:
        cfg = cfg.replace(eval_only=True)
    cfg = cfg.replace(obs=_obs_config(cfg.obs, args))
    if args.profile_dir is not None:
        cfg = cfg.replace(profile_dir=args.profile_dir)
    return cfg


def _obs_config(obs, args: argparse.Namespace):
    """tpunet's mapping of the obs flags onto ``ObsConfig``
    (``tpunet/config.py:config_from_args``)."""
    if args.no_obs:
        obs = dataclasses.replace(obs, enabled=False)
    if args.obs_step_every is not None:
        obs = dataclasses.replace(obs, step_records_every=args.obs_step_every)
    if args.obs_hbm_attrib:
        obs = dataclasses.replace(obs, hbm_attrib=True)
    if args.flightrec is not None:
        obs = dataclasses.replace(obs, flightrec=args.flightrec)
    if args.flightrec_events is not None:
        obs = dataclasses.replace(obs,
                                  flightrec_events=args.flightrec_events)
    if args.profile_start_step is not None:
        obs = dataclasses.replace(obs,
                                  profile_start_step=args.profile_start_step)
    if args.profile_num_steps is not None:
        obs = dataclasses.replace(obs,
                                  profile_num_steps=args.profile_num_steps)
    export = obs.export
    if args.statsd is not None:
        export = dataclasses.replace(export, statsd=args.statsd)
    if args.obs_http is not None:
        export = dataclasses.replace(export, http=args.obs_http)
    if args.obs_webhook is not None:
        export = dataclasses.replace(export, webhook=args.obs_webhook)
    if args.obs_queue_size is not None:
        export = dataclasses.replace(export,
                                     queue_size=args.obs_queue_size)
    if export is not obs.export:
        obs = dataclasses.replace(obs, export=export)
    if args.halt_on_unhealthy:
        obs = dataclasses.replace(obs, halt_on_unhealthy=True)
    if args.evict_on_straggler:
        obs = dataclasses.replace(obs, evict_on_straggler=True)
    if args.run_id is not None:
        obs = dataclasses.replace(obs, run_id=args.run_id)
    if args.obs_rule:
        obs = dataclasses.replace(obs, gauge_rules=tuple(args.obs_rule))
    for obs_field, arg in (("stall_factor", args.stall_factor),
                           ("stall_min_s", args.stall_min_s),
                           ("loss_spike_factor", args.loss_spike_factor),
                           ("heartbeat_timeout_s",
                            args.heartbeat_timeout),
                           ("histogram_max_samples",
                            args.obs_hist_samples),
                           ("alert_cooldown_steps",
                            args.alert_cooldown_steps)):
        if arg is not None:
            obs = dataclasses.replace(obs, **{obs_field: arg})
    return obs


def run(argv=None):
    """Train (or ``--eval-only``) as the command line ``argv`` says and
    return the Trainer; under ``distributed`` inside the process group,
    which is left on the way out, on an error too."""
    args = _parse(argv)
    cfg = _config(args)
    if args.preset != "distributed":
        return _run(cfg, args.device)
    dist.initialize_distributed(device=args.device)
    try:
        ranks = dist.process_count()
        shape = cfg.mesh.shape(ranks)
        # The reference's per-rank batch of 128: the global batch grows
        # with the 'data' axis (cifar10_mpi_mobilenet_224.py:117).
        cfg = cfg.replace(data=dataclasses.replace(
            cfg.data, batch_size=cfg.data.batch_size * shape[0]))
        log0(f"Processes: {ranks} ({dist.backend_name()}), global batch "
             f"{cfg.data.batch_size}, mesh " + " ".join(
                 f"{a}={n}" for a, n in zip(("data", "seq", "pipe", "model"),
                                            shape))
             + (" fsdp" if cfg.mesh.fsdp else "")
             + (" zero1" if cfg.mesh.zero1 and not cfg.mesh.fsdp else ""))
        if dist.process_index() == 0:
            # Rank 0 fetches the data first, the others wait (the
            # reference's rank-0 download and barrier, :93-102).
            from tpunet_torch.data import get_dataset
            get_dataset(cfg.data)
        dist.sync_hosts("dataset-ready")
        return _run(cfg, args.device)
    finally:
        set_mesh(None)
        dist.destroy()


def _run(cfg, device: str):
    # Imported here: the trainer pulls in the model and the kernels.
    from tpunet_torch.train.loop import Trainer

    trainer = Trainer(cfg, device=device)
    try:
        if cfg.eval_only:
            m = trainer.evaluate_checkpoint()
            log0(f"Eval: Test Loss: {m['loss']:.4f} "
                 f"Test Acc: {m['accuracy']:.4f}")
        else:
            trainer.train()
    finally:
        # On the error paths too: close() writes a still-open profile
        # window's trace and drains the exporters.
        trainer.close()
    return trainer


def main(argv=None) -> int:
    """The exit code of tpunet's ``main``: 0 after training, also when a
    preemption (SIGTERM) stopped it with its state saved; 2 when
    ``--halt-on-unhealthy`` stopped it."""
    from tpunet_torch.obs.health import RunUnhealthyError

    try:
        run(argv)
    except RunUnhealthyError as e:
        # --halt-on-unhealthy tripped: the obs_alert record is already
        # in metrics.jsonl (and the live exporters) — exit nonzero
        # without a traceback, like a failed health check should.
        log0(f"ABORT: {e}")
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
