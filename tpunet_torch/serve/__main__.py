"""CLI entry point: ``python -m tpunet_torch.serve --checkpoint-dir ...``,
port of ``python -m tpunet.serve``.

Loads the LM's best checkpoint through ``infer.generate.load_lm`` (an
empty ``--checkpoint-dir`` serves the seeded random init), optionally a
classifier checkpoint for the micro-batched ``/v1/classify`` path and a
shared prefix store (``--prefix-store``), wires the obs registry into
``metrics.jsonl``, the flight recorder and any configured live
exporters, and serves until SIGTERM/SIGINT, which drains gracefully
(stop admitting, finish in-flight, flush telemetry) rather than dropping
connections. Flags and exit-2 usage errors are tpunet's, plus
``--device`` (``cuda`` by default; ``cpu`` is the only way to serve on
the CPU). ``--model lm_pp`` serves a pipeline-trained checkpoint as the
LM (``--train-pipe``/``--pp-virtual`` as ``infer.generate`` reads
them). ``--aot-cache`` exits 2 with the reason it is out of scope.

Tensor-parallel serving (``--mesh-model M``): one process a rank, M of
them under ``torchrun``, the mesh data 1 x model M; each rank loads its
Megatron shard (``infer.generate.load_lm``) and the engine runs in
lockstep over the group (``serve/engine.py``). Rank 0 binds ``--port``
and runs the frontend, the optional classify worker, the metrics and
the flight recorder; the other ranks run no server and follow rank 0's
op stream until its stop. SIGTERM/SIGINT drain rank 0 (the other ranks
ignore them: torchrun signals every rank), and its stop ends every rank
with exit 0. ``--tp-timeout-s`` bounds every collective: a dead rank
fails the others' within it (rank 0's engine turns unhealthy). The
heads must split evenly over M (exit 2). NCCL on the card, gloo on the
CPU; ``--dist-backend gloo`` lets ranks share one card.

    torchrun --standalone --nproc-per-node 2 -m tpunet_torch.serve \
        --checkpoint-dir ckpt --vit-hidden 768 --vit-depth 12 \
        --vit-heads 12 --mesh-model 2
"""

from __future__ import annotations

import dataclasses
import os
import signal
import sys
import threading

_PROG = "python -m tpunet_torch.serve"


def parse_prefill_buckets(spec, max_seq_len: int):
    """Validate ``--prefill-buckets``: comma-separated positive ints,
    none beyond ``--max-seq-len``. A bad entry is a LOUD exit-2 usage
    error, never a silently changed bucket set."""
    entries = [e.strip() for e in str(spec).split(",") if e.strip()]
    if not entries:
        raise _usage(f"--prefill-buckets {spec!r} names no buckets; "
                     "give at least one padded prompt length, e.g. "
                     "--prefill-buckets 64,256,1024")
    buckets = []
    for raw in entries:
        try:
            bucket = int(raw)
        except ValueError:
            raise _usage(
                f"--prefill-buckets entry {raw!r} is not an integer "
                f"(got {spec!r}; expected comma-separated prompt-"
                "length buckets like 64,256,1024)")
        if bucket < 1:
            raise _usage(f"--prefill-buckets entry {bucket} must be "
                         ">= 1")
        if bucket > max_seq_len:
            raise _usage(
                f"--prefill-buckets entry {bucket} exceeds "
                f"--max-seq-len {max_seq_len}: the KV pool cannot "
                "hold a prompt that long — raise --max-seq-len or "
                "drop the bucket")
        buckets.append(bucket)
    return tuple(buckets)


def _usage(msg: str) -> SystemExit:
    print(f"{_PROG}: error: {msg}", file=sys.stderr, flush=True)
    return SystemExit(2)


def build_argparser():
    import argparse

    from tpunet_torch.config import AOT_CACHE_SCOPED_OUT, ServeConfig

    d = ServeConfig()
    p = argparse.ArgumentParser(
        prog=_PROG, description="tpunet_torch production inference server")
    p.add_argument("--checkpoint-dir", default="checkpoints",
                   help="LM best-checkpoint directory (infer.generate "
                        "load_lm path; empty = the seeded random init)")
    p.add_argument("--host", default=d.host)
    p.add_argument("--port", type=int, default=d.port)
    p.add_argument("--slots", type=int, default=d.slots,
                   help="KV-slot pool size = max in-flight decodes")
    p.add_argument("--queue-max", type=int, default=d.queue_max,
                   help="bounded admission queue; beyond it requests "
                        "are rejected 429 (backpressure)")
    p.add_argument("--prefill-buckets", default=",".join(
        str(b) for b in d.prefill_buckets),
        help="comma-separated padded prompt-length buckets (one prefill "
             "shape each)")
    p.add_argument("--paged-kv", default=d.paged_kv,
                   action=argparse.BooleanOptionalAction,
                   help="paged KV cache (default on): K/V in a shared "
                        "page pool with per-slot page tables, so a slot "
                        "costs prompt-proportional memory; --no-paged-kv "
                        "restores the dense [slots, max_seq_len] pool")
    p.add_argument("--kv-pages", type=int, default=d.kv_pages,
                   help="usable KV pages in the shared pool (0 = "
                        "dense-equivalent capacity: slots x "
                        "ceil(max-seq-len / kv-page-tokens))")
    p.add_argument("--kv-page-tokens", type=int,
                   default=d.kv_page_tokens,
                   help="tokens per KV page (allocation granule)")
    p.add_argument("--kv-dtype", default=d.kv_dtype,
                   choices=["auto", "bf16", "int8"],
                   help="KV page payload dtype: auto = compute dtype; "
                        "bf16 halves float32 payloads; int8 "
                        "quantizes per written token row (float32 "
                        "scale stored with the page) — halves page "
                        "cost again")
    p.add_argument("--prefix-cache", default=d.prefix_cache,
                   action=argparse.BooleanOptionalAction,
                   help="prefix KV cache (default on, paged only): "
                        "finished prefill pages stay in the pool as "
                        "refcounted content-addressed objects; a new "
                        "request pins its longest cached page-aligned "
                        "prefix and prefills only the suffix")
    p.add_argument("--prefix-cache-pages", type=int,
                   default=d.prefix_cache_pages,
                   help="pool pages the prefix cache may hold (0 = "
                        "half the usable pool)")
    p.add_argument("--prefix-store", default=d.prefix_store,
                   metavar="DIR",
                   help="shared-filesystem prefix spill/warm-start: "
                        "cached pages publish under DIR (first-writer-"
                        "wins) and a fresh replica adopts the fleet's "
                        "prefix set when it starts; entries scoped by "
                        "model config + kv levers + torch/CUDA/card, so "
                        "a lever change is a clean miss")
    p.add_argument("--spec-decode", default=d.spec_decode,
                   action=argparse.BooleanOptionalAction,
                   help="speculative decoding (default off, needs "
                        "paged KV + device sampling): a drafter "
                        "proposes --spec-k tokens per slot against its "
                        "own paged pool, ONE wide verify over the main "
                        "pool scores them, rejection rewinds the "
                        "page-table cursor — the output is the spec-off "
                        "output at any acceptance rate")
    p.add_argument("--spec-k", type=int, default=d.spec_k,
                   help="draft tokens per verify cycle (a slot emits "
                        "1..K+1 verified tokens per cycle)")
    p.add_argument("--spec-draft-width-mult", type=float,
                   default=d.spec_draft_width_mult,
                   help="drafter width as a fraction of the serving "
                        "model's hidden dim (floored to a multiple of "
                        "the head count; 1.0 = self-speculation for "
                        "parity testing)")
    p.add_argument("--spec-draft-checkpoint",
                   default=d.spec_draft_checkpoint, metavar="NPZ",
                   help="fitted drafter weights (a spec.save_drafter_"
                        "params npz of tpunet or tpunet_torch); empty = "
                        "deterministic random init, which is correct "
                        "but drafts nothing useful — fit one against "
                        "real traffic with tpunet_torch.serve.spec."
                        "fit_drafter")
    p.add_argument("--device-sampling", default=d.device_sampling,
                   action=argparse.BooleanOptionalAction,
                   help="batched temperature/top-k/top-p sampling on "
                        "the device (default on); --no-device-sampling "
                        "restores the host-side per-slot sampler")
    p.add_argument("--max-new-tokens", type=int,
                   default=d.default_max_new_tokens,
                   help="default per-request generation budget")
    p.add_argument("--max-new-tokens-cap", type=int,
                   default=d.max_new_tokens_cap,
                   help="hard per-request generation ceiling: larger "
                        "asks are clamped to it at admission")
    p.add_argument("--deadline-s", type=float,
                   default=d.default_deadline_s,
                   help="default per-request wall-clock deadline "
                        "(0 = none)")
    p.add_argument("--classify-batch-max", type=int,
                   default=d.classify_batch_max)
    p.add_argument("--classify-window-ms", type=float,
                   default=d.classify_window_ms)
    p.add_argument("--emit-every-s", type=float, default=d.emit_every_s,
                   help="obs_serve record cadence into metrics.jsonl")
    p.add_argument("--drain-timeout-s", type=float,
                   default=d.drain_timeout_s)
    p.add_argument("--metrics-dir", default="",
                   help="directory for metrics.jsonl and the flight "
                        "recorder (default: the checkpoint dir)")
    p.add_argument("--statsd", default="", metavar="HOST:PORT",
                   help="stream obs_serve records as statsd/UDP gauges")
    p.add_argument("--obs-http", default="", metavar="URL",
                   help="POST obs_serve records as line-JSON")
    p.add_argument("--obs-webhook", default="", metavar="URL",
                   help="POST one templated JSON payload per alert "
                        "record (obs_alert/obs_crash) — wire format "
                        "in docs/metrics_schema.md")
    p.add_argument("--run-id", default=d.run_id,
                   help="replica identity stamped on obs_serve records "
                        "(default serve-<host>-<pid>)")
    p.add_argument("--chaos", default=d.chaos, metavar="SPEC",
                   help="serve-tier fault injection (tpunet_torch/serve/"
                        "chaos.py): kill@tokens=N, kill@prefill[=K], "
                        "stall@tokens=N:ms=M, drop-probe@prob=P:"
                        "seed=X, slow-stream@ms=M — deterministic, "
                        "';'-separated")
    p.add_argument("--trace-sample", type=float,
                   default=d.trace_sample, metavar="RATE",
                   help="standalone request-tracing head-sample rate in "
                        "[0,1] for requests WITHOUT router trace headers; "
                        "a client-supplied X-Trace-Id is always sampled")
    p.add_argument("--aot-cache", default=d.aot_cache, metavar="DIR",
                   help="refused: " + AOT_CACHE_SCOPED_OUT)
    # LM architecture (must match the trained checkpoint) — mirrors
    # tpunet_torch.infer.generate's flags.
    p.add_argument("--model", choices=("lm", "lm_pp"), default="lm")
    p.add_argument("--vit-hidden", type=int, default=192)
    p.add_argument("--vit-depth", type=int, default=6)
    p.add_argument("--vit-heads", type=int, default=3)
    p.add_argument("--vocab-size", type=int, default=256)
    p.add_argument("--max-seq-len", type=int, default=1024)
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16",
                   help="activation dtype (the parameters stay float32)")
    p.add_argument("--moe-experts", type=int, default=0)
    p.add_argument("--moe-every", type=int, default=2)
    p.add_argument("--moe-top-k", type=int, default=2)
    p.add_argument("--moe-capacity-factor", type=float, default=1.25)
    p.add_argument("--mesh-model", type=int, default=0,
                   help="tensor-parallel serving over this many ranks "
                        "(one process a rank, under torchrun; the heads "
                        "must split evenly)")
    p.add_argument("--dist-backend", choices=("auto", "nccl", "gloo"),
                   default="auto",
                   help="--mesh-model's process group: auto = NCCL on "
                        "the card, gloo on the CPU; gloo lets ranks "
                        "share one card")
    p.add_argument("--tp-timeout-s", type=float, default=60.0,
                   help="--mesh-model: how long a collective waits for "
                        "the other ranks before it fails (a dead rank "
                        "turns rank 0's engine unhealthy in this time)")
    p.add_argument("--train-pipe", type=int, default=0)
    p.add_argument("--pp-virtual", type=int, default=2)
    # Optional classifier endpoint.
    p.add_argument("--classifier-checkpoint-dir", default="",
                   help="also serve /v1/classify from this MobileNetV2/"
                        "ViT best checkpoint (micro-batched)")
    p.add_argument("--classifier-model", default="mobilenet_v2")
    p.add_argument("--classifier-image-size", type=int, default=224)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    return p


def _check_usage(args) -> tuple:
    """The usage errors that exit 2 before anything loads or joins a
    group; returns the prefill buckets."""
    buckets = parse_prefill_buckets(args.prefill_buckets,
                                    args.max_seq_len)
    from tpunet_torch.infer.generate import heads_error
    why = heads_error(args.vit_heads, args.mesh_model)
    if why:
        raise _usage(why)
    if args.chaos:
        # Like the bucket list: a typo'd chaos spec is a loud exit 2
        # BEFORE the model loads, not a mid-serve raise.
        from tpunet_torch.serve.chaos import ServeChaos, ServeChaosError
        try:
            ServeChaos.parse(args.chaos)
        except ServeChaosError as e:
            raise _usage(str(e))
    return buckets


def _configs(args, buckets) -> tuple:
    """(ServeConfig, ModelConfig) of the flags; a bad value exits 2."""
    from tpunet_torch.config import ModelConfig, ServeConfig
    try:
        cfg = ServeConfig(
            host=args.host, port=args.port, slots=args.slots,
            queue_max=args.queue_max, prefill_buckets=buckets,
            paged_kv=args.paged_kv, kv_pages=args.kv_pages,
            kv_page_tokens=args.kv_page_tokens, kv_dtype=args.kv_dtype,
            device_sampling=args.device_sampling,
            prefix_cache=args.prefix_cache,
            prefix_cache_pages=args.prefix_cache_pages,
            prefix_store=args.prefix_store,
            default_max_new_tokens=args.max_new_tokens,
            max_new_tokens_cap=args.max_new_tokens_cap,
            default_deadline_s=args.deadline_s,
            classify_batch_max=args.classify_batch_max,
            classify_window_ms=args.classify_window_ms,
            emit_every_s=args.emit_every_s,
            drain_timeout_s=args.drain_timeout_s,
            run_id=args.run_id, aot_cache=args.aot_cache,
            chaos=args.chaos, trace_sample=args.trace_sample,
            spec_decode=args.spec_decode, spec_k=args.spec_k,
            spec_draft_width_mult=args.spec_draft_width_mult,
            spec_draft_checkpoint=args.spec_draft_checkpoint)
        model_cfg = ModelConfig(
            name=args.model, vit_hidden=args.vit_hidden,
            vit_depth=args.vit_depth, vit_heads=args.vit_heads,
            vocab_size=args.vocab_size, max_seq_len=args.max_seq_len,
            dropout_rate=0.0, dtype=args.dtype, moe_experts=args.moe_experts,
            moe_every=args.moe_every, moe_top_k=args.moe_top_k,
            moe_capacity_factor=args.moe_capacity_factor,
            pp_virtual=args.pp_virtual)
    except (NotImplementedError, ValueError) as e:
        raise _usage(str(e))
    return cfg, model_cfg


def build_server(args, device=None, mesh=None):
    """Construct (but do not start) the ServeServer from parsed args —
    shared by main() and tests. Usage errors exit 2 before the model
    loads. ``device`` and ``mesh``: a tensor-parallel rank 0's card and
    mesh (``main`` joins the group first)."""
    buckets = _check_usage(args)
    if args.mesh_model > 1 and mesh is None:
        raise _usage("--mesh-model runs one process a rank: launch it "
                     "with torchrun --nproc-per-node "
                     f"{args.mesh_model}")

    from tpunet_torch.ckpt import BEST
    from tpunet_torch.config import DataConfig, ExportConfig, ModelConfig
    from tpunet_torch.infer.generate import load_lm
    from tpunet_torch.infer.predict import Predictor
    from tpunet_torch.obs import flightrec
    from tpunet_torch.obs.export import build_exporters
    from tpunet_torch.obs.registry import JsonlSink
    from tpunet_torch.serve.classify import ClassifyBatcher
    from tpunet_torch.serve.engine import Engine
    from tpunet_torch.serve.frontend import ServeServer
    from tpunet_torch.serve.prefixcache import build_prefix_store
    from tpunet_torch.utils.logging import MetricsLogger

    cfg, model_cfg = _configs(args, buckets)
    device = device or args.device
    model = load_lm(model_cfg, checkpoint_dir=args.checkpoint_dir,
                    device=device, train_pipe=args.train_pipe, mesh=mesh)
    # The engine serves the LM whatever the checkpoint's training model.
    model_cfg = dataclasses.replace(model_cfg, name="lm")
    prefix_store = None
    if cfg.prefix_store and cfg.prefix_cache and cfg.paged_kv:
        prefix_store = build_prefix_store(cfg.prefix_store, model_cfg, cfg,
                                          device=str(device))
    engine = Engine(model, cfg, prefix_store=prefix_store)
    registry = engine.registry

    metrics_logger = None
    metrics_dir = args.metrics_dir or args.checkpoint_dir
    # Black-box flight recorder for the serving process: event ring +
    # crash handlers + watcher into <metrics-dir>/flightrec, so a dead
    # replica leaves a crash_report.json next to its metrics.
    recorder = None
    if metrics_dir:
        recorder = flightrec.install(metrics_dir, run_id=args.run_id)
        metrics_logger = MetricsLogger(metrics_dir, resume=True)
        registry.add_sink(JsonlSink(metrics_logger))
    exporters = []
    if args.statsd or args.obs_http or args.obs_webhook:
        # Bad endpoint syntax raises here, at setup.
        exporters = build_exporters(
            ExportConfig(statsd=args.statsd, http=args.obs_http,
                         webhook=args.obs_webhook),
            registry)
        for exporter in exporters:
            registry.add_sink(exporter)

    batcher = None
    if args.classifier_checkpoint_dir:
        pred = Predictor(
            model_cfg=ModelConfig(name=args.classifier_model,
                                  dropout_rate=0.0),
            data_cfg=DataConfig(image_size=args.classifier_image_size),
            checkpoint=os.path.join(args.classifier_checkpoint_dir, BEST),
            device=device)
        batcher = ClassifyBatcher(pred,
                                  batch_max=cfg.classify_batch_max,
                                  window_ms=cfg.classify_window_ms,
                                  registry=registry)
    return ServeServer(engine, classify_batcher=batcher,
                       host=cfg.host, port=cfg.port,
                       metrics_logger=metrics_logger, exporters=exporters,
                       run_id=cfg.run_id,
                       flight_recorder=recorder)


def follow(args, device, mesh) -> int:
    """A tensor-parallel rank after the first: its shard and pools, then
    rank 0's op stream until its stop (exit 0); SIGTERM and SIGINT are
    rank 0's to act on."""
    from tpunet_torch.infer.generate import load_lm
    from tpunet_torch.serve.engine import Engine

    cfg, model_cfg = _configs(args, _check_usage(args))
    # Chaos, metrics and the prefix store are rank 0's: a follower holds
    # device state only.
    cfg = dataclasses.replace(cfg, chaos="", prefix_store="")
    model = load_lm(model_cfg, checkpoint_dir=args.checkpoint_dir,
                    device=device, train_pipe=args.train_pipe, mesh=mesh)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    Engine(model, cfg).follow()
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.mesh_model <= 1:
        return serve(args)
    _check_usage(args)
    from tpunet_torch.infer.generate import init_tensor_parallel
    from tpunet_torch.parallel import dist
    try:
        try:
            mesh, device = init_tensor_parallel(
                args.mesh_model, args.device,
                None if args.dist_backend == "auto" else args.dist_backend,
                args.tp_timeout_s)
        except ValueError as e:
            raise _usage(str(e))
        if dist.process_index() != 0:
            return follow(args, device, mesh)
        return serve(args, device, mesh)
    finally:
        dist.destroy()


def serve(args, device=None, mesh=None) -> int:
    """Serve until SIGTERM/SIGINT (or a dead engine), then drain; a
    tensor-parallel rank 0 with its ``device`` and ``mesh``."""
    server = build_server(args, device, mesh)
    server.start()
    print(f"tpunet_torch.serve listening on "
          f"http://{args.host}:{server.port} "
          f"(slots={server.engine.slots}, "
          f"buckets={server.engine.buckets}, "
          f"device={device or args.device}"
          + (f", mesh model={args.mesh_model}" if mesh is not None
             else "") + ")",
          flush=True)

    stop = threading.Event()

    def _term(signum, frame):
        print(f"signal {signum}: draining "
              f"(timeout {args.drain_timeout_s}s)...", flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop.is_set():
        stop.wait(0.5)
        if not server.engine.healthy:
            print(f"engine unhealthy: {server.engine.error}; "
                  "draining", file=sys.stderr, flush=True)
            stop.set()
    clean = server.drain(args.drain_timeout_s)
    print(f"drained ({'clean' if clean else 'forced'})", flush=True)
    return 0 if server.engine.error is None else 2


if __name__ == "__main__":
    sys.exit(main())
