"""CLI entry point: ``python -m tpunet_torch.router``.

A copy of ``python -m tpunet.router``: the same flags, defaults and
messages, in front of the port's serve replicas. Two ways to get a
fleet behind it:

- **external replicas** — point it at already-running servers (a
  ``python -m tpunet_torch.serve`` or ``python -m tpunet.serve``; both
  speak one wire format)::

      python -m tpunet_torch.router --replica http://10.0.0.1:8000 \\
          --replica http://10.0.0.2:8000 --port 8100

  The router probes, routes, evicts, and emits scale decisions as
  *advice* (``obs_router`` events) — something else owns the
  processes.

- **supervisor mode** — the router owns the replica processes::

      python -m tpunet_torch.router --spawn 2 --metrics-dir runs/router \\
          -- --checkpoint-dir ckpt --slots 8 --prefill-buckets 64,256

  Everything after ``--`` is passed through to every ``python -m
  tpunet_torch.serve`` child verbatim (the children serve on the card
  unless it says ``--device cpu``); per-child ``--port`` /
  ``--run-id`` / ``--metrics-dir`` are appended by the supervisor.

``--aot-cache`` (here or after ``--``) exits 2 at boot, before any
child is spawned, with ``tpunet_torch.config.AOT_CACHE_SCOPED_OUT``.

SIGTERM/SIGINT drains: stop listening, stop the control loop, drain
every supervised child (in-flight streams finish), flush the final
``obs_router`` record.
"""

from __future__ import annotations

import signal
import sys


def build_argparser():
    import argparse

    from tpunet_torch.config import AOT_CACHE_SCOPED_OUT, RouterConfig

    d = RouterConfig()
    p = argparse.ArgumentParser(
        prog="python -m tpunet_torch.router",
        description="tpunet_torch routing + autoscaling front tier")
    p.add_argument("--replica", action="append", default=[],
                   metavar="URL",
                   help="external replica base URL (repeatable); "
                        "mutually composable with --spawn")
    p.add_argument("--spawn", type=int, default=0, metavar="N",
                   help="supervisor mode: launch N 'python -m "
                        "tpunet_torch.serve' children (args after -- are "
                        "passed through to every child)")
    p.add_argument("--host", default=d.host)
    p.add_argument("--port", type=int, default=d.port)
    p.add_argument("--probe-interval-s", type=float,
                   default=d.probe_interval_s,
                   help="health/load probe cadence per replica")
    p.add_argument("--probe-timeout-s", type=float,
                   default=d.probe_timeout_s)
    p.add_argument("--unhealthy-after", type=int,
                   default=d.unhealthy_after,
                   help="consecutive probe failures before eviction")
    p.add_argument("--boot-timeout-s", type=float,
                   default=d.boot_timeout_s,
                   help="grace window after (re)spawn during which "
                        "probe failures don't count toward eviction")
    p.add_argument("--affinity-prefix", type=int,
                   default=d.affinity_prefix,
                   help="prompt tokens/bytes hashed for prefix "
                        "affinity (0 disables; 'session' field "
                        "always wins)")
    p.add_argument("--affinity-slack", type=float,
                   default=d.affinity_slack,
                   help="load-score margin the affinity replica may "
                        "exceed the least-loaded one by before "
                        "least-loaded wins")
    p.add_argument("--route-retries", type=int, default=d.route_retries,
                   help="re-route attempts when a replica fails "
                        "before any response byte was relayed")
    p.add_argument("--failover", default=d.failover,
                   action=argparse.BooleanOptionalAction,
                   help="mid-stream failover (default on): journal "
                        "streamed tokens and resume a dying stream "
                        "on a surviving replica with no error frame; "
                        "--no-failover restores the honest-error-"
                        "frame-and-client-retry behavior")
    p.add_argument("--failover-journal-tokens", type=int,
                   default=d.failover_journal_tokens,
                   help="per-stream journal bound: past this many "
                        "relayed tokens a stream is no longer "
                        "failover-protected (replica death then gets "
                        "the honest error frame)")
    p.add_argument("--failover-retries", type=int,
                   default=d.failover_retries,
                   help="resume attempts per request after mid-"
                        "stream replica deaths")
    p.add_argument("--chaos", default=d.chaos, metavar="SPEC",
                   help="serve-tier fault injection forwarded to "
                        "spawned replicas (tpunet_torch/serve/chaos.py "
                        "grammar + ':replica=I' scope; unscoped "
                        "events reach every child) — the failover "
                        "matrix scripts/serve_chaos_smoke.py runs on")
    p.add_argument("--trace-sample", type=float,
                   default=d.trace_sample, metavar="RATE",
                   help="end-to-end request tracing head-sample rate "
                        "in [0,1] (tpunet_torch/obs/tracing.py): sampled "
                        "requests carry X-Trace-Id to every replica "
                        "hop (failover re-submits included) and emit "
                        "obs_trace span records; a client-supplied "
                        "X-Trace-Id is always sampled")
    p.add_argument("--trace-all-on-error",
                   default=d.trace_all_on_error,
                   action=argparse.BooleanOptionalAction,
                   help="tail capture for unsampled requests "
                        "(default on): one router-hop obs_trace "
                        "record for any request that fails over or "
                        "errors, even below the sample rate")
    p.add_argument("--probe-every-s", type=float,
                   default=d.probe_every_s, metavar="S",
                   help="synthetic canary prober cadence (tpunet_torch/"
                        "router/prober.py): issue a pinned greedy "
                        "known-answer request through the router's "
                        "own endpoint every S seconds, judging "
                        "availability/latency/bitwise-golden "
                        "correctness into the SLO engine's SLI "
                        "streams; every probe carries a minted "
                        "always-sampled X-Trace-Id (0 = off)")
    p.add_argument("--slo-policy", default=d.slo_policy,
                   metavar="FILE",
                   help="SLO policy JSON (docs/slos.json format; "
                        "full-line // comments ok): arms the "
                        "tpunet_torch/obs/slo.py engine — obs_slo records, "
                        "slo_* gauges, edge-latched fast-burn pages / "
                        "slow-burn tickets via the obs_alert webhook "
                        "path (empty = built-in defaults when "
                        "--probe-every-s is set)")
    p.add_argument("--request-timeout-s", type=float,
                   default=d.request_timeout_s)
    p.add_argument("--emit-every-s", type=float, default=d.emit_every_s,
                   help="obs_router window record cadence")
    p.add_argument("--scale-up-queue-per-slot", type=float,
                   default=d.scale_up_queue_per_slot,
                   help="fleet queue depth per slot that arms "
                        "scale-up")
    p.add_argument("--scale-down-queue-per-slot", type=float,
                   default=d.scale_down_queue_per_slot,
                   help="fleet queue depth per slot below which "
                        "scale-down arms")
    p.add_argument("--scale-window-probes", type=int,
                   default=d.scale_window_probes,
                   help="consecutive probe rounds a scale condition "
                        "must hold (hysteresis)")
    p.add_argument("--scale-cooldown-s", type=float,
                   default=d.scale_cooldown_s,
                   help="hold after any scale action")
    p.add_argument("--min-replicas", type=int, default=d.min_replicas)
    p.add_argument("--max-replicas", type=int, default=d.max_replicas)
    p.add_argument("--ttft-slo-ms", type=float, default=d.ttft_slo_ms,
                   help="TTFT SLO in ms: worst-replica window p99 "
                        "above it counts as SLO burn and arms "
                        "scale-up (0 = off)")
    p.add_argument("--drain-grace-s", type=float, default=d.drain_grace_s,
                   help="SIGTERM -> graceful-drain budget before "
                        "SIGKILL on restart/stop")
    p.add_argument("--respawn-backoff-s", type=float,
                   default=d.respawn_backoff_s)
    p.add_argument("--run-id", default=d.run_id,
                   help="router identity on obs_router records "
                        "(default router-<host>-<pid>)")
    p.add_argument("--metrics-dir", default="",
                   help="directory for the router's metrics.jsonl + "
                        "flight recorder + per-replica logs/metrics")
    p.add_argument("--aot-cache", default=d.aot_cache, metavar="DIR",
                   help="refused: " + AOT_CACHE_SCOPED_OUT)
    p.add_argument("--statsd", default="", metavar="HOST:PORT",
                   help="stream obs_router records as statsd gauges")
    p.add_argument("--obs-http", default="", metavar="URL",
                   help="POST obs_router records as line-JSON")
    p.add_argument("--obs-webhook", default="", metavar="URL",
                   help="POST one templated JSON payload per "
                        "obs_router EVENT record (evict/respawn/"
                        "scale; window records never page)")
    p.add_argument("serve_args", nargs=argparse.REMAINDER,
                   help="args after -- are passed to every spawned "
                        "'python -m tpunet_torch.serve' child")
    return p


def build_router_config(args):
    from tpunet_torch.config import RouterConfig
    return RouterConfig(
        host=args.host, port=args.port,
        probe_interval_s=args.probe_interval_s,
        probe_timeout_s=args.probe_timeout_s,
        unhealthy_after=args.unhealthy_after,
        boot_timeout_s=args.boot_timeout_s,
        affinity_prefix=args.affinity_prefix,
        affinity_slack=args.affinity_slack,
        route_retries=args.route_retries,
        request_timeout_s=args.request_timeout_s,
        emit_every_s=args.emit_every_s,
        scale_up_queue_per_slot=args.scale_up_queue_per_slot,
        scale_down_queue_per_slot=args.scale_down_queue_per_slot,
        scale_window_probes=args.scale_window_probes,
        scale_cooldown_s=args.scale_cooldown_s,
        min_replicas=args.min_replicas,
        max_replicas=args.max_replicas,
        ttft_slo_ms=args.ttft_slo_ms,
        drain_grace_s=args.drain_grace_s,
        respawn_backoff_s=args.respawn_backoff_s,
        failover=args.failover,
        failover_journal_tokens=args.failover_journal_tokens,
        failover_retries=args.failover_retries,
        chaos=args.chaos,
        trace_sample=args.trace_sample,
        trace_all_on_error=args.trace_all_on_error,
        probe_every_s=args.probe_every_s,
        slo_policy=args.slo_policy,
        run_id=args.run_id, aot_cache=args.aot_cache)


def build_server(args):
    """Construct (but do not start) the RouterServer — shared by
    main() and tests."""
    from tpunet_torch.obs.registry import JsonlSink, Registry
    from tpunet_torch.router.core import Router
    from tpunet_torch.router.frontend import RouterServer
    from tpunet_torch.router.supervisor import Supervisor
    from tpunet_torch.utils.logging import MetricsLogger

    serve_args = list(args.serve_args)
    if serve_args and serve_args[0] == "--":
        serve_args = serve_args[1:]
    try:
        # The AOT store is refused here, before any child is spawned,
        # whether it is the router's flag or a child's.
        cfg = build_router_config(args)
        supervisor = None
        if args.spawn > 0:
            supervisor = Supervisor(
                serve_args, directory=args.metrics_dir,
                drain_grace_s=cfg.drain_grace_s, chaos=args.chaos)
    except NotImplementedError as e:
        print(f"python -m tpunet_torch.router: error: {e}",
              file=sys.stderr, flush=True)
        raise SystemExit(2)
    if not args.replica and args.spawn < 1:
        print("python -m tpunet_torch.router: error: nothing to route "
              "to — give --replica URL (repeatable) and/or --spawn N",
              file=sys.stderr, flush=True)
        raise SystemExit(2)
    if args.chaos:
        # A typo'd chaos spec is a loud exit-2 at router boot, not a
        # child-boot failure minutes later.
        from tpunet_torch.serve.chaos import (ServeChaosError,
                                              split_by_replica)
        try:
            split_by_replica(args.chaos)
        except ServeChaosError as e:
            print(f"python -m tpunet_torch.router: error: {e}",
                  file=sys.stderr, flush=True)
            raise SystemExit(2)
    if args.slo_policy:
        # A malformed SLO policy is a loud exit-2 at router boot, not
        # an unguarded fleet discovered mid-incident.
        from tpunet_torch.obs.slo import SloPolicyError, load_policy
        try:
            load_policy(args.slo_policy)
        except (OSError, SloPolicyError) as e:
            print(f"python -m tpunet_torch.router: error: --slo-policy: "
                  f"{e}", file=sys.stderr, flush=True)
            raise SystemExit(2)
    registry = Registry()
    recorder = None
    metrics_logger = None
    exporters = []
    if args.metrics_dir:
        from tpunet_torch.obs import flightrec
        recorder = flightrec.install(args.metrics_dir,
                                     run_id=args.run_id)
        metrics_logger = MetricsLogger(args.metrics_dir, resume=True)
        registry.add_sink(JsonlSink(metrics_logger))
    if args.statsd or args.obs_http or args.obs_webhook:
        from tpunet_torch.config import ExportConfig
        from tpunet_torch.obs.export import build_exporters
        exporters = build_exporters(
            ExportConfig(statsd=args.statsd, http=args.obs_http,
                         webhook=args.obs_webhook),
            registry)
        for exporter in exporters:
            registry.add_sink(exporter)
    router = Router(cfg, replica_urls=args.replica,
                    supervisor=supervisor, n_replicas=args.spawn,
                    registry=registry)
    return RouterServer(router, host=cfg.host, port=cfg.port,
                        metrics_logger=metrics_logger,
                        exporters=exporters, flight_recorder=recorder)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    server = build_server(args)
    server.start()
    print(f"tpunet_torch.router listening on "
          f"http://{args.host}:{server.port} "
          f"(replicas={len(server.router.replicas)}, "
          f"supervised={server.router.supervisor is not None})",
          flush=True)

    import threading
    stop = threading.Event()

    def _term(signum, frame):
        print(f"signal {signum}: draining router...", flush=True)
        stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    while not stop.is_set():
        stop.wait(0.5)
        if not server.router.healthy:
            print(f"router control loop dead: {server.router.error}; "
                  "draining", file=sys.stderr, flush=True)
            stop.set()
    server.drain()
    print("router drained", flush=True)
    return 0 if server.router.error is None else 2


if __name__ == "__main__":
    sys.exit(main())
