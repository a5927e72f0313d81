"""Elastic agent CLI: ``python -m tpunet_torch.elastic``, tpunet's flags.

One agent per host, all pointed at the same shared run/rendezvous
directories, each wrapping the SAME trainer command::

    python -m tpunet_torch.elastic \\
        --run-dir /ckpt/run1 --rdzv-dir /ckpt/run1/rdzv \\
        --host-id $(hostname) --max-restarts 2 -- \\
        python -m tpunet_torch.train --preset distributed --epochs 20 \\
            --checkpoint-dir /ckpt/run1

The agent gives each generation's child its world (the launcher's
``RANK`` / ``WORLD_SIZE`` / ``LOCAL_RANK`` / ``MASTER_ADDR`` /
``MASTER_PORT`` + ``TPUNET_ELASTIC_*``) and appends ``--resume`` from
the second incarnation on; docs/elasticity.md has the protocol and
the exit codes. Imports no torch.
"""

from __future__ import annotations

import argparse
import socket
import sys
from typing import List, Optional

from tpunet_torch.elastic.agent import AgentConfig, ElasticAgent


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpunet_torch.elastic",
        description="per-host elastic training agent (supervise, "
                    "rendezvous, relaunch)")
    p.add_argument("--run-dir", required=True,
                   help="shared checkpoint/metrics directory (the "
                        "child's --checkpoint-dir)")
    p.add_argument("--rdzv-dir", required=True,
                   help="shared rendezvous directory (all hosts)")
    p.add_argument("--host-id", default=socket.gethostname(),
                   help="unique host identity (default: hostname)")
    p.add_argument("--addr", default="127.0.0.1",
                   help="this host's address for coordinator duty")
    p.add_argument("--min-hosts", type=int, default=1,
                   help="quorum floor: fewer announced hosts than "
                        "this is a QuorumError, not a smaller pod")
    p.add_argument("--max-restarts", type=int, default=1,
                   help="child failures this host absorbs before "
                        "marking itself gone (0 = any failure is "
                        "host death)")
    p.add_argument("--settle-s", type=float, default=0.5,
                   help="rendezvous stability window")
    p.add_argument("--timeout-s", type=float, default=60.0,
                   help="rendezvous gather budget before the quorum "
                        "verdict")
    p.add_argument("--dead-after-s", type=float, default=3.0,
                   help="peer heartbeat staleness => host lost")
    p.add_argument("--grace-s", type=float, default=5.0,
                   help="SIGTERM->SIGKILL grace when stopping a "
                        "wedged child")
    p.add_argument("--max-generations", type=int, default=32,
                   help="relaunch budget (runaway guard)")
    p.add_argument("--join", action="store_true",
                   help="ask a running pod to re-rendezvous and grow "
                        "onto this host before the first gather")
    p.add_argument("command", nargs=argparse.REMAINDER,
                   help="-- followed by the trainer command")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_argparser().parse_args(argv)
    command = list(args.command)
    if command and command[0] == "--":
        command = command[1:]
    if not command:
        print("usage error: trainer command required after '--'",
              file=sys.stderr)
        return 2
    agent = ElasticAgent(AgentConfig(
        run_dir=args.run_dir, rdzv_dir=args.rdzv_dir,
        host_id=args.host_id, command=command, addr=args.addr,
        min_hosts=args.min_hosts, max_restarts=args.max_restarts,
        settle_s=args.settle_s, timeout_s=args.timeout_s,
        dead_after_s=args.dead_after_s, grace_s=args.grace_s,
        max_generations=args.max_generations))
    if args.join:
        agent.rdzv.request_join()
    return agent.run()


if __name__ == "__main__":
    sys.exit(main())
