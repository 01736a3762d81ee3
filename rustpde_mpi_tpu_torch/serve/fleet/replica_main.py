"""Library entry point for launcher-spawned replicas: ``python -m
rustpde_mpi_tpu_torch.serve.fleet.replica_main --run-dir <dir>
--replica-id <rid> [--daemon] [--device cuda|cpu] ...`` builds a
fleet-mode :class:`..scheduler.SimServer` and serves until drained (or
signalled).  This is what
:class:`~rustpde_mpi_tpu_torch.serve.fleet.launcher.LocalProcessLauncher`
execs.  The JAX package's environment knobs are flags here:
``--fault``, ``--preempt-notice-s``, ``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--run-dir", required=True, help="shared fleet run_dir")
    p.add_argument("--replica-id", required=True, help="stable replica id")
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--chunk-steps", type=int, default=4)
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--ckpt-every-s", type=float, default=None)
    p.add_argument("--lease-ttl-s", type=float, default=None)
    p.add_argument("--heartbeat-s", type=float, default=None)
    p.add_argument("--quota", type=int, default=None)
    p.add_argument("--preempt-slack-s", type=float, default=30.0)
    p.add_argument(
        "--daemon",
        action="store_true",
        help="keep serving after the queue drains (idle_exit=False)",
    )
    p.add_argument("--fault", default=None, help="fault injection spec")
    p.add_argument("--preempt-notice-s", type=float, default=0.0,
                   help="preemption-notice window of a SIGTERM (0: off)")
    p.add_argument("--device", default="cuda", help="the replica's device (cuda or cpu)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    from ...config import FleetConfig, ServeConfig
    from ..scheduler import SimServer

    cfg = ServeConfig(
        run_dir=args.run_dir,
        slots=args.slots,
        chunk_steps=args.chunk_steps,
        max_queue=args.max_queue,
        checkpoint_every_s=args.ckpt_every_s,
        idle_exit=not args.daemon,
        http_port=None,
        preempt_notice_s=args.preempt_notice_s,
        fleet=FleetConfig(
            replica_id=args.replica_id,
            lease_ttl_s=args.lease_ttl_s,
            heartbeat_s=args.heartbeat_s,
            default_quota=args.quota,
            preempt_slack_s=args.preempt_slack_s,
        ),
    )
    server = SimServer(cfg, fault=args.fault, device=args.device)
    summary = server.serve()
    print(
        json.dumps(
            {
                "replica": args.replica_id,
                "outcome": summary.get("outcome"),
                "completed": summary.get("completed"),
                "failed": summary.get("failed"),
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
