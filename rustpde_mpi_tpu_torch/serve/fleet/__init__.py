"""Fleet layer: N stateless proxies + M ``SimServer`` replicas over ONE
shared durable queue — the highly-available front the ROADMAP's
"replicated front door" item asks for, built the way an LLM-serving
stack would and coordinated entirely through the queue's fsynced
atomic-rename lifecycle (no consensus service):

* :class:`~.proxy.FleetProxy` — stateless HTTP fronts: any number of
  them accept/answer against durable state, so reads and admission
  survive any single process death,
* :class:`~.lease.LeaseManager` / :class:`~.lease.Lease` — queue-level
  bucket leases with fencing tokens and observer-monotonic heartbeat
  staleness: a replica that stops heartbeating past the TTL has its
  leases broken by survivors, who re-claim its requests,
* :mod:`~.qos` — the traffic contract: per-tenant quotas (429 +
  Retry-After), priority classes ordering bucket selection, deadline
  slack, and loss-free preemption of best-effort lanes,
* durable parked continuations live in
  :mod:`rustpde_mpi_tpu_torch.utils.checkpoint` (``write_continuation`` /
  ``read_continuation``): requeue-with-state survives replica SIGKILL.

Enable per replica via ``ServeConfig(fleet=FleetConfig(...))``; with
``fleet=None`` (the default) none of this machinery runs — zero extra
journal rows, zero extra collectives.
"""

from .autoscaler import Autoscaler  # noqa: F401
from .launcher import (  # noqa: F401
    LocalProcessLauncher,
    ReplicaHandle,
    ReplicaLauncher,
)
from .lease import Lease, LeaseLost, LeaseManager, bucket_tag  # noqa: F401
from .proxy import (  # noqa: F401
    FleetProxy,
    read_replica_status,
    write_replica_heartbeat,
)
from . import qos  # noqa: F401
