"""Fault-isolated simulation service: continuously-batched ensemble serving
(the counterpart of the JAX package's ``serve/``, the same names):

* :class:`SimServer`: the durable-queue, continuous-batching scheduler
  over :class:`..models.ensemble.NavierEnsemble` slots;
* :class:`SimRequest`: the unit of work (Ra/Pr/resolution/geometry/
  horizon), bucketed by its operator-constant compatibility key;
* :class:`DurableQueue`: the crash-safe on-disk request lifecycle, row for
  row the JAX package's;
* :class:`RequestFailed` / :class:`AdmissionError` / :class:`RequestError`:
  the typed failure surface (terminal divergence, bounded-queue
  backpressure, malformed work);
* :class:`HttpFront`: the optional thin stdlib HTTP front;
* :mod:`.warmpool`: prebuilt campaigns whose chunk graphs are captured
  on a background thread;
* :mod:`.fleet`: stateless :class:`FleetProxy` fronts over the shared
  queue, bucket leases with fencing (:class:`LeaseManager` /
  :class:`LeaseLost`), durable parked continuations, the QoS contract,
  gangs, the launcher and the autoscaler.
"""

from .fleet import (  # noqa: F401
    FleetProxy,
    Lease,
    LeaseLost,
    LeaseManager,
)
from .http_front import HttpFront  # noqa: F401
from .queue import DurableQueue  # noqa: F401
from .request import (AdmissionError, RequestError, RequestFailed, SimRequest,  # noqa: F401
                      priority_rank)
from .scheduler import SimServer  # noqa: F401
