"""The serving layer's host-side groundwork (counterpart of the first
modules of the JAX package's ``serve/``):

* :class:`SimRequest`: the unit of work (Ra/Pr/resolution/geometry/
  horizon), bucketed by its operator-constant compatibility key;
* :class:`DurableQueue`: the crash-safe on-disk request lifecycle, row for
  row the JAX package's;
* :class:`RequestFailed` / :class:`AdmissionError` / :class:`RequestError`:
  the typed failure surface (terminal divergence, bounded-queue
  backpressure, malformed work).

The scheduler (``SimServer``), the warm pool, the HTTP front and the fleet
are ROADMAP Queue 1 item 18.
"""

from .queue import DurableQueue  # noqa: F401
from .request import (AdmissionError, RequestError, RequestFailed, SimRequest,  # noqa: F401
                      priority_rank)
