"""Telemetry of the port (counterpart of the JAX package's ``telemetry/``):

* :mod:`.metrics`: the thread-safe registry of labeled counters, gauges
  and log-bucketed histograms, and the :class:`ThroughputMonitor`;
* :mod:`.exporters`: the Prometheus text exposition and the cadenced
  ``metrics.jsonl``;
* :mod:`.tracing`: the span API and the flight recorder, dumped as
  Perfetto ``traceEvents`` JSON at incidents;
* :mod:`.compile_log`: build and capture attribution, device memory
  gauges, the one-shot ``torch.profiler`` capture.

Telemetry records host-side values the run computed anyway: it never
touches a captured CUDA graph, and a run with it on steps bit for bit as a
run with it off (:func:`set_enabled`).  :mod:`.reqtrace` carries one
trace id a serving request from admission to its last chunk.
"""

from .exporters import (PROMETHEUS_CONTENT_TYPE, MetricsDumper, prometheus_text,  # noqa: F401
                        read_metrics_jsonl)
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,  # noqa: F401
                      ThroughputMonitor, counter, default_registry, gather_global_snapshot,
                      gauge, histogram, merge_snapshots, snapshot)
from .metrics import enabled as metrics_enabled  # noqa: F401
from .metrics import set_enabled as set_metrics_enabled  # noqa: F401
from .tracing import (RECORDER, FlightRecorder, arm_exit_dump, dump_flight_record,  # noqa: F401
                      instant, set_span_annotator, span)
from .tracing import enabled as tracing_enabled  # noqa: F401
from .tracing import set_enabled as set_tracing_enabled  # noqa: F401
from . import compile_log  # noqa: F401
from . import reqtrace  # noqa: F401
from .reqtrace import assemble_request_trace  # noqa: F401
from .reqtrace import mint as mint_trace_context  # noqa: F401
from .reqtrace import enabled as reqtrace_enabled  # noqa: F401
from .reqtrace import set_enabled as set_reqtrace_enabled  # noqa: F401


def set_enabled(flag: bool) -> None:
    """The master switch: metrics, tracing and request tracing together."""
    set_metrics_enabled(flag)
    set_tracing_enabled(flag)
    set_reqtrace_enabled(flag)


def enabled() -> bool:
    """True when any layer records."""
    return metrics_enabled() or tracing_enabled() or reqtrace_enabled()
