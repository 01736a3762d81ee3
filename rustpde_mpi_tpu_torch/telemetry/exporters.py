"""Metric exporters: the Prometheus text exposition and the cadenced
``metrics.jsonl`` (a copy of the JAX package's ``telemetry/exporters.py``;
the port imports nothing of that package and reads no environment).

* :func:`prometheus_text` renders a registry in the exposition format
  0.0.4 (``# HELP``/``# TYPE`` comments, labeled samples, cumulative
  histogram ``le`` buckets with ``+Inf``/``_sum``/``_count``);
* :class:`MetricsDumper` is what the resilient runner drops into its
  ``run_dir``: one JSON line per cadence tick (``every_s``, 60 s by
  default) with the registry's snapshot and the delta since the previous
  line, flushed once more at the end of a run, so a batch campaign's
  metrics land beside its journal without a server;
* :func:`read_metrics_jsonl` reads them back.
"""

from __future__ import annotations

import json
import os
import time as _time

from . import metrics as _metrics

#: Content-Type of the Prometheus text exposition format
PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"


def _fmt_value(v: float) -> str:
    if v != v:  # NaN
        return "NaN"
    if v in (float("inf"), float("-inf")):
        return "+Inf" if v > 0 else "-Inf"
    if float(v) == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def _escape(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{_escape(v)}"' for k, v in sorted(labels.items())) + "}"


def prometheus_text(registry=None) -> str:
    """A registry (the default one when None) in the Prometheus text
    exposition format 0.0.4: one sample per label set for counters and
    gauges; for histograms the cumulative ``<name>_bucket{le=...}`` series
    (the log-bucket upper edges, then ``+Inf``), ``<name>_sum`` and
    ``<name>_count``."""
    reg = registry if registry is not None else _metrics.default_registry()
    lines: list[str] = []
    for name, kind, help, rows in reg.families():
        if help:
            lines.append(f"# HELP {name} {help}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, metric in rows:
            if kind in ("counter", "gauge"):
                lines.append(f"{name}{_fmt_labels(labels)} {_fmt_value(metric.value)}")
            elif kind == "histogram":
                for le, count in metric.buckets():
                    lines.append(f"{name}_bucket{_fmt_labels(dict(labels, le=_fmt_value(le)))} "
                                 f"{count}")
                lines.append(f"{name}_bucket{_fmt_labels(dict(labels, le='+Inf'))} "
                             f"{metric.count}")
                lines.append(f"{name}_sum{_fmt_labels(labels)} {_fmt_value(metric.sum)}")
                lines.append(f"{name}_count{_fmt_labels(labels)} {metric.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def _host_suffixed(path: str) -> str:
    """``metrics.jsonl`` -> ``metrics.p<rank>.jsonl`` on a process other
    than the root of a multi-process run; the root and a lone process keep
    the plain name."""
    from ..parallel import multihost

    rank = multihost.process_index()
    if multihost.process_count() > 1 and rank != 0:
        root, ext = os.path.splitext(path)
        return f"{root}.p{rank}{ext}"
    return path


class MetricsDumper:
    """Cadenced ``metrics.jsonl`` writer for headless runs.

    :meth:`maybe_dump` runs at chunk boundaries and appends at most one
    line every ``every_s`` seconds: ``{"t", "wall_s", "step", "snapshot",
    "delta"}``, ``delta`` the registry's change since this dumper's
    previous line.  :meth:`dump` appends one unconditionally (run end,
    drain).  A process other than the root writes ``<stem>.p<rank><ext>``
    (:func:`_host_suffixed`), so processes sharing a run directory never
    interleave lines in one file."""

    def __init__(self, path: str, every_s: float = 60.0, registry=None):
        self.path = _host_suffixed(path)
        self.every_s = float(every_s)
        self.registry = registry if registry is not None else _metrics.default_registry()
        self._t0 = _time.monotonic()
        self._last_dump: float | None = None
        self._prev_snapshot: dict = {}
        self.dumps = 0

    def maybe_dump(self, step: int | None = None) -> bool:
        """Dump when the cadence elapsed; the first call only arms the
        clock."""
        now = _time.monotonic()
        if self._last_dump is None:
            self._last_dump = now
            return False
        if now - self._last_dump < self.every_s:
            return False
        return self.dump(step=step)

    def dump(self, step: int | None = None, force: bool = True) -> bool:
        del force  # the JAX package's signature
        if not _metrics.enabled():
            return False
        snap = self.registry.snapshot()
        record = {
            "t": _time.time(),
            "wall_s": round(_time.monotonic() - self._t0, 3),
            "step": step,
            "snapshot": snap,
            "delta": self.registry.delta(self._prev_snapshot),
        }
        try:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            with open(self.path, "a", encoding="utf-8") as fh:
                fh.write(json.dumps(record) + "\n")
        except OSError:
            return False  # metrics IO never ends the run
        self._prev_snapshot = snap
        self._last_dump = _time.monotonic()
        self.dumps += 1
        return True


def read_metrics_jsonl(path: str) -> list[dict]:
    """The records of a ``metrics.jsonl``; a torn final line (a kill
    mid-append) is skipped, a bad line inside the file raises."""
    records = []
    try:
        with open(path, encoding="utf-8") as fh:
            lines = fh.read().splitlines()
    except OSError:
        return []
    for i, line in enumerate(lines):
        line = line.strip()
        if not line:
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            if i == len(lines) - 1:
                continue  # torn tail
            raise
    return records
