"""Live in-process metrics: labeled counters, gauges and log-bucketed
histograms behind a thread-safe registry (a copy of the JAX package's
``telemetry/metrics.py``; the port imports nothing of that package).

Every layer records into one default registry: host-side scalars the run
already fetched (write counts and seconds of the IO pipeline, chunk
statuses), never device values, so an instrumented run steps exactly as an
uninstrumented one.  Histograms are log-bucketed (about ten buckets a
decade), so percentiles come from a bounded set of counters however many
observations arrive.  :func:`set_enabled` turns recording off (every
lookup then returns one shared no-op metric); there is no environment
switch.  :func:`merge_snapshots` folds per-process snapshots into one
view; :func:`gather_global_snapshot` gathers every process's over
``multihost.allgather_bytes`` and merges them (the local snapshot in one
process).
:class:`ThroughputMonitor` keeps a rolling steps/s baseline and reports a
``perf_degraded`` record when a boundary's rate falls below a share of it.
"""

from __future__ import annotations

import math
import threading
import time as _time

_ENABLED = True


def enabled() -> bool:
    """Is metric recording on (default on; :func:`set_enabled`)?"""
    return _ENABLED


def set_enabled(flag: bool) -> None:
    """Turn metric recording on or off for the process.  Off routes every
    registry lookup to one shared no-op metric; handles callers already
    hold keep working."""
    global _ENABLED
    _ENABLED = bool(flag)


class _NullMetric:
    """Shared do-nothing stand-in handed out while telemetry is disabled."""

    def inc(self, amount=1.0):
        pass

    def dec(self, amount=1.0):
        pass

    def set(self, value):
        pass

    def observe(self, value):
        pass

    @property
    def value(self):
        return 0.0


_NULL = _NullMetric()


class Counter:
    """Monotonically increasing float counter (Prometheus semantics)."""

    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError(f"counters only go up (inc {amount})")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> dict:
        return {"value": self._value}


class Gauge:
    """Point-in-time value (queue depth, current dt, slot utilization)."""

    kind = "gauge"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value

    def to_dict(self) -> dict:
        return {"value": self._value}


class Histogram:
    """Log-bucketed histogram: percentiles without sample retention.

    Observations land in geometric buckets with edge ratio ``base`` (the
    default ``10**0.1`` ≈ 1.26 gives 10 buckets per decade, so any derived
    quantile carries at most ~26% relative error — plenty for latency/
    seconds telemetry while the storage stays a handful of integers however
    many observations arrive).  Non-positive observations land in a
    dedicated zero-bucket.  ``quantile(q)`` interpolates on the cumulative
    bucket counts and returns the (geometric) midpoint of the target
    bucket; ``buckets()`` yields Prometheus-style cumulative ``(le, n)``
    pairs."""

    kind = "histogram"

    def __init__(self, base: float = 10.0 ** 0.1):
        if base <= 1.0:
            raise ValueError(f"bucket ratio must exceed 1 (got {base})")
        self._lock = threading.Lock()
        self._base = float(base)
        self._log_base = math.log(self._base)
        self._counts: dict[int, int] = {}  # bucket index -> count
        self._zero = 0  # observations <= 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _index(self, value: float) -> int:
        # bucket i covers (base**(i-1), base**i]
        return int(math.ceil(math.log(value) / self._log_base - 1e-12))

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            self.count += 1
            if not math.isfinite(value):
                # counted (the event happened) but kept OUT of sum/min/max:
                # one NaN/inf observation must not poison _sum — and every
                # rate()/avg query over it — for the process lifetime
                self._zero += 1
                return
            self.sum += value
            self.min = min(self.min, value)
            self.max = max(self.max, value)
            if value <= 0.0:
                self._zero += 1
            else:
                idx = self._index(value)
                self._counts[idx] = self._counts.get(idx, 0) + 1

    def buckets(self) -> list[tuple[float, int]]:
        """Cumulative ``(upper_edge, count)`` pairs, ascending (the
        Prometheus ``le`` series, +Inf omitted — it equals ``count``)."""
        with self._lock:
            items = sorted(self._counts.items())
            zero = self._zero
        out = []
        cum = zero
        if zero:
            out.append((0.0, zero))
        for idx, n in items:
            cum += n
            out.append((self._base ** idx, cum))
        return out

    def quantile(self, q: float) -> float:
        """Approximate q-quantile (0..1) from the bucket counts: the
        geometric midpoint of the bucket holding the target rank."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile must be in [0, 1], got {q}")
        with self._lock:
            total = self.count
            if total == 0:
                return float("nan")
            rank = q * total
            cum = self._zero
            if cum >= rank and self._zero:
                return 0.0
            for idx, n in sorted(self._counts.items()):
                cum += n
                if cum >= rank:
                    lo, hi = self._base ** (idx - 1), self._base ** idx
                    return math.sqrt(lo * hi)
            return self.max

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else float("nan")

    def to_dict(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            zero = self._zero
            count, total = self.count, self.sum
            mn = self.min if count else None
            mx = self.max if count else None
        d = {
            "count": count,
            "sum": total,
            "min": mn,
            "max": mx,
            "zero": zero,
            "base": self._base,
            "counts": {str(k): v for k, v in counts.items()},
        }
        if count:
            d.update(
                p50=self.quantile(0.5), p90=self.quantile(0.9),
                p99=self.quantile(0.99),
            )
        return d

    def merge_dict(self, other: dict) -> None:
        """Fold another histogram's ``to_dict`` payload in (multihost
        aggregation; bases must match — every host runs the same code)."""
        with self._lock:
            if abs(float(other.get("base", self._base)) - self._base) > 1e-12:
                raise ValueError("cannot merge histograms with different bases")
            for key, n in other.get("counts", {}).items():
                idx = int(key)
                self._counts[idx] = self._counts.get(idx, 0) + int(n)
            self._zero += int(other.get("zero", 0))
            self.count += int(other.get("count", 0))
            self.sum += float(other.get("sum", 0.0))
            if other.get("min") is not None:
                self.min = min(self.min, float(other["min"]))
            if other.get("max") is not None:
                self.max = max(self.max, float(other["max"]))


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


class MetricsRegistry:
    """Thread-safe collection of named, labeled metrics.

    ``counter/gauge/histogram`` are get-or-create (idempotent: the same
    (name, labels) always returns the same handle, so callers need no
    module-level globals); a name registered as one kind cannot be reused
    as another.  ``snapshot()`` is a plain-JSON view of everything;
    ``delta(prev)`` subtracts a previous snapshot's counters/histogram
    counts — the cadenced jsonl exporter's rate view."""

    def __init__(self):
        self._lock = threading.Lock()
        # name -> (kind, {label_key: metric, ...}, help)
        self._families: dict[str, tuple[str, dict, str]] = {}

    def _get(self, cls, name: str, help: str, labels: dict):
        if not _ENABLED:
            return _NULL
        key = _label_key(labels)
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = (cls.kind, {}, help)
                self._families[name] = fam
            kind, series, _ = fam
            if kind != cls.kind:
                raise ValueError(
                    f"metric {name!r} already registered as a {kind}, "
                    f"requested {cls.kind}"
                )
            metric = series.get(key)
            if metric is None:
                metric = cls()
                series[key] = metric
            return metric

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", **labels) -> Histogram:
        return self._get(Histogram, name, help, labels)

    def clear(self) -> None:
        """Drop every registered metric (tests; a fresh-process analogue)."""
        with self._lock:
            self._families.clear()

    def families(self) -> list[tuple[str, str, str, list]]:
        """``(name, kind, help, [(labels_dict, metric), ...])`` rows, name
        order — the exporters' iteration surface."""
        with self._lock:
            fams = {
                name: (kind, dict(series), help)
                for name, (kind, series, help) in self._families.items()
            }
        out = []
        for name in sorted(fams):
            kind, series, help = fams[name]
            rows = [
                (dict(key), metric) for key, metric in sorted(series.items())
            ]
            out.append((name, kind, help, rows))
        return out

    def snapshot(self) -> dict:
        """Plain-JSON view: ``{name: {"kind", "help", "series": [
        {"labels": {...}, ...metric fields...}]}}``."""
        snap = {}
        for name, kind, help, rows in self.families():
            snap[name] = {
                "kind": kind,
                "help": help,
                "series": [
                    {"labels": labels, **metric.to_dict()}
                    for labels, metric in rows
                ],
            }
        return snap

    def delta(self, prev: dict) -> dict:
        """Current snapshot minus ``prev`` for the cumulative kinds
        (counter values and histogram count/sum); gauges pass through as
        point-in-time values.  Series absent from ``prev`` report their
        full value."""
        cur = self.snapshot()
        out = {}
        for name, fam in cur.items():
            pseries = {}
            if name in prev and prev[name].get("kind") == fam["kind"]:
                for s in prev[name].get("series", []):
                    pseries[_label_key(s.get("labels", {}))] = s
            rows = []
            for s in fam["series"]:
                p = pseries.get(_label_key(s.get("labels", {})))
                row = dict(s)
                if p is not None:
                    if fam["kind"] == "counter":
                        row["value"] = s["value"] - p.get("value", 0.0)
                    elif fam["kind"] == "histogram":
                        row["count"] = s["count"] - p.get("count", 0)
                        row["sum"] = s["sum"] - p.get("sum", 0.0)
                rows.append(row)
            out[name] = {**fam, "series": rows}
        return out


#: the process-wide default registry every instrumented layer records into
REGISTRY = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    return REGISTRY


def counter(name: str, help: str = "", **labels) -> Counter:
    return REGISTRY.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return REGISTRY.gauge(name, help, **labels)


def histogram(name: str, help: str = "", **labels) -> Histogram:
    return REGISTRY.histogram(name, help, **labels)


def snapshot() -> dict:
    return REGISTRY.snapshot()


# -- multihost aggregation ----------------------------------------------------


def merge_snapshots(snaps: list[dict]) -> dict:
    """Merge per-host snapshots into one fleet view: counters sum,
    histograms merge bucket-wise, gauges keep per-host values (labeled
    ``host=<i>`` when hosts disagree; a single shared value stays plain).
    Used by :func:`gather_global_snapshot`; host order is rank order."""
    if not snaps:
        return {}
    if len(snaps) == 1:
        return snaps[0]
    out: dict = {}
    for host, snap in enumerate(snaps):
        for name, fam in snap.items():
            tgt = out.setdefault(
                name, {"kind": fam["kind"], "help": fam.get("help", ""),
                       "series": []}
            )
            index = {
                _label_key(s.get("labels", {})): s for s in tgt["series"]
            }
            for s in fam.get("series", []):
                labels = dict(s.get("labels", {}))
                if fam["kind"] == "gauge" and len(snaps) > 1:
                    labels["host"] = str(host)
                key = _label_key(labels)
                cur = index.get(key)
                if cur is None:
                    row = dict(s)
                    row["labels"] = labels
                    tgt["series"].append(row)
                    index[key] = row
                elif fam["kind"] == "counter":
                    cur["value"] = cur.get("value", 0.0) + s.get("value", 0.0)
                elif fam["kind"] == "histogram":
                    h = Histogram(base=float(cur.get("base", 10.0 ** 0.1)))
                    h.merge_dict(cur)
                    h.merge_dict(s)
                    merged = h.to_dict()
                    merged["labels"] = cur["labels"]
                    cur.clear()
                    cur.update(merged)
    return out


def gather_global_snapshot(registry: MetricsRegistry | None = None) -> dict:
    """The fleet snapshot: each process JSON-encodes its local snapshot, the
    blobs ride :func:`..parallel.multihost.allgather_bytes`, and every
    process merges the stack alike (a collective on more than one process).
    In one process it is the local snapshot."""
    import json

    from ..parallel import multihost

    reg = registry if registry is not None else REGISTRY
    local = reg.snapshot()
    if multihost.process_count() == 1:
        return local
    blobs = multihost.allgather_bytes(json.dumps(local).encode("utf-8"))
    return merge_snapshots([json.loads(blob.decode("utf-8")) for blob in blobs])


# -- the SLO loop-closer ------------------------------------------------------


class ThroughputMonitor:
    """Rolling steps/s baseline with a typed degradation verdict — the
    piece that turns the observability layer back into a robustness
    signal: the resilient runner feeds it the committed step count at each
    chunk boundary and journals a ``perf_degraded`` event whenever the
    boundary-to-boundary rate falls below ``tolerance`` of the rolling
    median baseline.

    * ``window`` — boundaries in the rolling baseline (median of the last
      N rates, so one slow boundary cannot poison the baseline),
    * ``warmup`` — boundaries ignored before any verdict (compile /
      cache-warm boundaries are legitimately slow),
    * ``tolerance`` — degraded when ``rate < tolerance * baseline``,
    * ``min_interval_s`` — report at most one event per interval (a
      sustained regression journals a heartbeat, not a line per chunk),
    * ``clock`` — injectable time source (tests).
    """

    def __init__(
        self,
        window: int = 16,
        warmup: int = 3,
        tolerance: float = 0.5,
        min_interval_s: float = 30.0,
        clock=_time.monotonic,
    ):
        from collections import deque

        self.window = int(window)
        self.warmup = int(warmup)
        self.tolerance = float(tolerance)
        self.min_interval_s = float(min_interval_s)
        self._clock = clock
        self._rates = deque(maxlen=self.window)
        self._seen = 0
        self._last_t: float | None = None
        self._last_report: float = -math.inf
        self.baseline: float | None = None
        self.events = 0

    def record(self, steps: int) -> dict | None:
        """One chunk boundary: ``steps`` committed since the previous call.
        Returns a ``perf_degraded`` payload (rate, baseline, ratio) when
        the regression fires, else None."""
        now = self._clock()
        last, self._last_t = self._last_t, now
        if last is None or steps <= 0:
            return None
        elapsed = now - last
        if elapsed <= 0:
            return None
        rate = steps / elapsed
        self._seen += 1
        verdict = None
        if (
            self._seen > self.warmup
            and self.baseline
            and rate < self.tolerance * self.baseline
            and now - self._last_report >= self.min_interval_s
        ):
            self._last_report = now
            self.events += 1
            verdict = {
                "steps_per_sec": round(rate, 3),
                "baseline_steps_per_sec": round(self.baseline, 3),
                "ratio": round(rate / self.baseline, 4),
                "tolerance": self.tolerance,
            }
        self._rates.append(rate)
        if self._seen >= self.warmup:
            ordered = sorted(self._rates)
            self.baseline = ordered[len(ordered) // 2]
        gauge("runner_steps_per_sec", "committed steps/s at chunk boundaries").set(rate)
        return verdict
