"""Wall-clock step detection for the fleet's wall-time consumers.

The lease layer never trusts the wall clock (observer-monotonic windows,
see lease.py) — but two fleet surfaces still read ``time.time()`` against
on-disk stamps: the replica-heartbeat staleness display
(:func:`~rustpde_mpi_tpu_torch.serve.fleet.proxy.read_replica_status`) and the
QoS deadline math (qos.py).  An NTP step on the reading host would make
every heartbeat look dead and every deadline look blown at once.

:class:`ClockMonitor` detects the step by comparing wall-clock progress
against ``time.monotonic()`` progress since an anchor: the difference is
the accumulated wall adjustment.  A step past the caller's threshold is
reported ONCE (``clock_skew`` journal row + RuntimeWarning), compensated
for the detecting scan, and then absorbed by re-anchoring — a permanent
NTP correction becomes the new normal after one grace scan instead of
mass-expiring state that was alive a second ago.
"""

from __future__ import annotations

import threading
import time
import warnings


class ClockMonitor:
    """One wall-vs-monotonic drift tracker (clocks injectable for tests).

    ``check(threshold_s)`` returns the detected step size (0.0 in the
    steady state): positive = the wall clock jumped FORWARD, negative =
    backward.  Detection re-anchors, so each step is reported once."""

    def __init__(self, wall=time.time, mono=time.monotonic):
        self._wall = wall
        self._mono = mono
        self._lock = threading.Lock()
        self._anchor: tuple[float, float] | None = None
        self._latched = False

    def check(self, threshold_s: float, journal=None, where: str = "") -> float:
        """Detect a wall-clock step larger than ``threshold_s`` since the
        last anchor.  Returns the step in seconds for the caller to
        compensate its CURRENT scan by; journals/warns one-shot per
        process (the first step is the news — later ones ride the same
        root cause)."""
        w, m = self._wall(), self._mono()
        with self._lock:
            if self._anchor is None:
                self._anchor = (w, m)
                return 0.0
            aw, am = self._anchor
            skew = (w - aw) - (m - am)
            if abs(skew) <= float(threshold_s):
                return 0.0
            self._anchor = (w, m)  # absorb: the step is the new normal
            latched, self._latched = self._latched, True
        if not latched:
            row = {
                "event": "clock_skew",
                "skew_s": round(skew, 3),
                "where": where,
            }
            if journal is not None:
                try:
                    journal(row)
                except Exception:  # noqa: BLE001 — diagnosis must not crash
                    pass
            warnings.warn(
                f"wall clock stepped {skew:+.1f}s ({where or 'fleet'}): "
                "compensating this scan instead of mass-expiring state",
                RuntimeWarning,
                stacklevel=3,
            )
        return skew


#: process-wide monitor: every fleet wall-time consumer shares one anchor,
#: so a single NTP step is detected (and journaled) once, not per module
MONITOR = ClockMonitor()
