"""Durable per-device quarantine ledger (a copy of the JAX package's
``integrity/ledger.py``).

One JSON file under the run dir records every integrity strike charged
to a device.  Strikes expire after ``strike_ttl_s`` (a transient upset
decays; sticky-bad silicon accumulates); a device whose LIVE strike
count reaches ``strikes`` is quarantined — the serve scheduler carves
sub-meshes around it, the fleet replica self-reports unhealthy, and the
journal carries ``device_quarantined``.

The file rides :func:`..utils.fsutil.atomic_write_text`
(tmp + fsync + rename + dirsync) so a replica restart — or a sibling
replica scanning the shared run dir — always reads a consistent ledger.
"""

from __future__ import annotations

import json
import os
import time

from ..utils.fsutil import atomic_write_text

LEDGER_NAME = "quarantine.json"


class QuarantineLedger:
    """Strike/expiry bookkeeping for one run dir (device keys are plain
    strings — the scheduler uses ``<platform>:<device_id>@proc<p>``).

    ``clock`` is injectable for tests (defaults to ``time.time``)."""

    def __init__(self, run_dir: str, *, strikes: int = 2,
                 strike_ttl_s: float = 3600.0, clock=time.time):
        self.path = os.path.join(run_dir, LEDGER_NAME)
        self.strikes = int(strikes)
        self.strike_ttl_s = float(strike_ttl_s)
        self._clock = clock

    # -- persistence ---------------------------------------------------------

    def _load(self) -> dict:
        try:
            with open(self.path, encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            return {"strikes": {}, "quarantined": {}}
        data.setdefault("strikes", {})
        data.setdefault("quarantined", {})
        return data

    def _save(self, data: dict) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        atomic_write_text(self.path, json.dumps(data, indent=1, sort_keys=True))

    # -- strikes -------------------------------------------------------------

    def _live(self, rows: list, now: float) -> list:
        ttl = self.strike_ttl_s
        return [r for r in rows if now - float(r.get("at", 0.0)) <= ttl]

    def strike(self, device: str, *, step: int | None = None,
               detail: str = "") -> bool:
        """Charge one strike; returns True when this strike NEWLY crosses
        the quarantine threshold (the caller journals
        ``device_quarantined`` and re-plans exactly once)."""
        now = float(self._clock())
        data = self._load()
        rows = self._live(data["strikes"].get(device, []), now)
        rows.append({"at": now, "step": step, "detail": detail})
        data["strikes"][device] = rows
        newly = False
        if len(rows) >= self.strikes and device not in data["quarantined"]:
            data["quarantined"][device] = {"at": now, "step": step,
                                           "strikes": len(rows)}
            newly = True
        self._save(data)
        return newly

    def strikes_for(self, device: str) -> int:
        """LIVE (unexpired) strikes currently charged to ``device``."""
        now = float(self._clock())
        return len(self._live(self._load()["strikes"].get(device, []), now))

    def quarantined(self) -> tuple:
        """Quarantined device keys, sorted (quarantine does not expire —
        releasing bad silicon back into the carve is a human decision:
        delete the ledger row)."""
        return tuple(sorted(self._load()["quarantined"]))

    def is_quarantined(self, device: str) -> bool:
        return device in self._load()["quarantined"]
