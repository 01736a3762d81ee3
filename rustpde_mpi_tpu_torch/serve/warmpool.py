"""Warm campaign pools: prebuilt campaigns with their chunk graphs captured
(the cold-start killer; the JAX package's ``serve/warmpool.py``, the same
profile rows and pool accounting).

At production request rates the build of a campaign is the p99: every
novel ``compat_key`` pays a model build plus, on the card, the warm-up and
capture of its chunk graphs at admission, and the journal already
measures it (per-key ``compile_build`` rows,
``serve_time_to_first_chunk_seconds{key}``).  This module closes the loop:

* a **traffic profile** — the expected (model kind × grid × K × dt-rung)
  matrix, either seeded explicitly via ``ServeConfig.warm_profile`` (a path
  to a durable JSON or an inline ``[{"key": [...], "k": int}, ...]`` list)
  or learned from the journal's historical ``compile_build`` rows
  (:func:`learn_profile` / the ``"journal"`` sentinel),
* a **background builder** — a daemon thread that walks the profile at
  service start and builds each entry through the scheduler-supplied build
  callback (the SAME arming ``_build_runner`` performs: registry build,
  sentinels, stats, the K-member served ensemble with every lane dead)
  and builds its chunk runner: the kernels' libraries loaded, every
  wrapper warmed and the K-member step captured as CUDA graphs
  (``NavierEnsemble.chunk_runner``; the JAX package lowers and compiles
  its scan buckets instead) — service start is never serialized behind
  the matrix,
* a **warm pool** — prebuilt campaigns keyed by ``compat_key``; the
  scheduler's ``_build_runner`` takes a matching entry at bucket-open and
  admission-to-first-chunk skips the build and the capture (journaled
  ``warm_pool_hit``, accounting in telemetry/compile_log.py).

The builder captures on its own thread while the serving thread replays
other campaigns' graphs: captures, and the freeing of captured graphs (a
finished campaign's, :meth:`..models.campaign.StatsAndRungs.release_chunks`),
are serialized in the process (:data:`..models.campaign.CAPTURE_LOCK`), and
each capture runs thread-local on a stream of its own, so neither thread's
device work breaks the other's.  The pool is gated to one-process runtimes without
sub-meshes by the scheduler.  ``ServeConfig.warm_profile=None`` keeps all
of it inert — no thread, no journal rows.
"""

from __future__ import annotations

import json
import os
import threading
import time

from ..telemetry import compile_log as _cl

#: default bound on live pool entries (oldest evicted past it): the pool
#: holds whole device-resident ensembles, so it must stay small
MAX_ENTRIES = 8


def freeze_key(key) -> tuple:
    """Deep list->tuple normalization: compat keys round-trip through JSON
    (profiles, journal rows) as nested lists, and the pool/attribution tag
    is ``repr``-based — one canonical tuple form on every path."""
    if isinstance(key, (list, tuple)):
        return tuple(freeze_key(x) for x in key)
    return key


def load_profile(source) -> list[dict]:
    """Normalize a ``ServeConfig.warm_profile`` value into
    ``[{"key": tuple, "k": int | None}, ...]``: a path reads the durable
    JSON (missing/corrupt -> empty, the service must still boot), an inline
    list passes through.  Entries without a usable key are dropped."""
    if source is None:
        return []
    entries = source
    if isinstance(source, (str, os.PathLike)):
        try:
            with open(source) as fh:
                entries = json.load(fh)
        except (OSError, ValueError):
            return []
    out = []
    for ent in entries or []:
        try:
            key = freeze_key(ent["key"])
            k = ent.get("k")
            k = int(k) if k else None
        except (TypeError, KeyError, ValueError):
            continue
        if not isinstance(key, tuple) or not key:
            continue
        out.append({"key": key, "k": k})
    return out


def learn_profile(journal_path: str, max_entries: int = MAX_ENTRIES) -> list[dict]:
    """Learn a traffic profile from a serve journal: every live-path
    ``compile_build`` row (phase ``build``/``entry_points``, or legacy rows
    without a phase — never ``aot``, the pool must not learn from itself)
    votes for its key; entries come back most-built-first with the row's
    campaign ``k`` when recorded."""
    counts: dict[tuple, dict] = {}
    try:
        with open(journal_path) as fh:
            for line in fh:
                try:
                    row = json.loads(line)
                except ValueError:
                    continue
                if row.get("event") != "compile_build" or "key" not in row:
                    continue
                if row.get("phase") == "aot":
                    continue
                key = freeze_key(row["key"])
                ent = counts.setdefault(key, {"n": 0, "k": None})
                ent["n"] += 1
                if row.get("k"):
                    ent["k"] = int(row["k"])
    except OSError:
        return []
    ranked = sorted(counts.items(), key=lambda kv: -kv[1]["n"])
    return [
        {"key": key, "k": ent["k"]} for key, ent in ranked[:max_entries]
    ]


def save_profile(path: str, entries: list[dict]) -> None:
    """Atomically persist a learned profile as the durable JSON
    ``ServeConfig.warm_profile`` accepts (lists for the tuple keys)."""
    payload = [
        {"key": list(freeze_key(e["key"])), "k": e.get("k")} for e in entries
    ]
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as fh:
        json.dump(payload, fh, default=str)
    os.replace(tmp, path)


class WarmPool:
    """Prebuilt campaign pool: profile entries are built in a background
    daemon thread through ``build_fn(key, k) -> (model, ens, graphs)``
    (``graphs``: the CUDA graphs the build captured; the journal row keeps
    the JAX package's ``executables`` key for it)
    and held keyed by compat key until the scheduler takes them at
    bucket-open.  ``take`` transfers OWNERSHIP — a taken entry is gone (the
    campaign mutates the ensemble in place), so a second campaign for the
    same key is a miss by design.  Hit/miss/eviction accounting rides
    telemetry/compile_log so tests and the bench read one source of truth;
    ``journal`` (when given) gets the durable copies."""

    def __init__(
        self,
        entries: list[dict],
        build_fn,
        journal=None,
        max_entries: int = MAX_ENTRIES,
    ):
        self._profile = list(entries)
        self._build_fn = build_fn
        self._journal = journal
        self._max_entries = int(max_entries)
        self._pool: dict[str, dict] = {}  # key_tag -> entry
        self._order: list[str] = []  # insertion order (eviction)
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        # profile tags not yet built: take() WAITS on these instead of
        # cold-building the same model the builder already has in flight
        # (the background build started earlier, so waiting is strictly
        # cheaper than a duplicate inline build)
        self._pending: set[str] = {
            _cl.key_tag(freeze_key(e["key"])) for e in entries
        }
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.built = 0
        self.build_errors = 0

    # -- background build ----------------------------------------------------

    def start(self) -> "WarmPool":
        """Begin the non-blocking warmup (idempotent)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._build_all, name="warm-pool", daemon=True
            )
            self._thread.start()
        return self

    def wait(self, timeout: float | None = None) -> bool:
        """Block until the warmup pass finished (tests/bench); True when
        the builder thread is done."""
        if self._thread is None:
            return True
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def stop(self) -> None:
        """Ask the builder to wind down (service drain); in-flight build
        finishes, remaining profile entries are skipped, waiters wake."""
        self._stop.set()
        with self._cond:
            self._pending.clear()
            self._cond.notify_all()

    def _build_all(self) -> None:
        for ent in self._profile:
            if self._stop.is_set():
                break
            key, k = ent["key"], ent.get("k")
            tag = _cl.key_tag(freeze_key(key))
            t0 = time.perf_counter()
            try:
                built = self._build_fn(key, k)
            except Exception as exc:  # a bad profile entry must not kill warmup
                self.build_errors += 1
                self._emit(
                    _cl.observe_warm_pool(
                        "error", key=key, error=f"{type(exc).__name__}: {exc}"
                    )
                )
                built = None
            if built is not None:
                model, ens, graphs = built
                self.built += 1
                self.put(key, model, ens)
                self._emit(
                    _cl.observe_warm_pool(
                        "aot",
                        key=key,
                        k=ens.k,
                        executables=int(graphs),
                        wall_s=round(time.perf_counter() - t0, 4),
                    )
                )
            with self._cond:
                self._pending.discard(tag)
                self._cond.notify_all()
        with self._cond:  # entries skipped by stop() must not strand waiters
            self._pending.clear()
            self._cond.notify_all()

    # -- pool ------------------------------------------------------------------

    def put(self, key, model, ens) -> None:
        tag = _cl.key_tag(freeze_key(key))
        evicted = []
        with self._lock:
            if tag in self._pool:
                self._order.remove(tag)
            self._pool[tag] = {"key": freeze_key(key), "model": model, "ens": ens}
            self._order.append(tag)
            while len(self._order) > self._max_entries:
                old = self._order.pop(0)
                evicted.append(self._pool.pop(old))
        for ent in evicted:
            self.evictions += 1
            self._emit(
                _cl.observe_warm_pool(
                    "evict", key=ent["key"], k=ent["ens"].k, reason="capacity"
                )
            )

    def take(self, key, k: int | None = None):
        """Pop the prebuilt campaign for ``key`` (``(model, ens)``), or None
        on a miss.  A key the builder still has IN FLIGHT is waited for
        first — the background build started earlier, so waiting beats a
        duplicate inline build.  A K mismatch is a miss AND an eviction —
        the prebuilt ensemble's member count is baked into its captured
        graphs, so it cannot serve a differently-sized campaign."""
        tag = _cl.key_tag(freeze_key(key))
        with self._cond:
            while tag in self._pending and tag not in self._pool:
                self._cond.wait()
            ent = self._pool.pop(tag, None)
            if ent is not None:
                self._order.remove(tag)
        if ent is None:
            self.misses += 1
            self._emit(_cl.observe_warm_pool("miss", key=key))
            return None
        if k is not None and int(k) != int(ent["ens"].k):
            self.misses += 1
            self.evictions += 1
            self._emit(
                _cl.observe_warm_pool(
                    "evict", key=key, k=ent["ens"].k, reason="k_mismatch"
                )
            )
            return None
        self.hits += 1
        self._emit(_cl.observe_warm_pool("hit", key=key, k=ent["ens"].k))
        return ent["model"], ent["ens"]

    def counts(self) -> dict:
        """Accounting snapshot (tests + the bench payload)."""
        with self._lock:
            pooled = len(self._pool)
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "built": self.built,
            "build_errors": self.build_errors,
            "pooled": pooled,
        }

    def _emit(self, payload: dict) -> None:
        if self._journal is not None:
            try:
                self._journal(payload)
            except Exception:
                pass  # accounting must never kill the builder/scheduler
