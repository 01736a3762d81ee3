"""JSONL run journal: the append-only event log (a copy of the JAX
package's ``utils/journal.py``; the port imports nothing of that package).

One record per line, appended by :class:`JournalWriter` (one open handle,
a flush after every append, an absolute ``t`` stamp on every row) and read
back by :func:`read_journal`, which skips a torn final line (what a crash
mid-append leaves) and raises :class:`JournalError` on a bad line inside
the file (``on_error="skip"`` skips those too).  The statistics' event
reports (:func:`..models.stats.report_stats_event`) append to a model's
attached ``journal_writer``.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time


class JournalError(RuntimeError):
    """A journal file is corrupt beyond the expected torn trailing line.

    Carries the offending path and line number — interior garbage cannot
    come from a crashed append (those only tear the tail), so it signals
    bit rot or concurrent writers and must not be silently skipped."""

    def __init__(self, path: str, lineno: int, message: str):
        super().__init__(f"{path}:{lineno}: {message}")
        self.path = path
        self.lineno = lineno


class JournalWriter:
    """Append-only JSONL writer with per-event flush.

    The handle opens lazily (the run_dir may not exist yet at construction)
    and stays open across appends; every append is one ``write`` + ``flush``
    so the line reaches the OS before the caller proceeds.  Thread-safe:
    async checkpoint completions journal from pipeline workers.  Append
    failures are reported to stderr, never raised — journaling must not
    kill the run it is documenting."""

    def __init__(self, path: str):
        self.path = path
        self._fh = None
        self._lock = threading.Lock()

    def append(self, record: dict) -> None:
        # every row carries an ABSOLUTE unix stamp next to whatever
        # run-relative clock the caller adds: per-incarnation wall_s values
        # cannot be compared across restarts, but request-trace assembly
        # (telemetry/reqtrace.py) must order one request's rows across any
        # number of incarnations on one timeline
        if "t" not in record:
            record = {"t": round(time.time(), 6), **record}
        try:
            with self._lock:
                if self._fh is None:
                    os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
                    self._fh = open(self.path, "a", encoding="utf-8")
                self._fh.write(json.dumps(record) + "\n")
                self._fh.flush()
        except OSError as exc:
            print(f"unable to append journal {self.path}: {exc}", file=sys.stderr)

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                try:
                    self._fh.close()
                except OSError:
                    pass
                self._fh = None


def read_journal(path: str, on_error: str = "raise") -> list[dict]:
    """Parse a JSONL journal into a list of dicts.

    A malformed FINAL line is the torn-append crash artifact: skipped with
    a warning (stderr), regardless of ``on_error``.  A malformed interior
    line raises :class:`JournalError` (``on_error="raise"``, default) or is
    skipped (``on_error="skip"`` — for best-effort diagnostic readers like
    the DivergenceError dt-trajectory report).  A missing file is an empty
    journal, not an error."""
    if on_error not in ("raise", "skip"):
        raise ValueError(f"on_error must be 'raise' or 'skip', got {on_error!r}")
    try:
        with open(path, encoding="utf-8") as fh:
            lines = fh.readlines()
    except OSError:
        return []
    records: list[dict] = []
    bad: list[tuple[int, str]] = []  # (lineno, line) parse failures
    for lineno, line in enumerate(lines, start=1):
        if not line.strip():
            continue
        try:
            records.append(json.loads(line))
        except ValueError:
            bad.append((lineno, line))
            records.append(None)  # placeholder: position decides tail vs interior
    # a trailing failure is the torn-append artifact; interior ones are not
    while records and records[-1] is None:
        lineno, line = bad.pop()
        records.pop()
        print(
            f"journal {path}: skipping torn trailing record at line {lineno} "
            f"({len(line)} bytes) — expected after a hard kill mid-append",
            file=sys.stderr,
        )
    if bad:
        lineno, _ = bad[0]
        if on_error == "raise":
            raise JournalError(
                path,
                lineno,
                "unparseable interior record (not a torn tail: a crashed "
                "append can only truncate the final line)",
            )
        records = [r for r in records if r is not None]
        print(
            f"journal {path}: skipped {len(bad)} corrupt interior record(s) "
            f"(first at line {lineno})",
            file=sys.stderr,
        )
    return records
