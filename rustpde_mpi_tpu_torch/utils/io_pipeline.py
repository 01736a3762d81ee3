"""Overlapped IO: observable futures, deferred chunk commits and an async
checkpoint writer (counterpart of the JAX package's
``utils/io_pipeline.py``).

* :class:`ObservableFuture`: device values whose copy to the host is
  already enqueued.  The constructor copies each CUDA tensor into a pinned
  host buffer (``non_blocking``, on the current stream) and records a CUDA
  event after the copies, so the values are those of the moment the future
  was made: a later graph replay that overwrites the same device buffers
  does not reach them.  ``ready()`` is the event's ``query()`` (always true
  on the CPU, where the copy is made at once); ``result()`` is one
  synchronisation on the event and one host conversion, cached.
* :class:`PendingChunkStatus`: a sentinel chunk whose commit decision is
  taken one host round trip later (``update_n_pending``): ``resolve()``
  reads the chunk's sentinel scalars and confirms the advance or restores
  the chunk-start copy, exactly as the synchronous ``update_n`` does.
* :class:`AsyncCheckpointWriter`: one background worker with a bounded
  window of writes in flight.  Only host work (numpy, h5py, os) runs on the
  worker; the device-to-host fetch stays on the submitting thread.  The
  first failure is re-raised at the next ``submit`` or ``drain``.
* :class:`IOPipeline`: the writer plus the diagnostics lag queue (callback
  lines emitted from futures, in FIFO order, at most ``diag_lag``
  boundaries late).

The writer counts into the metrics registry (:mod:`..telemetry.metrics`):
``io_writes_total``, ``io_write_seconds_total``, ``io_write_failures_total``,
``io_backpressure_seconds_total``, ``io_bytes_total``.
"""

from __future__ import annotations

import threading
import time as _time
from collections import deque

import torch

from ..telemetry import metrics as _tm


class AsyncWriteError(RuntimeError):
    """A background write failed.  Raised on the submitting thread at the
    next ``submit``/``drain`` after the failure, with the path and the
    original error as ``__cause__``."""

    def __init__(self, path: str, cause: BaseException):
        super().__init__(f"background write of {path!r} failed: {cause}")
        self.path = path


def _stage(arrays):
    """Enqueue the copy of ``arrays`` (a tensor, or a tuple or list of
    tensors and host values) to the host: ``(host, event)``, ``host`` of
    the same structure with pinned CPU tensors in place of CUDA ones,
    ``event`` recorded on the current stream after the copies (None when
    nothing was on a card)."""
    cards = []

    def one(x):
        if torch.is_tensor(x) and x.device.type == "cuda":
            out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            out.copy_(x.detach(), non_blocking=True)
            cards.append(x.device)
            return out
        if torch.is_tensor(x):
            return x.detach().clone()
        return x

    host = type(arrays)(one(x) for x in arrays) if isinstance(arrays, (tuple, list)) \
        else one(arrays)
    event = None
    if cards:
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(cards[0]))
    return host, event


def _to_host(host):
    """numpy values of staged host tensors (same structure)."""
    def one(x):
        return x.numpy() if torch.is_tensor(x) else x

    if isinstance(host, (tuple, list)):
        return type(host)(one(x) for x in host)
    return one(host)


class ObservableFuture:
    """Device values whose copy to the host is enqueued (module docstring).
    ``convert`` maps the fetched host values (numpy arrays, same structure)
    to the caller's value, once."""

    def __init__(self, arrays, convert=None):
        self._host, self._event = _stage(arrays)
        self._convert = convert
        self._value = None
        self._done = False

    def ready(self) -> bool:
        """Non-blocking: whether :meth:`result` would not wait."""
        return self._done or self._event is None or self._event.query()

    def result(self):
        """Wait for the copies (once) and return the converted value."""
        if not self._done:
            if self._event is not None:
                self._event.synchronize()
            host = _to_host(self._host)
            self._value = host if self._convert is None else self._convert(host)
            self._done = True
            self._host = self._event = None
        return self._value


class MappedFuture:
    """``fn`` of another future's result: the parent's copy is shared, so
    mapping costs no second transfer."""

    def __init__(self, parent, fn):
        self._parent = parent
        self._fn = fn
        self._value = None
        self._done = False

    def ready(self) -> bool:
        return self._parent.ready()

    def result(self):
        if not self._done:
            self._value = self._fn(self._parent.result())
            self._done = True
        return self._value


def immediate(value) -> ObservableFuture:
    """A future that is already resolved (host-side facts: latches, masks)."""
    fut = ObservableFuture(None)
    fut._value = value
    fut._done = True
    return fut


class PendingChunkStatus:
    """The deferred commit of one sentinel chunk (``update_n_pending``).
    The model is already advanced, provisionally, to the chunk's end, so
    the next chunk can be enqueued before this one's sentinel scalars are
    read; ``resolve()`` reads them (one transfer) and hands them to
    ``finish``, which confirms the advance or, on a CFL-ceiling trip,
    restores the chunk-start copy (state, time, statistics) and latches
    ``exit()``: the synchronous chunk's outcome, one round trip later.

    A caller running ahead must ``discard()``, never resolve, a later
    pending chunk once an earlier one rolled the model back: it was
    enqueued from the rolled-back provisional state."""

    def __init__(self, arrays, finish):
        self._future = ObservableFuture(arrays)
        self._finish = finish
        self._status = None
        self._discarded = False

    def ready(self) -> bool:
        """Non-blocking: whether the sentinel scalars are on the host."""
        if self._status is not None or self._discarded:
            return True
        return self._future.ready()

    def resolve(self):
        """Read the sentinel scalars and commit or roll back the
        provisional advance; idempotent, returns the chunk's status."""
        if self._discarded:
            raise RuntimeError("resolve() on a discarded pending chunk")
        if self._status is None:
            self._status = self._finish(self._future.result())
            self._future = self._finish = None
        return self._status

    def discard(self) -> None:
        """Drop a chunk that an earlier rollback made stale."""
        self._discarded = True
        self._future = self._finish = None


class WriteTicket:
    """Completion handle for one background write."""

    def __init__(self, path: str):
        self.path = path
        self.error: BaseException | None = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def wait(self, timeout: float | None = None) -> None:
        """Block until the write finished; re-raise its failure."""
        self._event.wait(timeout)
        if self.error is not None:
            raise AsyncWriteError(self.path, self.error) from self.error


class AsyncCheckpointWriter:
    """Single-worker background writer with a bounded in-flight window.

    ``submit(work, path)`` enqueues ``work()`` (pure host-side IO) and
    returns a :class:`WriteTicket`.  At most ``depth`` submissions are
    resident — queued *plus* the one being written — and an over-depth
    submit blocks until the oldest write LANDS, not merely until the
    worker picks it up (back-pressure: checkpoint cadence can never outrun
    the disk, and host memory holds at most ``depth`` pending snapshots).
    The first failure is sticky — it
    re-raises at every later ``submit`` and at ``drain`` until observed —
    so a dead disk stops the campaign at the next cadence, exactly where
    the synchronous writer would have stopped it.

    ``timeout_s`` (default None: no limit) bounds how long ``submit``
    back-pressure and ``drain`` may block on the worker: a disk wedged
    mid-``fsync`` then dumps every thread's stack and raises a typed
    :class:`AsyncWriteError` (cause ``TimeoutError``) on the submitting
    thread instead of hanging the run.  (A wedged disk hangs the
    synchronous writer the same way, inside fsync; the async writer is the
    one that can turn it into an error.)"""

    def __init__(self, depth: int = 1, timeout_s: float | None = None):
        import queue

        self.depth = max(1, int(depth))
        self.timeout_s = timeout_s
        # the queue itself is unbounded: the residency bound is _slots,
        # released only after a write COMPLETES (a maxsize queue alone
        # would admit depth+1 snapshots once the worker get()s the head)
        self._queue: "queue.Queue" = queue.Queue()
        self._slots = threading.Semaphore(self.depth)
        self._worker: threading.Thread | None = None
        self._failed: deque[WriteTicket] = deque()
        self._inflight: deque[WriteTicket] = deque()
        self._lock = threading.Lock()
        self.writes = 0  # completed writes
        self.write_s = 0.0  # worker seconds spent writing
        self.wait_s = 0.0  # submitter seconds blocked on back-pressure
        self.bytes = 0  # payload bytes handed to the worker

    def _ensure_worker(self) -> None:
        if self._worker is not None and self._worker.is_alive():
            return
        self._worker = threading.Thread(
            target=self._run, name="io-pipeline-writer", daemon=True
        )
        self._worker.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                work, ticket = item
                t0 = _time.monotonic()
                try:
                    work()
                except BaseException as exc:  # surfaced at submit/drain
                    ticket.error = exc
                    with self._lock:
                        self._failed.append(ticket)
                finally:
                    write_s = _time.monotonic() - t0
                    with self._lock:
                        self.writes += 1
                        self.write_s += write_s
                    _tm.counter(
                        "io_writes_total", "background writes completed"
                    ).inc()
                    _tm.counter(
                        "io_write_seconds_total", "worker seconds spent writing"
                    ).inc(write_s)
                    if ticket.error is not None:
                        _tm.counter(
                            "io_write_failures_total", "background writes that failed"
                        ).inc()
                    ticket._event.set()
                    self._slots.release()
            finally:
                self._queue.task_done()

    def _raise_failed(self) -> None:
        with self._lock:
            ticket = self._failed.popleft() if self._failed else None
        if ticket is not None:
            raise AsyncWriteError(ticket.path, ticket.error) from ticket.error

    def _hang(self, what: str, path: str) -> None:
        """Armed-timeout expiry: name the wedge, dump every thread's stack
        (the worker's shows where the disk is stuck), raise typed."""
        import faulthandler
        import sys

        print(
            f"io-pipeline writer stuck: {what} exceeded {self.timeout_s:.0f}s "
            f"({path!r}) — dumping all thread stacks",
            file=sys.stderr,
        )
        faulthandler.dump_traceback(all_threads=True, file=sys.stderr)
        err = TimeoutError(f"{what} exceeded {self.timeout_s:.0f}s")
        raise AsyncWriteError(path, err) from err

    def submit(self, work, path: str, nbytes: int = 0) -> WriteTicket:
        """Enqueue ``work()``; blocks while ``depth`` writes are in flight
        (at most ``timeout_s``, when armed).  Raises a pending
        :class:`AsyncWriteError` from an earlier failed write before
        enqueueing new work.  ``nbytes`` (the payload size, when the caller
        knows it) feeds the ``io_overlap`` telemetry."""
        self._raise_failed()
        self._ensure_worker()
        ticket = WriteTicket(path)
        with self._lock:
            self.bytes += int(nbytes)
        t0 = _time.monotonic()
        if not self._slots.acquire(timeout=self.timeout_s):
            self._hang(f"back-pressure wait ({self.depth} writes in flight)", path)
        waited = _time.monotonic() - t0
        self.wait_s += waited
        _tm.counter(
            "io_backpressure_seconds_total",
            "submitter seconds blocked on the in-flight write window",
        ).inc(waited)
        _tm.counter("io_bytes_total", "payload bytes handed to the writer").inc(
            int(nbytes)
        )
        with self._lock:
            while self._inflight and self._inflight[0].done():
                self._inflight.popleft()  # keep the deque bounded by depth+1
            self._inflight.append(ticket)
        self._queue.put((work, ticket))
        return ticket

    def drain(self, raise_errors: bool = True) -> None:
        """Block until every submitted write completed; re-raise the first
        unobserved failure (``raise_errors=False`` only waits — for cleanup
        paths that must not mask an in-flight exception).  With ``timeout_s``
        armed, the whole drain gets that long before the stuck write is
        surfaced as a typed hang (the in-flight window is bounded by
        ``depth``, so the budget covers at most ``depth`` writes)."""
        if self.timeout_s is None:
            self._queue.join()
        else:
            deadline = _time.monotonic() + self.timeout_s
            while True:
                with self._lock:
                    ticket = next(
                        (t for t in self._inflight if not t.done()), None
                    )
                if ticket is None:
                    break
                remaining = deadline - _time.monotonic()
                if remaining <= 0 or not ticket._event.wait(remaining):
                    self._hang("drain wait", ticket.path)
        if raise_errors:
            self._raise_failed()

    def pending_errors(self) -> bool:
        with self._lock:
            return bool(self._failed)

    def consume_errors(self) -> list[BaseException]:
        """Pop and return every sticky failure's ROOT CAUSE without
        raising.  A caller that can degrade on a failure class — the
        runner's ENOSPC containment turns disk-full checkpoints into
        in-memory-rollback-only mode — uses this to observe the causes
        and unwedge the writer; left in place, the backlog would
        re-raise at every later ``submit``, one write at a time."""
        out: list[BaseException] = []
        with self._lock:
            while self._failed:
                out.append(self._failed.popleft().error)
        return out

    def close(self) -> None:
        """Drain and stop the worker thread (errors NOT re-raised; call
        :meth:`drain` first when failures matter).  With ``timeout_s`` armed
        a wedged worker is ABANDONED (daemon thread) rather than joined
        forever — close runs on teardown paths that may already be
        propagating an exception."""
        if self._worker is None or not self._worker.is_alive():
            return
        if self.timeout_s is not None:
            try:
                self.drain(raise_errors=False)
            except AsyncWriteError:
                return  # wedged: leave the daemon thread behind
        else:
            self._queue.join()
        self._queue.put(None)
        self._worker.join(timeout=10.0)


class IOPipeline:
    """The per-run facade the models and the resilient runner share.

    One background :class:`AsyncCheckpointWriter` plus the diagnostics lag
    queue.  A model carrying this as its ``io_pipeline`` attribute has its
    callback IO (flow snapshots, the printed Nu line, info.txt rows) routed
    through it by :func:`.navier_io.callback`.  ``timeout_s`` bounds the
    writer's waits (None: no limit)."""

    def __init__(
        self,
        queue_depth: int = 1,
        diag_lag: int = 1,
        timeout_s: float | None = None,
    ):
        self.writer = AsyncCheckpointWriter(depth=queue_depth, timeout_s=timeout_s)
        self.diag_lag = max(0, int(diag_lag))
        self._diags: deque = deque()
        self._dropped_diags = 0

    # -- background writes ----------------------------------------------------

    def submit_write(self, work, path: str, nbytes: int = 0) -> WriteTicket:
        """Hand one host-side write to the worker (see
        :meth:`AsyncCheckpointWriter.submit`)."""
        return self.writer.submit(work, path, nbytes=nbytes)

    # -- lagged diagnostics ---------------------------------------------------

    def push_diag(self, emit, future) -> None:
        """Queue one callback emission: ``emit(future.result())`` runs once
        the values are ready, at most ``diag_lag`` pushes late, in FIFO
        order.  Ready entries are emitted immediately so a fast device (or
        the eager path) behaves exactly like the synchronous callback."""
        self._diags.append((emit, future))
        self._pump(block=False)

    def _pump(self, block: bool) -> None:
        while self._diags:
            emit, fut = self._diags[0]
            if not block and len(self._diags) <= self.diag_lag and not fut.ready():
                break  # young enough to stay pending
            self._diags.popleft()
            emit(fut.result())

    def flush_diags(self) -> None:
        """Emit every pending diagnostics entry (end of run)."""
        self._pump(block=True)

    def abandon_diags(self) -> int:
        """Drop pending diagnostic emissions without resolving their
        futures (a teardown after a wedged dispatch, whose futures would
        block for ever).  Returns the number of lines lost (also
        ``dropped_diags`` in :meth:`stats`)."""
        n = len(self._diags)
        self._dropped_diags += n
        self._diags.clear()
        return n

    # -- lifecycle ------------------------------------------------------------

    def drain(self, raise_errors: bool = True) -> None:
        """Flush diagnostics and wait for every background write; re-raises
        the first write failure unless ``raise_errors=False``."""
        self.flush_diags()
        self.writer.drain(raise_errors=raise_errors)

    def close(self) -> None:
        self.flush_diags()
        self.writer.close()

    def stats(self) -> dict:
        """Pipeline telemetry for run summaries/journals."""
        w = self.writer
        return {
            "writes": w.writes,
            "bytes": w.bytes,
            "write_s": round(w.write_s, 3),
            "queue_wait_s": round(w.wait_s, 3),
            "pending_diags": len(self._diags),
            "dropped_diags": self._dropped_diags,
        }
