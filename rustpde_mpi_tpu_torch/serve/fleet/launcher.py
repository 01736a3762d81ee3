"""Pluggable replica launchers: how the autoscaler turns a scale
decision into a running ``SimServer`` replica process (and back).

The interface is deliberately tiny — ``spawn`` / ``retire`` / ``kill`` /
``alive`` / ``reap`` over opaque :class:`ReplicaHandle` records — so a
cloud backend (spot VM APIs, a k8s ReplicaSet patch) can slot in behind
the same :class:`~rustpde_mpi_tpu_torch.serve.fleet.autoscaler.Autoscaler`
control loop.  The shipped :class:`LocalProcessLauncher` runs replicas
as local subprocesses over ``python -m
rustpde_mpi_tpu_torch.serve.fleet.replica_main``.

Retirement is a SIGTERM, never a SIGKILL: the replica's own drain path
(durable park of running slots, lease release, clean exit — urgent when
``--preempt-notice-s`` arms the notice window) is the loss-free
mechanism; the launcher only delivers the signal.

Every choice a child needs is a command-line flag, never the
environment: ``--device`` (the parent's device), ``--preempt-notice-s``.
Several replicas on one card each hold their own CUDA context; the
kernels' libraries are built by the launcher before its first spawn on a
card (:func:`..._build.build`), so that no child builds them on its own
clock under a lease TTL.  ``kill`` exists for
chaos injection and last-resort cleanup.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field


@dataclass
class ReplicaHandle:
    """One launched replica as the launcher tracks it: identity, the
    backend's process (None for remote backends), and bookkeeping the
    autoscaler's spawn-grace window reads."""

    replica_id: str
    pid: int | None = None
    proc: object = None  # subprocess.Popen for the local backend
    spawned_mono: float = field(default_factory=time.monotonic)
    retired: bool = False


class ReplicaLauncher:
    """Backend interface the autoscaler drives.  Implementations own the
    mechanics of replica creation/destruction; the control law, journal
    and gauges stay in the autoscaler."""

    def spawn(self, replica_id: str) -> ReplicaHandle:
        """Start one replica under ``replica_id``; return its handle."""
        raise NotImplementedError

    def retire(self, handle: ReplicaHandle) -> None:
        """Ask one replica to drain and exit (graceful — the replica
        parks its running slots and releases its leases itself)."""
        raise NotImplementedError

    def kill(self, handle: ReplicaHandle) -> None:
        """Hard-stop one replica (chaos / cleanup; loss-free only
        because the fleet's lease-break + continuation machinery is)."""
        raise NotImplementedError

    def alive(self, handle: ReplicaHandle) -> bool:
        """Is the replica's backend process still running?"""
        raise NotImplementedError

    def reap(self) -> list[ReplicaHandle]:
        """Collect exited replicas; return their handles."""
        raise NotImplementedError

    # -- gang-shaped capacity (two-level serving) -------------------------------

    def spawn_gang(self, replica_ids: list[str]) -> list[ReplicaHandle]:
        """Spawn a fate-shared replica group ALL-OR-NOTHING: either every
        id comes up or the partial gang is killed and the spawn failure
        re-raised.  A lone gang member is worse than no gang — it claims
        a member lease and then wedges the sub-mesh collective its
        missing peers never join — so partial success is never returned
        (the same rollback contract ``GangLease.form`` makes for
        leases)."""
        handles: list[ReplicaHandle] = []
        try:
            for rid in replica_ids:
                handles.append(self.spawn(rid))
        except Exception:
            for handle in handles:
                try:
                    self.kill(handle)
                except Exception:  # noqa: BLE001 — rollback is best effort
                    pass
            raise
        return handles

    def retire_gang(self, handles: list[ReplicaHandle]) -> None:
        """Retire a whole gang together: every member gets the drain
        signal in one pass, so the gang parks as a unit (sharded state
        through the two-phase continuation writer) instead of one member
        draining while its peers block on the next collective."""
        for handle in handles:
            self.retire(handle)


class LocalProcessLauncher(ReplicaLauncher):
    """Local-subprocess backend: each replica is ``python -m
    rustpde_mpi_tpu_torch.serve.fleet.replica_main --run-dir <run_dir>
    --replica-id <rid> --daemon --device <device>`` in this process's
    environment.  ``serve_args`` appends extra flags (slots, chunk-steps,
    lease-ttl-s, ...); ``notice_s`` passes ``--preempt-notice-s`` so a
    retire SIGTERM drains urgently inside the notice window; ``device`` is
    the children's device (None: the card); ``log_dir`` captures
    per-replica stdout/stderr files for post-mortems."""

    def __init__(
        self,
        run_dir: str,
        *,
        serve_args: list[str] | None = None,
        notice_s: float | None = None,
        env: dict | None = None,
        log_dir: str | None = None,
        python: str | None = None,
        device: str | None = None,
    ):
        self.run_dir = run_dir
        self.serve_args = list(serve_args or [])
        self.notice_s = notice_s
        self.env = dict(os.environ if env is None else env)
        self.device = "cuda" if device is None else str(device)
        self.log_dir = log_dir
        self.python = python or sys.executable
        self._handles: dict[str, ReplicaHandle] = {}
        self._built = False

    def handles(self) -> list[ReplicaHandle]:
        """Live view of every handle this launcher still tracks."""
        return list(self._handles.values())

    def _ensure_built(self) -> None:
        """Build the kernels' libraries once, before the first child on a
        card starts (children then load them; none builds on its own)."""
        if self._built or not self.device.startswith("cuda"):
            return
        from ...ops import _build

        _build.build()
        self._built = True

    def argv(self, replica_id: str) -> list[str]:
        """The child's command line."""
        argv = [
            self.python,
            "-m",
            "rustpde_mpi_tpu_torch.serve.fleet.replica_main",
            "--run-dir",
            self.run_dir,
            "--replica-id",
            replica_id,
            "--daemon",
            "--device",
            self.device,
        ]
        if self.notice_s is not None:
            argv += ["--preempt-notice-s", str(float(self.notice_s))]
        return argv + list(self.serve_args)

    def spawn(self, replica_id: str) -> ReplicaHandle:
        self._ensure_built()
        argv = self.argv(replica_id)
        stdout = stderr = subprocess.DEVNULL
        if self.log_dir is not None:
            os.makedirs(self.log_dir, exist_ok=True)
            stdout = stderr = open(  # noqa: SIM115 — owned by the child
                os.path.join(self.log_dir, f"{replica_id}.log"), "ab"
            )
        proc = subprocess.Popen(
            argv, env=self.env, stdout=stdout, stderr=stderr
        )
        if stdout is not subprocess.DEVNULL:
            stdout.close()  # the child holds its own descriptor now
        handle = ReplicaHandle(replica_id=replica_id, pid=proc.pid, proc=proc)
        self._handles[replica_id] = handle
        return handle

    def retire(self, handle: ReplicaHandle) -> None:
        handle.retired = True
        if handle.proc is not None and handle.proc.poll() is None:
            try:
                handle.proc.send_signal(signal.SIGTERM)
            except OSError:
                pass  # already gone: reap() collects it

    def kill(self, handle: ReplicaHandle) -> None:
        handle.retired = True
        if handle.proc is not None and handle.proc.poll() is None:
            try:
                handle.proc.kill()
            except OSError:
                pass

    def alive(self, handle: ReplicaHandle) -> bool:
        return handle.proc is not None and handle.proc.poll() is None

    def reap(self) -> list[ReplicaHandle]:
        gone = [
            h for h in self._handles.values() if not self.alive(h)
        ]
        for h in gone:
            if h.proc is not None:
                h.proc.wait()  # immediate: poll() already returned
            del self._handles[h.replica_id]
        return gone

    def shutdown(self, timeout_s: float = 30.0) -> None:
        """Retire every tracked replica and wait for clean exits,
        escalating to kill at the deadline — the controller's own
        teardown path (SIGTERM on the controller retires its fleet)."""
        for h in self.handles():
            self.retire(h)
        deadline = time.monotonic() + float(timeout_s)
        for h in self.handles():
            if h.proc is None:
                continue
            remaining = deadline - time.monotonic()
            try:
                h.proc.wait(timeout=max(0.1, remaining))
            except subprocess.TimeoutExpired:
                self.kill(h)
                h.proc.wait()
        self.reap()
