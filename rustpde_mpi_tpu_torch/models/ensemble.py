"""NavierEnsemble: K member states of one Navier2D, stepped together.

Counterpart of the JAX package's ``models/ensemble.py`` (its
``NavierEnsemble``), with its in-scan statistics (per-member running sums,
one shared sample tick) and its dt rung cache (``set_dt`` through the
template model), its observable and break-check futures, per-member
state digests and shadow audits (:class:`.campaign.FuturesAndIntegrity`)
and its sharded checkpoints (:class:`.campaign.ShardedSurface`).  The JAX
package stacks K member states on a leading axis and advances them as one
``jax.vmap`` of the model's step, the Pallas kernels batched by
``pallas_call``'s batching rule.  Here the member-stacked
state goes through the template model's own step (:meth:`Navier2D._step`
takes a leading member dim), and every kernel launch of a step serves all K
members: a step of K members launches exactly what a solo step of the same
route launches.  The members share the model's operators, solvers and
kernel wrappers; only the state differs.

A chunk (:meth:`NavierEnsemble.update_n`) runs the JAX package's bucket
schedule on a :class:`.campaign.ChunkRunner` whose carry holds the stacked
fields, a per-member alive mask and per-member step counts: a member whose
stepped state is not finite freezes at its last finite state and stops
counting, while the others go on; once no member is alive the remaining
buckets are skipped (a host check before each bucket, where the JAX package
takes the identity branch of a ``lax.cond``).  With the template model's
stability sentinels armed, a member over the CFL ceiling freezes too, and
the whole chunk rolls back when any alive member pinned the ceiling.  On
the card each step replays one CUDA graph of the K-member step, captured
once per ensemble and sentinel setting; the carry is loaded from the
ensemble's state at each call and copied out into fresh tensors, so a
reference to an earlier ``state``, ``mask`` or ``steps_done`` stays as it
was.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..utils import checkpoint, navier_io
from ..utils.governor import ChunkStatus
from ..utils.jit import scan_buckets
from .campaign import ChunkRunner, FuturesAndIntegrity, ShardedSurface, StatsAndRungs


def _stack(members) -> tuple:
    """One state of member-stacked fields from a list of member states."""
    return type(members[0])(*(torch.stack([torch.as_tensor(x) for x in xs]) for xs in zip(*members)))


class NavierEnsemble(StatsAndRungs, FuturesAndIntegrity, ShardedSurface):
    """K member states of one :class:`..models.navier.Navier2D`, stepped
    together.

    ``states`` is a sequence of K member states or one state whose every
    field carries a leading K dim.  An unstacked state raises
    ``TypeError`` (wrap it in a list for K = 1); an empty sequence raises
    ``ValueError``."""

    #: maps a sentinel chunk's host rows (numpy, one row a scalar, members
    #: along the last axis) to the rows the chunk acts on: the resilient
    #: runner's reduction across processes, each holding its own replica
    #: (None: the local rows)
    sentinel_reduce = None

    def __init__(self, model, states):
        if hasattr(states, "_fields"):
            if states.temp.ndim != model.state.temp.ndim + 1:
                raise TypeError(
                    "NavierEnsemble expects a sequence of member states or a state whose "
                    "fields carry a leading K axis; got an unbatched state (wrap it in a list "
                    "for K=1)")
            stacked = type(states)(*(torch.as_tensor(x) for x in states))
        else:
            members = list(states)
            if not members:
                raise ValueError("ensemble needs at least one member state")
            stacked = _stack(members)
        self._init_stats_and_rungs()
        self.model = model
        self.k = int(stacked.temp.shape[0])
        self.dt = model.dt
        self.time = 0.0
        #: the callback's snapshot throttle, the template model's at
        #: construction (see ``Navier2D.write_intervall``)
        self.write_intervall = model.write_intervall
        #: per-member diagnostics history: each append is a length-K list
        self.diagnostics: dict[str, list] = {}
        self.last_chunk_status = None
        #: the seed of a persistent ``respawn_dead`` stream (None: per call)
        self.respawn_seed: int | None = None
        self._respawn_rng = None
        self._pre_div_latch = False
        self._solid = None  # per-member (fac, temp_add) of geometry_sweep
        dev = model.state.temp.device
        self.state = type(stacked)(*(x.to(dev).contiguous() for x in stacked))
        self.mask = self._finite_mask(self.state)
        self.steps_done = torch.zeros((self.k,), dtype=torch.int32, device=dev)
        # the statistics: per-member running sums, armed when the template
        # model's engine is
        self.reset_stats()

    # -- construction ----------------------------------------------------------

    @classmethod
    def from_seeds(cls, model, seeds, amp: float = 0.1) -> "NavierEnsemble":
        """K members from the model's random initial condition, one seed
        each (``init_random(amp, seed)``); the model's own state is
        restored afterwards."""
        keep = model.state
        members = []
        try:
            for seed in seeds:
                model.init_random(amp, seed=int(seed))
                members.append(model.state)
        finally:
            model.state = keep
        return cls(model, members)

    @classmethod
    def from_config(cls, cfg, mesh=None, **kwargs) -> "NavierEnsemble":
        """``max(1, cfg.ensemble)`` members of ``Navier2D.from_config(cfg,
        mesh, **kwargs)`` (which arms the sentinels and the statistics),
        as the JAX package's: seeds ``0..K-1`` at ``init_random_amp``, or,
        when that is unset or zero, K copies of the model's state."""
        from .navier import Navier2D

        model = Navier2D.from_config(cfg, mesh=mesh, **kwargs)
        k = max(1, int(cfg.ensemble))
        if not cfg.init_random_amp:
            return cls.replicate(model, k)
        return cls.from_seeds(model, range(k), amp=cfg.init_random_amp)

    @classmethod
    def replicate(cls, model, k: int) -> "NavierEnsemble":
        """K copies of the model's current state."""
        return cls(model, [model.state] * int(k))

    # -- member access ---------------------------------------------------------

    @property
    def ensemble_size(self) -> int:
        return self.k

    @property
    def nx(self) -> int:
        return self.model.nx

    @property
    def ny(self) -> int:
        return self.model.ny

    @property
    def compat_key(self) -> tuple:
        """The template model's operator-constant key: the members share
        it, so a slot may be refilled (:meth:`set_member`) by any state of a
        model with an equal key."""
        return self.model.compat_key

    @property
    def observable_names(self) -> tuple:
        return self.model.observable_names

    def member_state(self, i: int):
        """Member ``i``'s state as an unbatched state (fresh tensors)."""
        return type(self.state)(*(x[i].clone() for x in self.state))

    def fresh_member_state(self, seed: int, amp: float = 0.1):
        """A new random-initial-condition member state from the template
        model's generator; the model's own state is restored afterwards."""
        keep = self.model.state
        try:
            self.model.init_random(float(amp), seed=int(seed))
            return self.model.state
        finally:
            self.model.state = keep

    def set_member(self, i: int, state) -> None:
        """Replace member ``i``'s state, re-derive its alive flag from it
        and zero its step count; with the statistics armed its running sums
        restart (a refilled lane is a new trajectory; the shared tick runs
        on).  The ensemble's state, mask, counts and sums become fresh
        tensors; the captured chunks stay valid (their carry is loaded from
        them at each call)."""
        fields = []
        for x, leaf in zip(self.state, state):
            x = x.clone()
            x[i] = leaf
            fields.append(x)
        self.state = type(self.state)(*fields)
        if self.stats_state is not None:
            sums = []
            for x in self.stats_state:
                x = x.clone()
                x[i].zero_()
                sums.append(x)
            self.stats_state = type(self.stats_state)(*sums)
        self.mask = self.mask.clone()
        self.mask[i] = self.model._scan_ok(state)
        self.steps_done = self.steps_done.clone()
        self.steps_done[i] = 0
        self._obs_cache = None

    def get_field(self, name: str, member: int) -> np.ndarray:
        """Physical values of one member's variable (host numpy)."""
        space = getattr(self.model, f"{name}_space")
        leaf = getattr(self.state, name)[member]
        return space.gather_physical(space.backward(leaf)).cpu().numpy()

    def mark_dead(self, members) -> None:
        """Declare members dead: they freeze as diverged members do and
        become :meth:`respawn_dead` candidates."""
        mask = self.mask.clone()
        for i in members:
            mask[int(i)] = False
        self.mask = mask
        self._obs_cache = None

    def device_fence(self) -> None:
        """Block until every device computation whose output the ensemble
        holds has completed (its state, sums, counts and cached
        observables): a synchronize of the ensemble's card, nothing on the
        CPU.  The serving scheduler runs it before a host-level collective
        while a campaign occupies a proper sub-mesh
        (:func:`..parallel.multihost.set_device_fence`)."""
        dev = self.state.temp.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # -- status ----------------------------------------------------------------

    def _finite_mask(self, stacked) -> torch.Tensor:
        """The per-member continue criterion (the model's ``_scan_ok`` per
        member), a ``(K,)`` bool tensor."""
        return self.model._scan_ok(stacked, lead=1)

    def alive(self) -> np.ndarray:
        """The per-member alive mask, host bools of shape (K,)."""
        return self.mask.cpu().numpy()

    def done_ok_members(self) -> np.ndarray:
        """Members that stopped by the model's success criterion (the
        template's ``_scan_done_ok`` per member, host bools of shape (K,)):
        the adjoint finder's converged members; none for the DNS, whose
        members stop only by divergence."""
        return self.model._scan_done_ok(self.state, lead=1).cpu().numpy()

    def state_healthy(self) -> bool:
        """Whether the ensemble is worth keeping: not latched by a sentinel
        catch, and some member alive or finished successfully."""
        if self._pre_div_latch:
            return False
        return bool(self.alive().any() or self.done_ok_members().any())

    def exit(self) -> bool:
        """Break criterion: every member dead (one NaN member freezes and is
        reported per member; it does not end the run), or a latched
        pre-divergence catch of the sentinels."""
        if self._pre_div_latch:
            return True
        return not bool(self.alive().any())

    def get_time(self) -> float:
        return self.time

    def get_dt(self) -> float:
        return self.dt

    def reset_time(self) -> None:
        self.time = 0.0

    # -- chunks ----------------------------------------------------------------

    @property
    def _stability(self):
        """The sentinel config lives on the template model."""
        return self.model._stability

    def set_stability(self, cfg) -> None:
        """Arm (a :class:`..config.StabilityConfig`) or disarm (None) the
        template model's stability sentinels for the ensemble's chunks."""
        self.model.set_stability(cfg)
        self.last_chunk_status = None
        self._pre_div_latch = False

    def clear_pre_divergence(self) -> None:
        """Acknowledge a ``pre_divergence`` catch: unlatch :meth:`exit`."""
        self._pre_div_latch = False

    @property
    def pre_divergence_latched(self) -> bool:
        """True while an unacknowledged sentinel catch latches :meth:`exit`
        (``last_chunk_status.pinned`` names the tripping members)."""
        return bool(self._pre_div_latch)

    def _set_solids(self, fac, temp_add) -> None:
        """Per-member penalization factors (leading K dim) for every step,
        in place of the template model's (:func:`..workloads.geometry_sweep`);
        the captured chunks, which hold the old ones, are dropped."""
        self._solid = None if fac is None else (fac, temp_add)
        self._drop_chunks()

    def chunk_runner(self, armed: bool | None = None, stats: bool | None = None) -> ChunkRunner:
        """The runner of the plain (``armed=False``) or the sentinel chunk
        (``True``; default: as the template model's sentinels are), without
        or with the statistics (``stats``; default: as :meth:`set_stats`
        left them), built at the first call: on a CUDA device that warms up
        every kernel wrapper and captures the K-member step as a CUDA graph
        (with statistics, also the step plus the sample), so a caller who
        wants the capture out of a timed or counted run calls this
        first."""
        armed = self._stability is not None if armed is None else armed
        stats = self.stats_armed if stats is None else stats
        if armed and self._stability is None:
            raise RuntimeError("the sentinel chunk needs set_stability(cfg) first")
        if stats and not self.stats_armed:
            raise RuntimeError("the statistics chunk needs set_stats(cfg) first")
        runner = self._runners.get((armed, stats))
        if runner is None:
            model = self.model
            carry = [f.clone(memory_format=torch.contiguous_format) for f in self.state]
            dev, k = carry[0].device, self.k
            carry += [torch.ones((k,), dtype=torch.bool, device=dev) for _ in range(1 + armed)]
            carry.append(torch.zeros((k,), dtype=torch.int32, device=dev))
            carry += [torch.zeros((k,), dtype=model.dtype, device=dev) for _ in range(4 * armed)]
            kernels = [w for ws in model.kernels().values() for w in ws]
            step = model._advance_members_sentinels if armed else model._advance_members
            advance = partial(step, solid=self._solid)
            runner = self._stats_runner(advance, carry, kernels) if stats else \
                ChunkRunner(advance, carry, kernels)
            self._runners[(armed, stats)] = runner
        return runner

    def _load(self, runner: ChunkRunner, *flags, state=None) -> None:
        """Copy the state (``state``, default the ensemble's) and ``flags``
        (the leading scalars of the carry) into the runner's carry and zero
        the rest (running maxima); the statistics slots are
        :meth:`_load_stats`'s."""
        nf = len(self.state)
        for buf, f in zip(runner.carry[:nf], self.state if state is None else state):
            buf.copy_(f)
        rest = runner.carry[nf:len(runner.carry) - runner.n_stats]
        for buf, f in zip(rest, flags):
            if isinstance(f, bool):
                buf.fill_(f)
            else:
                buf.copy_(f)
        for buf in rest[len(flags):]:
            buf.zero_()

    def _unload(self, runner: ChunkRunner):
        """Fresh tensors of the carry's state."""
        return type(self.state)(*(t.clone() for t in runner.carry[: len(self.state)]))

    def update(self) -> None:
        self.update_n(1)

    def update_n(self, n: int):
        """Advance every alive member ``n`` steps in the bucket schedule of
        :func:`..utils.jit.scan_buckets`; ``time`` counts the scheduled
        steps, ``steps_done`` how far each member got.  The alive mask runs
        through the buckets and across calls (a dead member stays dead until
        :meth:`set_member` or :meth:`respawn_dead`).  With the statistics
        armed the members' running sums and the shared tick ride the chunk.

        With the template model's sentinels armed it returns the
        :class:`..utils.governor.ChunkStatus` (also ``last_chunk_status``)
        with each member's chunk-max CFL (``cfl_members``) and ceiling trip
        (``pinned``); when any alive member pinned the ceiling the whole
        chunk rolls back (state, mask, counts, sums and time stay at its
        start) and :meth:`exit` latches until :meth:`clear_pre_divergence`."""
        if self._stability is not None:
            return self._update_n_sentinels(n)
        runner = self.chunk_runner(armed=False)
        nf = len(self.state)
        self._load(runner, self.mask, self.steps_done)
        tick = self._load_stats(runner)
        ok = runner.carry[nf]
        for bucket in scan_buckets(n):
            if not bool(ok.any()):
                break  # every member dead: the rest of the chunk changes nothing
            if runner.n_stats:
                tick = runner.run_sampled(bucket, tick, self.model.stats_engine.stride)
            else:
                runner.run(bucket)
        self.state = self._unload(runner)
        self.mask = ok.clone()
        self.steps_done = runner.carry[nf + 1].clone()
        self._unload_stats(runner)
        self.time += n * self.dt
        self._obs_cache = None
        return None

    def _update_n_sentinels(self, n: int) -> ChunkStatus:
        self._pre_div_latch = False
        runner = self.chunk_runner(armed=True)
        nf = len(self.state)
        before = self.steps_done
        self._load(runner, self.mask, True, self.steps_done)
        tick = self._load_stats(runner)
        fin, cok = runner.carry[nf], runner.carry[nf + 1]
        for bucket in scan_buckets(n):
            if not bool((fin & cok).any()):
                break  # no member finite and under the ceiling
            if runner.n_stats:
                tick = runner.run_sampled(bucket, tick, self.model.stats_engine.stride)
            else:
                runner.run(bucket)
        rows = [t.to(torch.float64) for t in runner.carry[nf:nf + 7]] + [before.to(torch.float64)]
        host = torch.stack(rows).cpu().numpy()
        if self.sentinel_reduce is not None:
            host = self.sentinel_reduce(host)
        fin_h, cok_h, dn_h, cflm_h, gm_h, dvm_h, kep_h, before_h = host
        fin_h, cok_h = fin_h.astype(bool), cok_h.astype(bool)
        pinned = fin_h & ~cok_h
        pre_div = bool(pinned.any())
        if pre_div:
            self._pre_div_latch = True
        else:
            self.state = self._unload(runner)
            self.mask = fin.clone()
            self.steps_done = runner.carry[nf + 2].clone()
            self._unload_stats(runner)
            self.time += n * self.dt
            self._obs_cache = None
        delta = dn_h - before_h
        status = ChunkStatus(
            requested=int(n), steps_done=int(delta.max(initial=0)), finite=bool(fin_h.any()),
            cfl_ok=not pre_div, pre_divergence=pre_div, cfl_max=float(cflm_h.max(initial=0.0)),
            ke=float(kep_h.max(initial=0.0)), ke_growth_max=float(gm_h.max(initial=0.0)),
            div_max=float(dvm_h.max(initial=0.0)), dt=self.dt,
            cfl_members=tuple(float(c) for c in cflm_h), pinned=tuple(bool(p) for p in pinned))
        self.last_chunk_status = status
        return status

    # -- the statistics ------------------------------------------------------------

    def set_stats(self, cfg) -> None:
        """Arm (a :class:`..config.StatsConfig`) or disarm (None) the
        template model's statistics engine for the ensemble's chunks: the
        members' running sums (leading K dim) and the shared tick start at
        zero, and the captured statistics chunks are dropped."""
        self.model.set_stats(cfg)
        self._drop_stats_runners()
        self.reset_stats()

    @property
    def _stats_engine(self):
        """The template model's engine."""
        return self.model.stats_engine

    def _stats_members(self) -> int:
        return self.k

    # -- the dt rung cache -------------------------------------------------------------

    def set_dt(self, dt: float) -> None:
        """Change the members' step size through the template model
        (:meth:`..models.navier.Navier2D.set_dt`, which rebuilds or restores
        its dt-baked operators), with the ensemble's own runners cached per
        rung as the model's are (:meth:`.campaign.StatsAndRungs.set_dt`).
        Member states, time and sums are untouched.  The per-member factors
        of a geometry sweep are kept: the sweep builds them at the default
        ``eta = dt / 10``, whose factor ``1 / (1 + (dt / eta) mask)`` does not
        depend on dt (a JAX ``geometry_sweep`` after ``set_dt`` builds the
        same ones)."""
        self.model.set_dt(dt)
        super().set_dt(self.model.dt)

    # -- recovery --------------------------------------------------------------

    def respawn_dead(self, amp: float = 1e-3, seed=None) -> int:
        """Re-seed every dead member from a healthy donor (round robin over
        the alive members) with a small multiplicative spectral
        perturbation, ``coeff * (1 + amp * noise)``, the noise drawn with
        numpy's ``default_rng(seed)`` field by field (``seed`` an int or a
        sequence of ints), or from the persistent ``respawn_seed`` stream
        when no seed is given and one is set, as the JAX package draws it.
        Returns the number of members respawned (0 when all are alive or
        none is)."""
        alive = self.alive()
        if alive.all() or not alive.any():
            return 0
        if seed is None and self.respawn_seed is not None:
            if self._respawn_rng is None:
                self._respawn_rng = np.random.default_rng(self.respawn_seed)
            rng = self._respawn_rng
        else:
            rng = np.random.default_rng(seed)
        donors = np.flatnonzero(alive)
        respawned = 0
        spaces = dict(self.model._state_fields())
        for i in np.flatnonzero(~alive):
            donor = self.member_state(int(donors[respawned % len(donors)]))
            leaves = []
            for name, x in zip(donor._fields, donor):
                space = spaces.get(name)
                if space is None:
                    # a leaf of no space (the adjoint finder's residual
                    # norms) restarts by the model's rule; its noise is
                    # drawn all the same, as the JAX package draws one for
                    # every leaf
                    rng.standard_normal(tuple(x.shape))
                    leaves.append(self.model.restart_fill(name, x))
                    continue
                real = x.real.dtype if x.is_complex() else x.dtype
                noise = space.place_spectral(rng.standard_normal(space.shape_spectral),
                                             dtype=real)
                leaves.append(x * (1.0 + amp * noise))
            self.set_member(int(i), type(donor)(*leaves))
            respawned += 1
        return respawned

    # -- observables -----------------------------------------------------------

    def get_observables(self) -> tuple:
        """The model's observables (``observable_names``), each a float
        ndarray of shape (K,), fetched in one transfer and cached per state.
        A member that diverged is frozen at its last finite state, so its
        entries are finite but stale: liveness is :meth:`alive`."""
        return self.get_observables_async().result()

    def _observables_tensor(self):
        return self.model._observables(self.state)

    @staticmethod
    def _convert_observables(host) -> tuple:
        return tuple(np.asarray(v, dtype=np.float64) for v in host)

    def _exit_of(self):
        """Every member dead, read from the device mask as a future."""
        from ..utils.io_pipeline import ObservableFuture

        return ObservableFuture(self.mask, convert=lambda m: not bool(np.any(m)))

    # -- integrity -------------------------------------------------------------

    def set_integrity(self, cfg) -> None:
        """Arm or disarm the integrity layer on the template model, as the
        JAX package's ensemble does; the members' digests are per member."""
        self.model.set_integrity(cfg)

    @property
    def integrity_config(self):
        return self.model.integrity_config

    @property
    def integrity_armed(self) -> bool:
        return self.model.integrity_armed

    def _digest_fields(self, state):
        """Each field, one digest per member: on a mesh every member's
        pencil is gathered to its global array, so member i digests as a
        solo model holding its state does."""
        model = self.model
        if model.mesh is None:
            return tuple(state), 1
        out = []
        for name, field in zip(state._fields, state):
            space = getattr(model, f"{name}_space", None)
            out.append(field if space is None else
                       torch.stack([space.gather_spectral(f) for f in field]))
        return tuple(out), 1

    def _shadow_state(self, snap: dict, n: int):
        """The members ``n`` plain steps after ``snap``, its alive mask and
        step counts threaded through, as the live chunk would."""
        runner = self.chunk_runner(armed=False, stats=False)
        self._load(runner, snap["mask"], snap["steps_done"], state=snap["state"])
        ok = runner.carry[len(self.state)]
        for bucket in scan_buckets(n):
            if not bool(ok.any()):
                break
            runner.run(bucket)
        return self._unload(runner)

    def integrity_snapshot(self) -> dict:
        """A device copy of what an in-memory rollback restores: the member
        states, alive mask, step counts, time and armed statistics."""
        snap = super().integrity_snapshot()
        snap["mask"] = self.mask.clone()
        snap["steps_done"] = self.steps_done.clone()
        return snap

    def integrity_restore(self, snap: dict) -> None:
        super().integrity_restore(snap)
        self.mask = snap["mask"].clone()
        self.steps_done = snap["steps_done"].clone()

    def eval_nu(self) -> np.ndarray:
        return self.get_observables()[0]

    def eval_nuvol(self) -> np.ndarray:
        return self.get_observables()[1]

    def eval_re(self) -> np.ndarray:
        return self.get_observables()[2]

    def div_norm(self) -> np.ndarray:
        return self.get_observables()[3]

    # -- snapshots -------------------------------------------------------------

    _layout_lead = 1

    def _layout_model(self):
        return self.model

    @property
    def mesh(self):
        """The template model's mesh (None: one rank)."""
        return self.model.mesh

    def _root_extra_items(self) -> list:
        """The ensemble's bookkeeping in the manifest: member count, alive
        mask, per-member step counts."""
        return [("members", np.asarray(int(self.k), dtype=np.int64), "raw"),
                ("alive", self.mask.detach().cpu().numpy().astype(np.int8), "raw"),
                ("steps_done", self.steps_done.detach().cpu().numpy().astype(np.int64), "raw")]

    def _apply_restored_extra(self, root: dict) -> None:
        dev = self.state.temp.device
        self.mask = torch.as_tensor(np.asarray(root["alive"], dtype=bool), device=dev)
        self.steps_done = torch.as_tensor(np.asarray(root["steps_done"]).astype(np.int32),
                                          device=dev)

    def write(self, filename: str) -> None:
        """Write a K-member snapshot (per-member groups, needs ``h5py``;
        :mod:`..utils.checkpoint`)."""
        checkpoint.write_ensemble_snapshot(self, filename)

    def read(self, filename: str) -> None:
        """Restore the members, alive mask, step counts and time from an
        ensemble snapshot, at the file's member count."""
        checkpoint.read_ensemble_snapshot(self, filename)

    def callback(self) -> None:
        """Save-boundary hook of :func:`..utils.integrate.integrate`
        (:func:`..utils.navier_io.ensemble_callback`): append every
        member's observables and alive flag to ``diagnostics``, print one
        aggregate line, and write ``data/ensemble{t:08.2f}.h5`` when
        ``write_intervall`` lets it."""
        navier_io.ensemble_callback(self)
