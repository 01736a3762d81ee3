"""The stepping contract Navier2D exposes (counterpart of the part of the
JAX package's ``models/campaign.py`` that the single-device DNS uses):
``time``, ``update``, ``update_n``, ``step_n``, ``get_observables``,
``exit``, and the stability sentinels (``set_stability``,
``clear_pre_divergence``, ``last_chunk_status``).

A chunk of steps advances a *carry*, the state and a few 0-d device
tensors, one step at a time in place (:class:`ChunkRunner`).  Each step
keeps the reference's divergence freeze: the stepped state is committed
only while the continue flag is up, and the flag drops at the first step
whose ``sum(temp)`` is not finite.  Flags and counters stay on the device,
so a chunk has no host sync.  On a CUDA device the step, the freeze and
(when armed) the sentinel reductions are captured once as a CUDA graph and
each step of a chunk replays it; on the CPU the same arithmetic runs
eagerly.  There is no eager fallback on the card: a capture or a replay
that fails raises.

The ensemble's chunks (:class:`.ensemble.NavierEnsemble`, the JAX
package's ``models/ensemble.py``) run on the same runner with a carry of
member-stacked fields and ``(K,)`` flags: ``_advance_members`` and
``_advance_members_sentinels`` keep a per-member mask (a member whose
stepped state is not finite freezes at its last finite state and stops
counting; with sentinels armed, a member over the CFL ceiling freezes too)
and every kernel launch of a step serves all members.
"""

from __future__ import annotations

import gc
import math

import torch

from ..utils.governor import ChunkStatus
from ..utils.jit import scan_buckets


class ChunkRunner:
    """The carry of a chunk (``carry``: the state's fields, then the
    scalars ``advance`` reads) and ``advance(carry)``, which steps it once
    in place.

    On the CPU :meth:`run` calls ``advance`` eagerly.  On a CUDA device
    the constructor runs ``advance`` once on a scratch copy of the carry on
    a side stream (each kernel wrapper then has its library loaded and its
    attributes set on the card), captures one call on ``carry`` as a CUDA
    graph, and :meth:`run` replays it.  The graph reads and writes the
    carry's own buffers, so consecutive replays are consecutive steps.

    ``kernels`` are the wrappers the step launches, each with a
    ``launches`` counter.  The capture launches nothing, so their counters
    are put back after it, and the launches one captured step made are
    added on every replay (``delta``)."""

    def __init__(self, advance, carry, kernels):
        self.carry = carry
        self.device = carry[0].device
        self._advance = advance
        self._kernels = list(kernels)
        self._graph = None
        #: kernel launches of one step, per wrapper of ``kernels``
        self.delta = [0] * len(self._kernels)
        #: bytes the capture added to the device's reserved memory (the
        #: graph's private pool); 0 on the CPU
        self.pool_bytes = 0
        if self.device.type == "cuda":
            self._capture()

    def _capture(self) -> None:
        dev = self.device
        with torch.cuda.device(dev):
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self._advance([t.clone() for t in self.carry])
            torch.cuda.current_stream(dev).wait_stream(side)
            torch.cuda.synchronize(dev)
            # a CUDA graph that dies while another is being captured (its
            # reset frees memory) invalidates that capture: collect any
            # unreachable one now
            gc.collect()
            torch.cuda.empty_cache()  # as the capture does: what it reserves is its pool
            before = [k.launches for k in self._kernels]
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            try:
                with torch.cuda.graph(graph):
                    self._advance(self.carry)
            except BaseException:
                # free the failed graph here, not whenever the traceback that
                # holds it is dropped (maybe inside a later capture)
                graph.reset()
                raise
            finally:
                after = [k.launches for k in self._kernels]
                for k, n in zip(self._kernels, before):
                    k.launches = n
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.delta = [a - b for a, b in zip(after, before)]
        self._graph = graph

    @property
    def captured(self) -> bool:
        """Whether :meth:`run` replays a CUDA graph."""
        return self._graph is not None

    def run(self, n: int) -> None:
        """Advance the carry ``n`` steps."""
        if self._graph is None:
            for _ in range(n):
                self._advance(self.carry)
            return
        with torch.cuda.device(self.device):
            for _ in range(n):
                self._graph.replay()
        for k, d in zip(self._kernels, self.delta):
            k.launches += d * n


class CampaignModelBase:
    """Subclasses supply ``dt``, ``dtype`` (the real working dtype; the
    state's fields may be complex), ``state`` (a NamedTuple of tensors),
    ``_step(state, with_sentinels=False)`` (with sentinels it returns
    ``(state, (cfl, ke, div_norm))``, 0-d tensors), ``_observables(state)``
    (a 1-D tensor whose index 3 is |div|) and ``kernels()``."""

    def _init_campaign(self) -> None:
        self.time = 0.0
        self._obs_cache = None  # (state, values) of the last read
        self._stability = None
        self._ceiling = None  # the CFL ceiling, a 0-d tensor the sentinel step reads
        self._runners: dict = {}  # armed (bool) -> ChunkRunner
        self.last_chunk_status = None
        self._pre_div_latch = False

    # -- one step, and the freeze ----------------------------------------------

    def update(self) -> None:
        """One step, eagerly (no freeze, no graph)."""
        self.state = self._step(self.state)
        self.time += self.dt

    def _scan_ok(self, state, lead: int = 0) -> torch.Tensor:
        """The continue criterion of a chunk, a 0-d bool tensor: the
        temperature's sum is finite (a NaN anywhere in the flow reaches
        temp within a step through buoyancy and convection; a complex sum
        is finite when both its parts are), and so is the passive scalar's,
        where the state has one (the flow never reads it, so a NaN in the
        scalar alone would not reach temp).  With ``lead`` member dims, one
        flag per member."""

        def total(x):
            return torch.sum(x) if not lead else x.reshape(*x.shape[:lead], -1).sum(dim=-1)

        probe = total(state.temp)
        if "scal" in state._fields:
            probe = probe + total(state.scal)
        return torch.isfinite(probe)

    @staticmethod
    def _commit(fields, stepped, keep) -> None:
        """The freeze: each field of the carry takes its stepped value
        where ``keep`` (a 0-d bool, or one per member) is set and keeps its
        own otherwise."""
        for f, f2 in zip(fields, stepped):
            torch.where(keep.reshape(keep.shape + (1,) * (f.ndim - keep.ndim)), f2, f, out=f)

    def _advance(self, carry) -> None:
        """One step of a plain chunk on ``carry = [*state, ok, done]``:
        while ``ok``, commit the stepped state and count the step; ``ok``
        drops after the first step whose state is not finite (that state
        is committed, as the reference's ``lax.cond`` commits it).  A
        frozen state is still stepped, and its result discarded: the
        reference skips the step there, but a graph has no branch, and
        the cost falls only after a divergence."""
        self._freeze(carry, self._step(type(self.state)(*carry[:-2])))

    def _freeze(self, carry, stepped) -> None:
        """The plain chunk's bookkeeping of one step: the finite check of
        ``stepped``, the count, the commit and the flag."""
        *fields, ok, done = carry
        ok2 = self._scan_ok(stepped)
        done.add_(ok)
        self._commit(fields, stepped, ok)
        ok.logical_and_(ok2)

    def _advance_sentinels(self, carry) -> None:
        """One step of a sentinel chunk on ``carry = [*state, finite,
        cfl_ok, done, cfl_max, ke_growth_max, div_max, ke]``, as the
        reference's ``step_n_sent``: while ``finite and cfl_ok``, commit
        the stepped state, its flags, the step and the running maxima.  A
        NaN CFL reads as the NaN path (``NaN > ceiling`` is False), not as a
        ceiling trip."""
        nf = len(self.state)
        fields = carry[:nf]
        fin, cok, done, cfl_max, growth_max, div_max, ke_prev = carry[nf:]
        go = fin & cok
        stepped, (cfl, ke, div) = self._step(type(self.state)(*fields), with_sentinels=True)
        torch.where(go, self._scan_ok(stepped), fin, out=fin)
        torch.where(go, torch.logical_not(cfl > self._ceiling), cok, out=cok)
        done.add_(go)
        growth = torch.where(ke_prev > 0.0, ke / ke_prev, torch.ones_like(ke))
        torch.where(go, torch.maximum(cfl_max, cfl), cfl_max, out=cfl_max)
        torch.where(go, torch.maximum(growth_max, growth), growth_max, out=growth_max)
        torch.where(go, torch.maximum(div_max, div), div_max, out=div_max)
        torch.where(go, ke, ke_prev, out=ke_prev)
        self._commit(fields, stepped, go)

    # -- the ensemble's chunks ---------------------------------------------------

    def _advance_members(self, carry, solid=None) -> None:
        """One step of an ensemble's plain chunk on ``carry = [*state, ok,
        done]`` (member-stacked fields, ``(K,)`` flags and counts), as the
        JAX package's ensemble chunk: a member commits its stepped state and
        counts the step while ``ok`` and the stepped state is finite; ``ok``
        drops at its first non-finite step, whose state is not committed (a
        frozen member keeps its last finite state).  Every member is
        stepped; a frozen member's result is discarded.  ``solid``: the
        members' penalization factors (:meth:`_step`)."""
        *fields, ok, done = carry
        stepped = self._step(type(self.state)(*fields), solid=solid)
        keep = ok & self._scan_ok(stepped, lead=1)
        done.add_(keep)
        self._commit(fields, stepped, keep)
        ok.copy_(keep)

    def _advance_members_sentinels(self, carry, solid=None) -> None:
        """One step of an ensemble's sentinel chunk on ``carry = [*state,
        finite, cfl_ok, done, cfl_max, ke_growth_max, div_max, ke]`` (each
        scalar ``(K,)``), as the JAX package's ensemble sentinel chunk: a
        member is active while finite and under the CFL ceiling; an active
        member's flags, running maxima and kinetic energy take the step's,
        and it commits the stepped state and counts the step when that is
        finite and under the ceiling (a member over the ceiling freezes at
        its last state under it, still finite)."""
        nf = len(self.state)
        fields = carry[:nf]
        fin, cok, done, cfl_max, growth_max, div_max, ke_prev = carry[nf:]
        active = fin & cok
        stepped, (cfl, ke, div) = self._step(type(self.state)(*fields), with_sentinels=True,
                                             solid=solid)
        finite = self._scan_ok(stepped, lead=1)
        torch.where(active, finite, fin, out=fin)
        torch.where(active, torch.logical_not(cfl > self._ceiling), cok, out=cok)
        keep = active & finite & cok
        done.add_(keep)
        growth = torch.where(ke_prev > 0.0, ke / ke_prev, torch.ones_like(ke))
        torch.where(active, torch.maximum(cfl_max, cfl), cfl_max, out=cfl_max)
        torch.where(active, torch.maximum(growth_max, growth), growth_max, out=growth_max)
        torch.where(active, torch.maximum(div_max, div), div_max, out=div_max)
        torch.where(active, ke, ke_prev, out=ke_prev)
        self._commit(fields, stepped, keep)

    # -- the chunk runner ------------------------------------------------------

    def _drop_chunks(self) -> None:
        """Forget the chunk runners and the observables cache: a change of
        the step's constants (an obstacle's factors, a scenario's stages or
        solvers) or of the state's fields leaves a captured step stale."""
        self._runners.clear()
        self._obs_cache = None

    def chunk_runner(self, armed: bool | None = None) -> ChunkRunner:
        """The chunk runner of the plain (``armed=False``) or the sentinel
        chunk (``True``; default: as :meth:`set_stability` left it), built
        at the first call: on a CUDA device that warms up every kernel
        wrapper and captures the step, so a caller who wants the capture
        out of a timed or counted run calls this first."""
        armed = self._stability is not None if armed is None else armed
        if armed and self._stability is None:
            raise RuntimeError("the sentinel chunk needs set_stability(cfg) first")
        runner = self._runners.get(armed)
        if runner is None:
            carry = [f.clone(memory_format=torch.contiguous_format) for f in self.state]
            dev, dtype = carry[0].device, self.dtype
            # the flags (ok; or finite and cfl_ok), the step counter and, when
            # armed, the running maxima and the last step's kinetic energy
            carry += [torch.ones((), dtype=torch.bool, device=dev) for _ in range(1 + armed)]
            carry.append(torch.zeros((), dtype=torch.int32, device=dev))
            carry += [torch.zeros((), dtype=dtype, device=dev) for _ in range(4 * armed)]
            kernels = [k for ks in self.kernels().values() for k in ks]
            advance = self._advance_sentinels if armed else self._advance
            runner = ChunkRunner(advance, carry, kernels)
            self._runners[armed] = runner
        return runner

    def _load(self, runner: ChunkRunner, state) -> None:
        """Copy ``state`` into the runner's carry and reset its scalars
        (flags up, counters and maxima zero), with no host sync."""
        nf = len(state)
        for buf, f in zip(runner.carry[:nf], state):
            buf.copy_(f)
        for t in runner.carry[nf:]:
            if t.dtype == torch.bool:
                t.fill_(True)
            else:
                t.zero_()

    def _unload(self, runner: ChunkRunner):
        """Fresh tensors of the carry's state (a caller's reference to an
        earlier state, and the observables cache keyed on it, stay
        valid)."""
        return type(self.state)(*(t.clone() for t in runner.carry[: len(self.state)]))

    def restart_fill(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The value a restart gives a state leaf that a gathered snapshot
        does not carry (``pseu``; a scenario leaf an older file lacks):
        zero."""
        del name
        return torch.zeros_like(like)

    # -- chunks -----------------------------------------------------------------

    def step_n(self, state, n: int):
        """One bucket of ``n`` plain steps from ``state`` (the reference's
        ``_step_n``): ``(state, steps_done)``, ``steps_done`` a 0-d int32
        device tensor, the steps executed before the freeze (the first
        non-finite step included)."""
        runner = self.chunk_runner(armed=False)
        self._load(runner, state)
        runner.run(n)
        return self._unload(runner), runner.carry[-1].clone()

    def update_n(self, n: int):
        """Advance ``n`` steps in the reference's bucket schedule
        (:func:`..utils.jit.scan_buckets`).  The freeze flag restarts at
        the start of every bucket, as the reference's does.  ``time``
        counts the scheduled steps, frozen or not.

        With sentinels armed (:meth:`set_stability`) the flags run through
        the whole chunk, and the chunk's scalars come to the host in one
        transfer at its end.  It returns the :class:`ChunkStatus` (also
        ``last_chunk_status``), else None.  When the CFL ceiling tripped
        while the state stayed finite (``pre_divergence``), ``state`` and
        ``time`` stay at the chunk start and :meth:`exit` latches True
        until :meth:`clear_pre_divergence`."""
        if self._stability is not None:
            return self._update_n_sentinels(n)
        runner = self.chunk_runner(armed=False)
        nf = len(self.state)
        self._load(runner, self.state)
        for bucket in scan_buckets(n):
            runner.carry[nf].fill_(True)
            runner.run(bucket)
        self.state = self._unload(runner)
        self.time += n * self.dt
        return None

    def _update_n_sentinels(self, n: int) -> ChunkStatus:
        self._pre_div_latch = False
        runner = self.chunk_runner(armed=True)
        nf = len(self.state)
        self._load(runner, self.state)
        # the sentinel carry is not reset between buckets, so the schedule
        # does not change what the chunk computes
        runner.run(n)
        fin, cok, done, cfl_max, growth_max, div_max, ke = torch.stack(
            [t.to(self.dtype) for t in runner.carry[nf:]]).tolist()
        fin, cok = bool(fin), bool(cok)
        pre_div = fin and not cok
        if pre_div:
            self._pre_div_latch = True
        else:
            self.state = self._unload(runner)
            self.time += n * self.dt
        status = ChunkStatus(requested=int(n), steps_done=int(done), finite=fin, cfl_ok=cok,
                             pre_divergence=pre_div, cfl_max=cfl_max, ke=ke,
                             ke_growth_max=growth_max, div_max=div_max, dt=self.dt)
        self.last_chunk_status = status
        return status

    def set_stability(self, cfg) -> None:
        """Arm (a :class:`..config.StabilityConfig`) or disarm (None) the
        stability sentinels of :meth:`update_n`.  The ceiling lives in a
        device tensor that the sentinel step reads, so a captured sentinel
        step stays valid across configs (and is kept while disarmed)."""
        if cfg is not None:
            if self._ceiling is None:
                self._ceiling = torch.full((), cfg.max_cfl, dtype=self.dtype,
                                           device=self.state[0].device)
            else:
                self._ceiling.fill_(cfg.max_cfl)
        self._stability = cfg
        self.last_chunk_status = None
        self._pre_div_latch = False

    def clear_pre_divergence(self) -> None:
        """Acknowledge a ``pre_divergence`` catch: unlatch :meth:`exit`."""
        self._pre_div_latch = False

    # -- observables -----------------------------------------------------------

    def get_time(self) -> float:
        return self.time

    def get_dt(self) -> float:
        return self.dt

    def get_observables(self) -> tuple:
        """The model's scalars (``observable_names``) of the current state,
        fetched to the host in one transfer and cached per state."""
        if self._obs_cache is None or self._obs_cache[0] is not self.state:
            vals = self._observables(self.state)
            self._obs_cache = (self.state, tuple(float(v) for v in vals.tolist()))
        return self._obs_cache[1]

    def div_norm(self) -> float:
        """The divergence norm, the observable that turns non-finite first."""
        return self.get_observables()[3]

    def exit(self) -> bool:
        """Break criterion, as the reference's: a latched pre-divergence
        catch, or a NaN |div| (an infinite one does not break)."""
        if self._pre_div_latch:
            return True
        return math.isnan(self.div_norm())

