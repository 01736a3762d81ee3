"""Deterministic fault-injection specs, parsed strictly (a copy of the JAX
package's ``utils/faults.py``; the port imports nothing of that package).

A fault spec drives a chaos run of the resilient runner
(:class:`..utils.resilience.ResilientRunner`, its ``fault=`` argument).  A
malformed spec that silently injects nothing is worse than no spec, since
the run then tests the happy path and reports green, so every parse error
raises a typed :class:`FaultSpecError` naming the spec and the grammar.
The runner parses its argument when it is built, before any step.

The port reads no environment: where the JAX package validates its
environment variables at start-up, the runner parses the ``fault=`` and
``shard_crash=`` arguments it was given.  A ``host<p>`` scope acts on
process ``p`` of a multi-process run (:mod:`..parallel.multihost`; one
process is process 0).  A ``gang<g>[member<m>]`` scope parses and acts
only inside a bound gang campaign, which the serving scheduler binds.
"""

from __future__ import annotations

import dataclasses

FAULT_KINDS = ("nan", "spike", "kill", "slow", "bitflip")
SHARD_CRASH_POINTS = ("after_shard", "before_manifest")


class FaultSpecError(ValueError):
    """A fault-injection spec failed to parse.  Subclasses ``ValueError``,
    as the JAX package's does."""

    def __init__(self, spec: str, expected: str, detail: str = ""):
        msg = f"bad fault spec {spec!r}: expected {expected}"
        if detail:
            msg += f" ({detail})"
        super().__init__(msg)
        self.spec = spec


def _parse_host_scope(token: str, spec: str, expected: str) -> int:
    if not token.startswith("host") or not token[4:].isdigit():
        raise FaultSpecError(spec, expected, f"bad host scope {token!r}, expected host<p>")
    return int(token[4:])


def _parse_gang_scope(token: str, spec: str, expected: str) -> tuple[int, int | None]:
    """``gang<g>`` or ``gang<g>member<m>`` -> ``(gang, member)``; anything
    else (missing indices, trailing text) raises."""
    body = token[len("gang"):]
    gang_digits, sep, member_part = body.partition("member")
    bad = FaultSpecError(spec, expected, f"bad gang scope {token!r}, expected gang<g>[member<m>]")
    if not gang_digits.isdigit():
        raise bad
    if not sep:
        if member_part:
            raise bad
        return int(gang_digits), None
    if not member_part.isdigit():
        raise bad
    return int(gang_digits), int(member_part)


@dataclasses.dataclass
class FaultPlan:
    """A parsed spec ``<kind>@<step>[:host<p>|:member<k>|:gang<g>[member<m>]]``:
    inject ``kind`` once, when the run's step counter reaches ``step``.

    * ``nan``: multiply the state by NaN (the divergence rollback path);
    * ``spike``: scale the velocities by the runner's ``spike_factor`` (a
      finite state far past the CFL ceiling: the governor's pre-divergence
      catch, or, ungoverned, a blow-up to NaN);
    * ``kill``: SIGTERM this process (the preemption path; a scoped kill
      is a SIGKILL);
    * ``slow``: stall the next dispatch past the watchdog deadline (the
      ``DispatchHang`` path);
    * ``bitflip``: flip one high mantissa bit of one spectral coefficient
      (finite and CFL-sane: only the integrity audits see it);
      ``:member<k>`` flips it in ensemble member k only."""

    kind: str
    step: int
    host: int | None = None
    gang: int | None = None
    member: int | None = None
    #: bare ensemble-member scope (``:member<k>``, no gang)
    only_member: int | None = None
    fired: bool = False
    #: the gang campaign bound at run time (not part of the spec)
    bound_gang: int | None = None
    bound_member: int | None = None

    KINDS = FAULT_KINDS
    EXPECTED = "<nan|spike|kill|slow|bitflip>@<step>[:host<p>|:member<k>|:gang<g>[member<m>]]"

    @classmethod
    def from_spec(cls, spec: str | None) -> "FaultPlan | None":
        """The plan of ``spec``; None for None or an empty spec."""
        if not spec:
            return None
        kind, sep, rest = spec.partition("@")
        at, hsep, scope = rest.partition(":")
        if kind not in cls.KINDS or not sep:
            raise FaultSpecError(spec, cls.EXPECTED, f"unknown kind {kind!r}")
        try:
            step = int(at)
        except ValueError:
            raise FaultSpecError(spec, cls.EXPECTED,
                                 f"bad step {at!r}, expected an integer") from None
        host = gang = member = only_member = None
        if hsep:
            if scope.startswith("gang"):
                gang, member = _parse_gang_scope(scope, spec, cls.EXPECTED)
            elif scope.startswith("member"):
                digits = scope[len("member"):]
                if not digits.isdigit():
                    raise FaultSpecError(spec, cls.EXPECTED,
                                         f"bad member scope {scope!r}, expected member<k>")
                only_member = int(digits)
            else:
                host = _parse_host_scope(scope, spec, cls.EXPECTED)
        return cls(kind=kind, step=step, host=host, gang=gang, member=member,
                   only_member=only_member)

    def bind_gang(self, gang: int | None, member: int | None) -> None:
        """Bind (or, with Nones, unbind) the running gang campaign."""
        self.bound_gang = gang
        self.bound_member = member

    def scoped_here(self) -> bool:
        """Whether this process acts on the fault: unscoped, the process the
        host scope names, or the bound gang (member) the scope names."""
        if self.gang is not None:
            if self.bound_gang != self.gang:
                return False
            return self.member is None or self.bound_member == self.member
        if self.host is None:
            return True
        from ..parallel.multihost import process_index

        return self.host == process_index()


_SHARD_CRASH_EXPECTED = "<after_shard|before_manifest>@<step>[:host<p>]"


def parse_shard_crash_spec(spec: str | None) -> tuple[str, int, int | None] | None:
    """Strict parse of a two-phase-commit crash spec into ``(point, step,
    host)`` (:func:`..utils.checkpoint._shard_crash_hook` acts on it)."""
    if not spec:
        return None
    point, sep, rest = spec.partition("@")
    if not sep or point not in SHARD_CRASH_POINTS:
        raise FaultSpecError(spec, _SHARD_CRASH_EXPECTED, f"unknown crash point {point!r}")
    at, hsep, host = rest.partition(":")
    try:
        step = int(at)
    except ValueError:
        raise FaultSpecError(spec, _SHARD_CRASH_EXPECTED,
                             f"bad step {at!r}, expected an integer") from None
    return point, step, (_parse_host_scope(host, spec, _SHARD_CRASH_EXPECTED) if hsep else None)
