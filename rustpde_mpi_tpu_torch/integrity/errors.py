"""Typed integrity failures (a copy of the JAX package's
``integrity/errors.py``)."""

from __future__ import annotations


class IntegrityError(RuntimeError):
    """A digest audit found corrupted state (or a verified checkpoint
    failed its restore recomputation) and in-memory containment was not
    possible.  Carries everything the containment layers key on: the
    audit check that tripped (``chain`` — the chunk-start digest does not
    match the previous boundary's streamed digest, i.e. the state was
    corrupted *at rest* between chunks; ``shadow`` — re-executing the
    chunk from its retained start copy yields a different digest, i.e.
    the corruption happened *inside* the chunk; ``checkpoint`` — a
    restored snapshot's recomputed digest does not match the manifest),
    the global step and chunk size, the localized ensemble member, and
    the device the serve scheduler should charge the strike to."""

    def __init__(self, message: str, *, check: str = "shadow",
                 step: int | None = None, chunk_steps: int | None = None,
                 member: int | None = None, device: str | None = None):
        super().__init__(message)
        self.check = check
        self.step = step
        self.chunk_steps = chunk_steps
        self.member = member
        self.device = device
