"""End-to-end integrity: the silent-data-corruption check (counterpart of
the JAX package's ``integrity/``).

* :func:`digest_tree`: a deterministic fold over the bit patterns of every
  state leaf, computed on the device and equal, bit for bit, to the JAX
  package's for the same arrays; it reads the state and never feeds back;
* shadow audits (the models' ``shadow_digest_async``): a chunk replayed
  from its retained start through the plain chunk, whose digest must equal
  the live chunk's;
* :class:`IntegrityError`, the typed failure;
* :class:`QuarantineLedger`, the durable per-device strike ledger;
* :func:`flip_one_bit` / :func:`flip_state_bit`: the one-bit fault that
  only the digest sees.
"""

from .digest import default_flip_bit, digest_tree, flip_one_bit, flip_state_bit
from .errors import IntegrityError
from .ledger import QuarantineLedger

__all__ = [
    "default_flip_bit",
    "digest_tree",
    "flip_one_bit",
    "flip_state_bit",
    "IntegrityError",
    "QuarantineLedger",
]
