"""The sentinel summary of one chunk (counterpart of ``ChunkStatus`` in the
JAX package's ``utils/governor.py``; its ``StabilityGovernor`` and dt
ladder are not ported yet)."""

from __future__ import annotations

from typing import NamedTuple


class ChunkStatus(NamedTuple):
    """What the stability sentinels saw in one ``update_n`` chunk.

    ``cfl_max``/``ke``/``ke_growth_max``/``div_max`` are chunk reductions
    of the per-step sentinels.  ``pre_divergence`` means the hard CFL
    ceiling tripped while the state was still finite: the chunk was rolled
    back (state and time untouched) and the model's ``exit()`` latches True
    until ``clear_pre_divergence()``."""

    requested: int  # steps asked of update_n
    steps_done: int  # steps executed before the chunk froze
    finite: bool  # state finite at chunk end
    cfl_ok: bool  # no CFL-ceiling trip
    pre_divergence: bool  # ceiling tripped while finite -> chunk rolled back
    cfl_max: float  # max per-step CFL seen this chunk
    ke: float  # volume-averaged kinetic energy of the last stepped state
    ke_growth_max: float  # max per-step KE growth factor
    div_max: float  # max pre-projection |div| residual seen this chunk
    dt: float  # the dt the chunk ran at
    cfl_members: tuple | None = None  # per-member chunk-max CFL (ensembles)
    pinned: tuple | None = None  # per-member ceiling-trip mask (ensembles)
