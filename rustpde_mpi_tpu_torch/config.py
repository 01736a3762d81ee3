"""Device and dtype policy of the PyTorch port.

The JAX package reads its precision from the environment (``X64``); here the
dtype and the device are explicit constructor arguments instead.  The
defaults are float64 (the reference default) on the CUDA card.  A caller
who wants the CPU says so with ``device="cpu"``: an entry point never falls
back to the CPU on its own.

Importing this module turns TF32 off for matrix products and convolutions,
the counterpart of the reference pinning HIGHEST matmul precision.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the reference default precision
DEFAULT_DTYPE = torch.float64

#: dtypes the port (and its kernels) support
SUPPORTED_DTYPES = (torch.float64, torch.float32)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` unless the caller names
    another.  Raises when CUDA is asked for (explicitly or by default) and no
    card is visible.  A CUDA device without an index gets the current one,
    so it compares equal to the device of the tensors made on it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def to_device(mat, device, dtype) -> torch.Tensor:
    """A contiguous copy of the host array ``mat`` in ``dtype`` on ``device``
    (the form every operator constant of the port takes)."""
    return torch.as_tensor(np.ascontiguousarray(mat), dtype=dtype).to(device)


def check_dtype(dtype) -> torch.dtype:
    """Validate a real working dtype (float64 or float32)."""
    if dtype not in SUPPORTED_DTYPES:
        raise ValueError(f"unsupported dtype {dtype}; use torch.float64 or torch.float32")
    return dtype


@dataclass
class StabilityConfig:
    """Knobs of the on-device stability sentinels that a model's
    ``set_stability`` arms (the JAX package's ``StabilityConfig``, same
    fields and defaults).  The port's chunk reads ``max_cfl``, the hard
    ceiling: a chunk whose per-step CFL exceeds it freezes while the state
    is still finite, is rolled back, and reports ``pre_divergence``.  The
    other fields are the dt governor's, which is not ported yet:

    * ``target_cfl``: the Courant number the dt controller drives toward;
    * ``ladder_ratio``: geometric spacing of the dt ladder;
    * ``dt_min``/``dt_max``: ladder bounds (None: ``dt_max`` is the run's
      initial dt, ``dt_min`` ``dt_max * ladder_ratio**-10``);
    * ``grow_after``: healthy chunks at a rung before climbing back up;
    * ``shrink_cfl``: proactive shrink threshold (None: ``0.85 * max_cfl``);
    * ``member_pin_patience``: pre-divergence catches pinned on one
      ensemble member before it is declared dead."""

    target_cfl: float = 0.5
    max_cfl: float = 1.0
    ladder_ratio: float = 2.0
    dt_min: float | None = None
    dt_max: float | None = None
    grow_after: int = 4
    shrink_cfl: float | None = None
    member_pin_patience: int = 3
