"""rustpde_mpi_tpu_torch — the PyTorch/CUDA port of rustpde_mpi_tpu.

A second package beside the JAX one, held against it by the tests.  This
slice ports the confined Rayleigh-Benard DNS step of ``Navier2D`` on its
fused route: the convection chain and the implicit stages run as
hand-written CUDA kernels for Hopper (``csrc/``, built with ``nvcc`` at
first use), with plain PyTorch versions on the CPU.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``::

    from rustpde_mpi_tpu_torch import Navier2D, integrate

    model = Navier2D.new_confined(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc")
    integrate(model, 1.0, 0.1)
"""

from . import config  # noqa: F401  (import first: turns TF32 off)
from .bases import Base, BaseKind, Space2, cheb_dirichlet, cheb_neumann, chebyshev  # noqa: F401
from .convert import state_from_numpy, state_to_numpy  # noqa: F401
from .models.navier import Navier2D, NavierState  # noqa: F401
from .utils.integrate import integrate  # noqa: F401
