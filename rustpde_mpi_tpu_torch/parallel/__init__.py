"""The pencil-decomposed layer of the port (counterpart of the JAX
package's ``parallel/``): a mesh of ranks on one device, rank-stacked
pencils, their flips through the pencil-transpose kernel, the collectives,
and the spectral transforms on pencils; the multi-process controllers
(:mod:`.multihost`), the collective-sequence sanitizer (:mod:`.sanitizer`)
and the sub-mesh planner (:mod:`.submesh`)."""

from .decomp import (Decomp2d, Pencil, all_gather_sum, broadcast_scalar,  # noqa: F401
                     gather_root, scatter_root)
from .mesh import AXIS, PHYS, SPEC, Mesh, make_mesh  # noqa: F401
from .spaces import PencilSpace2  # noqa: F401
from . import multihost, sanitizer, submesh  # noqa: F401
