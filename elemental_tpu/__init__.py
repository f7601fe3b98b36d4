"""elemental_tpu: a distributed dense+sparse linear-algebra and
conic-optimization framework with the capabilities of Elemental/Hydrogen
(reference surveyed in SURVEY.md), built from scratch on JAX/XLA.

Layering (mirrors the reference's strict include order, ``include/El.hpp:14-22``):
    core → ops (blas_like) → lapack (lapack_like) → control → matrices → io
with sparse / sparse_direct / optimization tiers alongside.
"""

__version__ = "0.1.0"

from . import core
from .core import (CIRC, MC, MD, MR, STAR, VC, VR, Dist, DistMatrix, Grid,
                   distribute, initialize, finalize)
from . import ops
from . import lapack
from . import sparse
from . import matrices
from . import sparse_direct
from . import optimization
from . import control
from . import io
from . import extended
from .extended import DD
