"""Process grid → device mesh.

The reference's ``Grid`` (``include/El/core/Grid.hpp:15-146``) owns a 2D process
grid plus a family of derived communicators (mcComm, mrComm, vcComm, vrComm,
mdComm, ...) created via eight MPI splits in ``Grid::SetUpGrid``
(``src/core/Grid.cpp:95``).  Equivalent here: a ``jax.sharding.Mesh`` with
axes ``('mc', 'mr')``.  The communicator family becomes mesh-axis subsets used as
axis names inside ``shard_map`` — no explicit communicator objects are needed
because XLA collectives are addressed by axis name:

  =============  =============================================
  reference      here
  =============  =============================================
  mcComm         axis ``'mc'`` (collectives within a mesh col)
  mrComm         axis ``'mr'``
  vcComm         flattened axes ``('mc','mr')``
  vrComm         flattened axes ``('mr','mc')``
  viewing comm   a second Grid over a device subset
  =============  =============================================
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .dist import Dist, partition_spec, vector_spec


def _grid_height(size: int) -> int:
    """Near-square factorization, mirroring the reference's default
    (``Grid::Grid`` picks the largest factor ≤ √p)."""
    h = int(math.isqrt(size))
    while size % h != 0:
        h -= 1
    return h


class Grid:
    """A 2D device grid backed by a ``jax.sharding.Mesh``.

    Parameters
    ----------
    devices:
        Flat sequence of JAX devices (defaults to ``jax.devices()``).
    height:
        Number of mesh rows (``MC`` extent).  Defaults to the largest factor of
        ``len(devices)`` that is ≤ its square root, like the reference.
    """

    _default: Optional["Grid"] = None

    def __init__(self, devices: Optional[Sequence] = None,
                 height: Optional[int] = None,
                 viewers: Optional[Sequence] = None):
        # viewers/owners construction (reference ``Grid(viewers, owners,
        # height)``, ``include/El/core/Grid.hpp:59``): ``devices`` are the
        # OWNERS — the mesh spans only them; ``viewers`` are devices that
        # participate in the program but hold no shard of this grid's
        # data.  In JAX's single-controller model every process sees all
        # devices, so a viewing rank is simply a device outside the mesh:
        # data movement in/out of the sub-grid goes through
        # ``translate_between_grids``/``device_put``, the analog of the
        # reference's viewing-comm Translate.
        if devices is None:
            devices = jax.devices()
        devices = list(devices)
        self._viewers = tuple(viewers) if viewers is not None else ()
        size = len(devices)
        if height is None:
            height = _grid_height(size)
        if size % height != 0:
            raise ValueError(f"grid height {height} does not divide {size}")
        width = size // height
        self._height = height
        self._width = width
        self.mesh = Mesh(np.asarray(devices).reshape(height, width),
                         ("mc", "mr"))

    # -- shape ------------------------------------------------------------
    @property
    def height(self) -> int:
        return self._height

    @property
    def width(self) -> int:
        return self._width

    @property
    def size(self) -> int:
        return self._height * self._width

    @property
    def devices(self):
        return self.mesh.devices

    @property
    def viewers(self):
        """Devices viewing (not owning) this grid (reference
        ``Grid::InGrid``'s false case / viewing comm members)."""
        return self._viewers

    def in_grid(self, device) -> bool:
        """Reference ``Grid::InGrid``: does ``device`` own a shard?"""
        return any(d == device for d in self.mesh.devices.ravel())

    def subgrid(self, n: int, height: Optional[int] = None) -> "Grid":
        """Owner sub-grid over the first n devices; the rest become
        viewers (reference multi-grid ensembles,
        ``tests/core/DifferentGrids.cpp:36-74``)."""
        devs = list(self.mesh.devices.ravel())
        return Grid(devices=devs[:n], height=height, viewers=devs[n:])

    # -- shardings --------------------------------------------------------
    def sharding(self, coldist: Dist, rowdist: Dist) -> NamedSharding:
        """NamedSharding for a 2D array distributed [coldist, rowdist]."""
        return NamedSharding(self.mesh, partition_spec(coldist, rowdist))

    def vector_sharding(self, dist: Dist) -> NamedSharding:
        return NamedSharding(self.mesh, vector_spec(dist))

    def replicated(self) -> NamedSharding:
        return NamedSharding(self.mesh, P(None, None))

    # -- singletons -------------------------------------------------------
    @classmethod
    def default(cls) -> "Grid":
        if cls._default is None:
            cls._default = cls()
        return cls._default

    @classmethod
    def set_default(cls, grid: Optional["Grid"]) -> None:
        cls._default = grid

    @classmethod
    def trivial(cls) -> "Grid":
        """Single-device grid (reference ``Grid::Trivial``)."""
        return cls(devices=[jax.devices()[0]])

    def __repr__(self) -> str:
        return f"Grid({self._height}x{self._width}, mesh={self.mesh})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Grid) and self.mesh == other.mesh

    def __hash__(self) -> int:
        return hash(self.mesh)
