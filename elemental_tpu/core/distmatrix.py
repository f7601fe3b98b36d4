"""DistMatrix: a distributed matrix as a sharded ``jax.Array``.

XLA re-expression of the reference's ``DistMatrix<T,U,V>`` hierarchy
(``include/El/core/DistMatrix/``, 13 distributions × {ELEMENT,BLOCK} wrap ×
devices, ~12.8k LoC of per-pair instantiations).  Here a single class suffices:
the *global* matrix is one ``jax.Array`` whose ``NamedSharding`` over the grid's
mesh encodes the distribution; the 13-pair algebra lives in
:mod:`elemental_tpu.core.dist`, and the per-pair ``operator=`` redistribution
dispatch (``src/core/DistMatrix/ElementMatrix/MC_MR.cpp:30-165``) collapses into
one :func:`redistribute` primitive (XLA emits the all-gather / all-to-all /
send-recv pattern each pair requires).

A *local* matrix (reference ``Matrix<T,D>``) is simply a ``jnp.ndarray``; every
operation in the library accepts either.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax import tree_util
from jax.sharding import NamedSharding, PartitionSpec as P

from .dist import (CIRC, MC, MR, STAR, VC, VR, Dist, is_replicated,
                   partition_spec, transpose_pair)
from .grid import Grid


def _constrain(x, sharding: NamedSharding):
    """Apply a sharding inside or outside jit.

    JAX requires every sharded dimension to divide evenly; dims that do not
    divide are degraded to replicated (hot paths pad to mesh-aligned shapes
    before sharding, so this only affects convenience paths)."""
    sharding = _feasible_sharding(x.shape, sharding)
    if isinstance(x, jax.core.Tracer):
        return jax.lax.with_sharding_constraint(x, sharding)
    return jax.device_put(x, sharding)


def _feasible_sharding(shape, sharding: NamedSharding) -> NamedSharding:
    mesh = sharding.mesh
    spec = list(sharding.spec) + [None] * (len(shape) - len(sharding.spec))
    changed = False
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes_t = (axes,) if isinstance(axes, str) else tuple(axes)
        n = 1
        for ax in axes_t:
            n *= mesh.shape[ax]
        if shape[dim] % n != 0:
            spec[dim] = None
            changed = True
    if not changed:
        return sharding
    import warnings
    warnings.warn(
        f"shape {tuple(shape)} is not divisible by the mesh along "
        f"{sharding.spec}; degrading those dimensions to REPLICATED. "
        "Pad to a mesh-aligned shape to keep the distribution.",
        RuntimeWarning, stacklevel=3)
    return NamedSharding(mesh, P(*spec))


@tree_util.register_pytree_node_class
@dataclasses.dataclass
class DistMatrix:
    """A matrix distributed over a :class:`Grid`.

    ``data`` is the full logical array; its sharding over the grid's mesh
    realises the ``[coldist, rowdist]`` distribution.  Row indices are sharded
    by ``coldist`` and column indices by ``rowdist`` (Elemental's convention).
    """

    data: jnp.ndarray
    coldist: Dist = MC
    rowdist: Dist = MR
    grid: Optional[Grid] = None
    root: int = 0  # only meaningful for CIRC

    def __post_init__(self):
        if self.grid is None:
            self.grid = Grid.default()

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.data,), (self.coldist, self.rowdist, self.grid, self.root)

    @classmethod
    def tree_unflatten(cls, aux, children):
        coldist, rowdist, grid, root = aux
        return cls(children[0], coldist, rowdist, grid, root)

    # -- basic queries -----------------------------------------------------
    @property
    def shape(self) -> Tuple[int, ...]:
        return self.data.shape

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1] if self.data.ndim > 1 else 1

    def dist(self) -> Tuple[Dist, Dist]:
        return (self.coldist, self.rowdist)

    # -- redistribution ----------------------------------------------------
    def redistribute(self, coldist: Dist, rowdist: Dist) -> "DistMatrix":
        """Equivalent of the reference's cross-distribution ``operator=``."""
        sh = NamedSharding(self.grid.mesh, partition_spec(coldist, rowdist))
        return DistMatrix(_constrain(self.data, sh), coldist, rowdist,
                          self.grid, self.root)

    def replicate(self) -> jnp.ndarray:
        """→ [STAR,STAR]: every device holds the whole matrix."""
        sh = NamedSharding(self.grid.mesh, P(None, None))
        return _constrain(self.data, sh)

    def constrain(self) -> "DistMatrix":
        """(Re)assert this DistMatrix's own sharding on its data; used inside
        jit to pin intermediate values to the declared distribution."""
        return self.redistribute(self.coldist, self.rowdist)

    def transpose(self) -> "DistMatrix":
        cd, rd = transpose_pair(self.coldist, self.rowdist)
        return DistMatrix(self.data.T, cd, rd, self.grid, self.root)

    @property
    def T(self) -> "DistMatrix":
        return self.transpose()

    def adjoint(self) -> "DistMatrix":
        cd, rd = transpose_pair(self.coldist, self.rowdist)
        return DistMatrix(jnp.conj(self.data.T), cd, rd, self.grid, self.root)

    @property
    def H(self) -> "DistMatrix":
        return self.adjoint()

    def astype(self, dtype) -> "DistMatrix":
        return DistMatrix(self.data.astype(dtype), self.coldist, self.rowdist,
                          self.grid, self.root)

    def like(self, data: jnp.ndarray) -> "DistMatrix":
        """New DistMatrix with the same distribution holding ``data``."""
        return DistMatrix(data, self.coldist, self.rowdist, self.grid,
                          self.root)

    # -- remote entrywise updates (reference AbstractDistMatrix
    #    QueueUpdate/ProcessQueues/QueuePull, AbstractDistMatrix.hpp:162-171)
    def queue_update(self, i: int, j: int, value) -> None:
        """Queue a remote entry update from any caller; applied (summed,
        COO semantics) by :meth:`process_queues`.  Here the
        queue lives on host and drains as ONE sharded scatter-add — the
        reference's rank-to-owner exchange is the compiler's to plan."""
        if not hasattr(self, "_queue"):
            object.__setattr__(self, "_queue", [])
        self._queue.append((int(i), int(j), value))

    def queue_pull(self, i: int, j: int) -> None:
        """Queue a remote entry READ (reference QueuePull); drained by
        :meth:`process_pull_queue`."""
        if not hasattr(self, "_pull_queue"):
            object.__setattr__(self, "_pull_queue", [])
        self._pull_queue.append((int(i), int(j)))

    def process_queues(self) -> "DistMatrix":
        """Drain queued updates into a NEW DistMatrix (arrays are
        immutable — the reference mutates in place; the drained matrix
        keeps grid/dist/sharding)."""
        q = getattr(self, "_queue", [])
        if not q:
            return self
        import numpy as _np
        ii = jnp.asarray(_np.asarray([e[0] for e in q]))
        jj = jnp.asarray(_np.asarray([e[1] for e in q]))
        vv = jnp.asarray(_np.asarray([e[2] for e in q]), self.data.dtype)
        new = self.data.at[ii, jj].add(vv)
        object.__setattr__(self, "_queue", [])
        return DistMatrix(new, self.coldist, self.rowdist, self.grid,
                          self.root)

    def process_pull_queue(self):
        """Drain queued reads; returns values in queue order (host)."""
        import numpy as _np
        q = getattr(self, "_pull_queue", [])
        if not q:
            return _np.empty((0,))
        ii = jnp.asarray(_np.asarray([e[0] for e in q]))
        jj = jnp.asarray(_np.asarray([e[1] for e in q]))
        out = _np.asarray(self.data[ii, jj])
        object.__setattr__(self, "_pull_queue", [])
        return out

    # -- numpy interop -----------------------------------------------------
    def to_numpy(self):
        import numpy as np
        return np.asarray(self.data)

    def __repr__(self) -> str:
        return (f"DistMatrix(shape={self.shape}, dtype={self.dtype}, "
                f"dist=[{self.coldist.value},{self.rowdist.value}], "
                f"grid={self.grid.height}x{self.grid.width})")


def distribute(array, coldist: Dist = MC, rowdist: Dist = MR,
               grid: Optional[Grid] = None, root: int = 0) -> DistMatrix:
    """Place an array onto a grid with the given distribution."""
    if grid is None:
        grid = Grid.default()
    # device_put host data straight onto the target mesh — never bounce
    # through the default device.
    ndim = getattr(array, "ndim", None)
    if ndim == 2:
        sh = _feasible_sharding(array.shape,
                                grid.sharding(coldist, rowdist))
    else:
        sh = NamedSharding(grid.mesh, P())
    arr = jax.device_put(array, sh)
    return DistMatrix(arr, coldist, rowdist, grid, root)


def as_array(A) -> jnp.ndarray:
    """Underlying array of a DistMatrix, or the array itself."""
    return A.data if isinstance(A, DistMatrix) else jnp.asarray(A)


def like(A, data) -> "DistMatrix | jnp.ndarray":
    """Wrap ``data`` with A's distribution if A is distributed."""
    if isinstance(A, DistMatrix):
        return A.like(data)
    return data


def grid_of(*mats) -> Optional[Grid]:
    for m in mats:
        if isinstance(m, DistMatrix):
            return m.grid
    return None
