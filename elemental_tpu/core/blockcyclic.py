"""Block-cyclic (BLOCK wrap) distributed matrices.

Reference parity: the ``DistWrap BLOCK`` tier (``include/El/core/types.hpp
:228``, ``src/core/DistMatrix/Block/*``) — ScaLAPACK-compatible block-cyclic
layouts alongside the element-cyclic default.

Design (SURVEY §7 design table): BLOCK wrap is an INDEX MAP
layered on the same mesh shardings, not a second container hierarchy.  A
:class:`BlockCyclicMatrix` stores the matrix with its rows/columns
permuted into owner-major block order, so a plain [MC,MR] sharding of the
permuted array realises exactly the ScaLAPACK ``(mb, nb)`` block-cyclic
ownership; ``to_element``/``from_element`` convert to the element-cyclic
:class:`~elemental_tpu.core.distmatrix.DistMatrix` world (one device-side
permutation), where the whole BLAS/LAPACK stack applies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .grid import Grid
from .distmatrix import DistMatrix, distribute
from .dist import MC, MR


def block_cyclic_perm(n: int, nb: int, p: int) -> np.ndarray:
    """Permutation putting indices into owner-major block-cyclic order:
    position k of the permuted axis holds global index ``perm[k]``; owner
    of global index i is ``(i // nb) % p`` (the ScaLAPACK formula)."""
    idx = np.arange(n)
    blocks = idx // nb
    owner = blocks % p
    # sort by (owner, block, offset) — stable keeps in-block order
    order = np.lexsort((idx, blocks, owner))
    return order


@dataclasses.dataclass
class BlockCyclicMatrix:
    """A matrix in (mb, nb) block-cyclic layout over the grid: rows cycle
    over the 'mc' axis in mb-blocks, columns over 'mr' in nb-blocks."""

    data: jnp.ndarray          # permuted (owner-major) storage, [MC,MR]
    grid: Grid
    height: int
    width: int
    mb: int
    nb: int
    rperm: np.ndarray          # storage position -> global row
    cperm: np.ndarray          # storage position -> global col

    @classmethod
    def from_array(cls, a, grid: Optional[Grid] = None, mb: int = 32,
                   nb: int = 32) -> "BlockCyclicMatrix":
        if grid is None:
            grid = Grid.default()
        a = np.asarray(a)
        m, n = a.shape
        h, w = grid.height, grid.width
        # pad so every owner gets the same number of full blocks
        mp = -(-m // (mb * h)) * (mb * h)
        npad = -(-n // (nb * w)) * (nb * w)
        ap = np.zeros((mp, npad), a.dtype)
        ap[:m, :n] = a
        rperm = block_cyclic_perm(mp, mb, h)
        cperm = block_cyclic_perm(npad, nb, w)
        stored = ap[np.ix_(rperm, cperm)]
        sh = NamedSharding(grid.mesh, P("mc", "mr"))
        return cls(jax.device_put(stored, sh), grid, m, n, mb, nb,
                   rperm, cperm)

    # -- ownership (ScaLAPACK semantics) ---------------------------------
    def owner(self, i: int, j: int) -> Tuple[int, int]:
        """(grid row, grid col) owning global entry (i, j)."""
        return ((i // self.mb) % self.grid.height,
                (j // self.nb) % self.grid.width)

    def local_shape(self) -> Tuple[int, int]:
        return (self.data.shape[0] // self.grid.height,
                self.data.shape[1] // self.grid.width)

    # -- conversions ------------------------------------------------------
    def to_array(self) -> np.ndarray:
        inv_r = np.argsort(self.rperm)
        inv_c = np.argsort(self.cperm)
        full = np.asarray(self.data)[np.ix_(inv_r, inv_c)]
        return full[:self.height, :self.width]

    def to_element(self) -> DistMatrix:
        """Convert to the element-cyclic [MC,MR] DistMatrix (reference
        BLOCK→ELEMENT redistribution) — one device-side permutation."""
        inv_r = jnp.asarray(np.argsort(self.rperm))
        inv_c = jnp.asarray(np.argsort(self.cperm))
        full = self.data[inv_r][:, inv_c][:self.height, :self.width]
        return distribute(full, MC, MR, self.grid)

    @classmethod
    def from_element(cls, A: DistMatrix, mb: int = 32, nb: int = 32
                     ) -> "BlockCyclicMatrix":
        """ELEMENT→BLOCK redistribution as the device-side permutation
        inverse to :meth:`to_element` (no host round-trip)."""
        from .distmatrix import as_array
        grid = A.grid
        a = as_array(A)
        m, n = a.shape
        h, w = grid.height, grid.width
        mp = -(-m // (mb * h)) * (mb * h)
        npad = -(-n // (nb * w)) * (nb * w)
        ap = jnp.pad(a, ((0, mp - m), (0, npad - n)))
        rperm = block_cyclic_perm(mp, mb, h)
        cperm = block_cyclic_perm(npad, nb, w)
        stored = ap[jnp.asarray(rperm)][:, jnp.asarray(cperm)]
        sh = NamedSharding(grid.mesh, P("mc", "mr"))
        return cls(jax.device_put(stored, sh), grid, m, n, mb, nb,
                   rperm, cperm)
