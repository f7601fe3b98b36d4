"""Permutations (reference ``src/lapack_like/perm``: Permutation /
DistPermutation with comm metadata, pivot↔permutation conversions).

Design: a permutation is an index vector; applying it is a gather —
XLA turns gathers on sharded arrays into the same send/recv pattern the
reference's ``PermutationMeta`` plans explicitly."""

from __future__ import annotations

from typing import Union

import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like

Arr = Union[jnp.ndarray, DistMatrix]


class Permutation:
    """Composable permutation (reference ``Permutation``)."""

    def __init__(self, perm):
        self.perm = jnp.asarray(perm)

    @classmethod
    def identity(cls, n: int) -> "Permutation":
        return cls(jnp.arange(n))

    def inverse(self) -> "Permutation":
        return Permutation(jnp.argsort(self.perm))

    def compose(self, other: "Permutation") -> "Permutation":
        return Permutation(self.perm[other.perm])

    def permute_rows(self, A: Arr, inverse: bool = False) -> Arr:
        p = jnp.argsort(self.perm) if inverse else self.perm
        return like(A, as_array(A)[p])

    def permute_cols(self, A: Arr, inverse: bool = False) -> Arr:
        p = jnp.argsort(self.perm) if inverse else self.perm
        return like(A, as_array(A)[:, p])

    def permute_symmetric(self, A: Arr) -> Arr:
        return like(A, as_array(A)[self.perm][:, self.perm])

    def __len__(self) -> int:
        return int(self.perm.shape[0])


def pivots_to_permutation(pivots) -> Permutation:
    """LAPACK sequential pivot rows → explicit permutation vector (reference
    ``PivotsToPermutation``)."""
    import numpy as np
    piv = np.asarray(pivots)
    perm = np.arange(piv.shape[0] if piv.ndim else 0)
    n = piv.shape[0]
    perm = np.arange(max(n, int(piv.max()) + 1 if n else 0))
    for k in range(n):
        j = int(piv[k])
        perm[k], perm[j] = perm[j], perm[k]
    return Permutation(perm)


def permutation_to_pivots(perm: Permutation):
    """Inverse conversion (reference ``PermutationToPivots``)."""
    import numpy as np
    p = np.asarray(perm.perm).copy()
    n = p.shape[0]
    pos = np.argsort(p)
    piv = np.zeros(n, dtype=np.int64)
    work = np.arange(n)
    loc = np.argsort(work)
    for k in range(n):
        j = int(np.where(work == p[k])[0][0])
        piv[k] = j
        work[k], work[j] = work[j], work[k]
    return jnp.asarray(piv)
