"""DIA (diagonal) sparse format — the layout for banded/stencil matrices
(PDE Laplacians/Helmholtz, banded SuiteSparse instances).

A DIA SpMV is Σ_d diag_d ∘ shift(x, off_d): contiguous streams and static
slices, which XLA fuses into one memory-bound loop with no index arrays at
all (a CSR SpMV streams 8 index bytes per nonzero on top of the values).
``best_device_format`` picks DIA when a small number of diagonals covers
the matrix, ELL otherwise.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .csr import SparseMatrix


@dataclasses.dataclass
class DIAMatrix:
    """diags[d, i] holds A[i, i + offsets[d]] (row-aligned storage)."""

    height: int
    width: int
    offsets: Tuple[int, ...]
    diags: np.ndarray           # (ndiag, height) — host or device array
    nnz: int

    def device(self, device=None, dtype=None) -> "DIAMatrix":
        d = np.asarray(self.diags)
        if dtype is not None:
            d = d.astype(dtype)
        return dataclasses.replace(self, diags=jax.device_put(d, device))

    @property
    def stream_bytes(self) -> int:
        """Device-memory bytes one SpMV must move: every diagonal plus x
        and y once."""
        item = np.dtype(self.diags.dtype).itemsize
        return (len(self.offsets) * self.height + self.width
                + self.height) * item

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        return self.matmat(x[:, None])[:, 0]

    def matmat(self, X: jnp.ndarray) -> jnp.ndarray:
        n = self.height
        offs = self.offsets
        lo = -min(0, min(offs))
        hi = max(0, max(offs)) + max(0, self.width - n)
        xp = jnp.pad(X, ((lo, max(hi, 0)), (0, 0)))
        y = jnp.zeros((n, X.shape[1]), X.dtype)
        for d, off in enumerate(offs):
            y = y + self.diags[d][:, None] * jax.lax.slice_in_dim(
                xp, lo + off, lo + off + n, axis=0)
        return y


jax.tree_util.register_dataclass(
    DIAMatrix, data_fields=("diags",),
    meta_fields=("height", "width", "offsets", "nnz"))


def to_dia(A: SparseMatrix, max_diags: Optional[int] = None
           ) -> Optional[DIAMatrix]:
    """Convert CSR → DIA; returns None when the diagonal count is too high
    for DIA to be profitable (fill would exceed ~4× nnz)."""
    h = A.height
    rows = np.repeat(np.arange(h, dtype=np.int64), A.row_nnz())
    # offsets lie in [-(h-1), width-1]: a presence table over that span
    # finds the distinct diagonals in O(nnz) without sorting
    key = A.colind - rows + h
    present = np.zeros(h + A.width, bool)
    present[key] = True
    uniq = np.flatnonzero(present)
    if max_diags is None:
        max_diags = max(8, int(4 * A.nnz / max(h, 1)))
    if uniq.shape[0] > max_diags:
        return None
    slot = np.zeros(h + A.width, np.int32)
    slot[uniq] = np.arange(uniq.shape[0], dtype=np.int32)
    diags = np.zeros((uniq.shape[0], h), A.vals.dtype)
    diags[slot[key], rows] = A.vals
    # keep diags on host: device placement is explicit (``.device()``)
    return DIAMatrix(h, A.width, tuple(int(o) - h for o in uniq), diags,
                     A.nnz)


def best_device_format(A: SparseMatrix):
    """Format heuristic: DIA for stencil-like structure, ELL otherwise
    (the analog of the reference's per-kernel algorithm heuristics)."""
    dia = to_dia(A)
    if dia is not None:
        return dia
    return A.device_ell()
