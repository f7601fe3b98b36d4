"""Automatic SpMV planning: pick the device form for a CSR matrix (the
dispatch tier of the reference's sparse ``Multiply``,
``tests/blas_like/Multiply.cpp:19-46``).

* ``stencil``: a banded matrix whose diagonals cover it with little fill
  runs as DIA (:mod:`elemental_tpu.sparse.dia`) — one fused memory-bound
  XLA loop that streams no index arrays.
* ``stencil_rcm``: the same after a reverse Cuthill–McKee reordering, for
  banded matrices whose rows arrive scrambled.
* ``csr``: everything else — XLA gather of x, product, sorted
  ``segment_sum`` over the rows (:class:`CSRDevice`).

Dispatch order (``plan_spmv``): stencil → stencil_rcm → csr.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from .csr import CSRDevice, SparseMatrix
from .dia import DIAMatrix, to_dia


@dataclasses.dataclass
class SpMVPlan:
    """Executable SpMV plan.  ``matvec`` operates in *plan space*: when
    ``perm`` is set, the operator computed is P·A·Pᵀ; use
    ``to_plan_space``/``from_plan_space`` at the boundary (host-side
    gathers — one-off per solve, never in the hot loop)."""

    kind: str   # 'stencil' | 'stencil_rcm' | 'csr'
    height: int
    width: int
    nnz: int
    dia: Optional[DIAMatrix] = None
    csr: Optional[CSRDevice] = None
    perm: Optional[np.ndarray] = None      # plan index -> original index
    iperm: Optional[np.ndarray] = None

    def device(self, device=None, dtype=None) -> "SpMVPlan":
        if self.dia is not None:
            return dataclasses.replace(self, dia=self.dia.device(device,
                                                                 dtype))
        csr = self.csr
        vals = csr.vals if dtype is None else csr.vals.astype(dtype)
        csr = CSRDevice(csr.height, csr.width,
                        jax.device_put(csr.rows, device),
                        jax.device_put(csr.colind, device),
                        jax.device_put(vals, device))
        return dataclasses.replace(self, csr=csr)

    # -- permutation boundary (host numpy; one-off per solve) ------------
    def to_plan_space(self, x: np.ndarray) -> np.ndarray:
        return x if self.perm is None else np.asarray(x)[self.perm]

    def from_plan_space(self, y: np.ndarray) -> np.ndarray:
        return y if self.perm is None else np.asarray(y)[self.iperm]

    # -- execution (jit-safe) ---------------------------------------------
    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        if self.dia is not None:
            return self.dia.matvec(x)
        return self.csr.matvec(x)

    @property
    def stream_bytes(self) -> int:
        """Device-memory bytes one SpMV must move (roofline accounting)."""
        if self.dia is not None:
            return self.dia.stream_bytes
        item = np.dtype(self.csr.vals.dtype).itemsize
        return self.nnz * (8 + item) + (self.height + self.width) * item


# pytree: plans pass through jit as ARGUMENTS (see core/statics.py)
from ..core.statics import register_plan_pytree  # noqa: E402

register_plan_pytree(SpMVPlan, ("dia", "csr"))


def _permuted(A: SparseMatrix, p: np.ndarray) -> SparseMatrix:
    sp = A.to_scipy().tocsr()
    return SparseMatrix.from_scipy(sp[p][:, p])


def plan_spmv(A: SparseMatrix, try_rcm: bool = True,
              max_stream_ratio: float = 16.0) -> SpMVPlan:
    """Plan y = A·x (see module docstring).  ``max_stream_ratio`` bounds
    the DIA fill: at most that many diagonals per average row nonzero
    count."""
    n = A.height
    max_diags = max(8, int(max_stream_ratio * A.nnz / max(n, 1)))

    dia = to_dia(A, max_diags=max_diags)
    if dia is not None:
        return SpMVPlan("stencil", A.height, A.width, A.nnz, dia=dia)

    if try_rcm and A.height == A.width and n > 1:
        from ..sparse_direct.ordering import reverse_cuthill_mckee
        p = reverse_cuthill_mckee(A)
        dia = to_dia(_permuted(A, p), max_diags=max_diags)
        if dia is not None:
            ip = np.empty_like(p)
            ip[p] = np.arange(n)
            return SpMVPlan("stencil_rcm", A.height, A.width, A.nnz,
                            dia=dia, perm=p, iperm=ip)

    return SpMVPlan("csr", A.height, A.width, A.nnz, csr=A.device_csr())
