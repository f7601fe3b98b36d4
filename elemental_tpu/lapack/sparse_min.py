"""Sparse Euclidean minimization (reference sparse ``LeastSquares`` /
``LinearSolve`` / ``LSE`` — the dormant ``euclidean_min`` tier called by
``examples/interface/Sequential{LeastSquares,LinearSolve,LSE}.py``).

Design: the reference solves sparse LS through a regularized
quasi-definite AUGMENTED system factored by the sparse LDL; here the same
embedding runs through the level-batched multifrontal
(:class:`..sparse_direct.SparseLDLFactorization`) with iterative
refinement against the UNregularized augmented operator, so the α
regularization only shapes the factor:

    [[αI, A], [Aᵀ, −αI]]·[u; x] = [b; 0],   u = (b − Ax)/α

α defaults to √eps·‖A‖_max (dtype-aware), and each refinement step costs
one tree solve + one sparse matvec.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax.numpy as jnp

from ..core.policy import default_real_dtype
from ..sparse.csr import SparseMatrix
from ..sparse_direct import SparseLDLFactorization


def _augmented(blocks, N):
    """Assemble a symmetric sparse matrix from COO block list
    [(rows, cols, vals), ...]."""
    rows = np.concatenate([b[0] for b in blocks])
    cols = np.concatenate([b[1] for b in blocks])
    vals = np.concatenate([b[2] for b in blocks])
    return SparseMatrix.from_coo(N, N, rows, cols, vals)


def _coo(A: SparseMatrix):
    return np.repeat(np.arange(A.shape[0]), A.row_nnz()), A.colind, A.vals


def sparse_least_squares(A: SparseMatrix, b, delta: Optional[float] = None,
                         refine: int = 8) -> jnp.ndarray:
    """min‖Ax − b‖₂ for sparse A (m ≥ n or square; for square nonsingular
    A this is the sparse ``LinearSolve``).  Reference:
    ``SequentialLeastSquares.py`` / ``SequentialLinearSolve.py`` callers
    of the augmented-system path.

    The embedding keeps the residual variable UNSCALED —
    [[I, A], [Aᵀ, −δI]]·[r; x] = [b; 0] — so refinement against the
    δ-free operator contracts at O(δ·κ).  (The classical r/α scaling
    with α ≈ √eps·‖A‖ measured-DIVERGED ×3/iteration on the
    ExtendedLaplacian driver: the 1e5-scaled residual variable mixes
    magnitudes the f.p. refinement cannot survive.)"""
    m, n = A.shape
    N = m + n
    dt = default_real_dtype()
    eps = float(jnp.finfo(dt).eps)
    if delta is None:
        delta = float(np.sqrt(eps)) * max(1.0, float(np.abs(A.vals).max()))
    ar, ac, av = _coo(A)
    K = _augmented([
        (np.arange(m), np.arange(m), np.ones(m)),
        (ar, ac + m, av),
        (ac + m, ar, av),
        (np.arange(m, N), np.arange(m, N), np.full(n, -delta)),
    ], N)
    f = SparseLDLFactorization()
    f.initialize(K)
    f.factor()
    Ad = A.device_csr()
    Atd = A.transpose().device_csr()
    bj = jnp.asarray(b, dt)
    rhs = jnp.concatenate([bj, jnp.zeros(n, dt)])
    sol = f.solve(rhs)

    def k0(v):
        u, x = v[:m], v[m:]
        return jnp.concatenate([u + Ad.matvec(x), Atd.matvec(u)])

    for _ in range(refine):
        sol = sol + f.solve(rhs - k0(sol))
    return sol[m:]


def sparse_linear_solve(A: SparseMatrix, b, **kw) -> jnp.ndarray:
    """Square sparse solve (reference sparse ``LinearSolve``) via the
    same augmented embedding (exact for nonsingular A)."""
    assert A.shape[0] == A.shape[1], "square systems only"
    return sparse_least_squares(A, b, **kw)


def sparse_lse(A: SparseMatrix, B: SparseMatrix, c, d,
               delta: Optional[float] = None,
               refine: int = 6) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Equality-constrained sparse LS: min‖Ax − c‖ s.t. Bx = d
    (reference ``SequentialLSE.py``).  Augmented quasi-definite system
    [[I, 0, A], [0, −δI, B], [Aᵀ, Bᵀ, −δI]]·[r; λ; x] = [c; d; 0] with
    refinement against the δ-free KKT — the (1,1) block stays UNIT so
    the multiplier λ is O(1) and refinement contracts at O(δ·κ) (a
    1/α-scaled multiplier makes it diverge).  Returns
    (x, ‖Ax−c‖)."""
    m, n = A.shape
    p = B.shape[0]
    N = m + p + n
    dt = default_real_dtype()
    eps = float(jnp.finfo(dt).eps)
    if delta is None:
        delta = float(np.sqrt(eps)) * max(
            1.0, float(np.abs(A.vals).max()),
            float(np.abs(B.vals).max()) if B.nnz else 1.0)
    ar, ac, av = _coo(A)
    br, bc, bv = _coo(B)
    K = _augmented([
        (np.arange(m), np.arange(m), np.ones(m)),
        (ar, ac + m + p, av),
        (ac + m + p, ar, av),
        (br + m, bc + m + p, bv),
        (bc + m + p, br + m, bv),
        (np.arange(m, m + p), np.arange(m, m + p), np.full(p, -delta)),
        (np.arange(m + p, N), np.arange(m + p, N), np.full(n, -delta)),
    ], N)
    f = SparseLDLFactorization()
    f.initialize(K)
    f.factor()
    Ad, Atd = A.device_csr(), A.transpose().device_csr()
    Bd, Btd = B.device_csr(), B.transpose().device_csr()
    cj = jnp.asarray(c, dt)
    dj = jnp.asarray(d, dt)
    rhs = jnp.concatenate([cj, dj, jnp.zeros(n, dt)])
    sol = f.solve(rhs)

    def k0(v):
        r, y, x = v[:m], v[m:m + p], v[m + p:]
        return jnp.concatenate([
            r + Ad.matvec(x),
            Bd.matvec(x),
            Atd.matvec(r) + Btd.matvec(y)])

    for _ in range(refine):
        sol = sol + f.solve(rhs - k0(sol))
    x = sol[m + p:]
    return x, jnp.linalg.norm(Ad.matvec(x) - cj)
