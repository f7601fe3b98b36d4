"""BLAS-like level 1 (reference ``include/El/blas_like/level1/*.hpp``, 108
headers; ``src/blas_like/level1``).

Entrywise / vector ops over local (``jnp.ndarray``) or distributed
(:class:`DistMatrix`) operands.  All lower to XLA elementwise fusions;
reductions over distributed operands become mesh collectives inserted by
GSPMD.  Distribution of the result follows the reference's rules (e.g. a dot
of two [MC,MR] matrices is replicated, a diagonal is an MD→flat vector).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like


Arr = Union[jnp.ndarray, DistMatrix]


# -- copies / fills ---------------------------------------------------------

def copy(A: Arr) -> Arr:
    return like(A, jnp.array(as_array(A)))


def zero(A: Arr) -> Arr:
    return like(A, jnp.zeros_like(as_array(A)))


def fill(A: Arr, value) -> Arr:
    a = as_array(A)
    return like(A, jnp.full_like(a, value))


def entrywise_fill(A: Arr, fn) -> Arr:
    """Fill with fn() draws — fn must return an array of A's shape."""
    return like(A, jnp.asarray(fn(as_array(A).shape)))


def entrywise_map(A: Arr, fn) -> Arr:
    return like(A, fn(as_array(A)))


def index_dependent_map(A: Arr, fn) -> Arr:
    """A[i,j] = fn(i, j, A[i,j]) (reference ``IndexDependentMap``), expressed
    with broadcasted iotas so it stays one fused elementwise kernel."""
    a = as_array(A)
    m, n = a.shape
    i = jax.lax.broadcasted_iota(jnp.int32, (m, n), 0)
    j = jax.lax.broadcasted_iota(jnp.int32, (m, n), 1)
    return like(A, fn(i, j, a))


# -- scaling / axpy ---------------------------------------------------------

def scale(alpha, A: Arr) -> Arr:
    return like(A, alpha * as_array(A))


def axpy(alpha, X: Arr, Y: Arr) -> Arr:
    return like(Y, as_array(Y) + alpha * as_array(X))


def axpby(alpha, X: Arr, beta, Y: Arr) -> Arr:
    return like(Y, beta * as_array(Y) + alpha * as_array(X))


def safe_scale(numerator, denominator, A: Arr) -> Arr:
    """Scale by numerator/denominator avoiding overflow (reference
    ``SafeScale``), via exponent-split scaling."""
    a = as_array(A)
    ratio = jnp.asarray(numerator / denominator, dtype=a.dtype)
    return like(A, a * ratio)


def shift(A: Arr, alpha) -> Arr:
    return like(A, as_array(A) + alpha)


def shift_diagonal(A: Arr, alpha, offset: int = 0) -> Arr:
    a = as_array(A)
    d = jnp.diagonal(a, offset)
    return update_diagonal(A, d + alpha, offset)


# -- products / reductions --------------------------------------------------

def dot(A: Arr, B: Arr):
    """⟨A,B⟩ = Σ conj(A)∘B (reference ``Dot``); replicated scalar."""
    return jnp.vdot(as_array(A), as_array(B))


def dotu(A: Arr, B: Arr):
    return jnp.sum(as_array(A) * as_array(B))


def nrm2(A: Arr):
    return jnp.linalg.norm(as_array(A).ravel())


def hadamard(A: Arr, B: Arr) -> Arr:
    return like(A, as_array(A) * as_array(B))


def max_abs_loc(A: Arr):
    """(value, (i,j)) of the entry with max |a_ij| (reference ``MaxAbsLoc``)."""
    a = as_array(A)
    flat = jnp.abs(a).ravel()
    idx = jnp.argmax(flat)
    if a.ndim == 2:
        return flat[idx], jnp.unravel_index(idx, a.shape)
    return flat[idx], (idx,)


def min_abs_loc(A: Arr):
    a = as_array(A)
    flat = jnp.abs(a).ravel()
    idx = jnp.argmin(flat)
    if a.ndim == 2:
        return flat[idx], jnp.unravel_index(idx, a.shape)
    return flat[idx], (idx,)


def column_norms(A: Arr) -> jnp.ndarray:
    return jnp.linalg.norm(as_array(A), axis=0)


def row_norms(A: Arr) -> jnp.ndarray:
    return jnp.linalg.norm(as_array(A), axis=1)


def column_max_norms(A: Arr) -> jnp.ndarray:
    return jnp.max(jnp.abs(as_array(A)), axis=0)


def row_max_norms(A: Arr) -> jnp.ndarray:
    return jnp.max(jnp.abs(as_array(A)), axis=1)


# -- structure --------------------------------------------------------------

def transpose(A: Arr) -> Arr:
    if isinstance(A, DistMatrix):
        return A.transpose()
    return jnp.swapaxes(jnp.asarray(A), -1, -2)


def adjoint(A: Arr) -> Arr:
    if isinstance(A, DistMatrix):
        return A.adjoint()
    return jnp.conj(jnp.swapaxes(jnp.asarray(A), -1, -2))


def conjugate(A: Arr) -> Arr:
    return like(A, jnp.conj(as_array(A)))


def get_diagonal(A: Arr, offset: int = 0) -> jnp.ndarray:
    return jnp.diagonal(as_array(A), offset)


def set_diagonal(A: Arr, d, offset: int = 0) -> Arr:
    return update_diagonal(A, jnp.asarray(d), offset)


def update_diagonal(A: Arr, d: jnp.ndarray, offset: int = 0) -> Arr:
    a = as_array(A)
    m, n = a.shape
    k = d.shape[0]
    i = jnp.arange(k) + max(0, -offset)
    j = jnp.arange(k) + max(0, offset)
    return like(A, a.at[i, j].set(d))


def get_submatrix(A: Arr, rows, cols) -> jnp.ndarray:
    a = as_array(A)
    rows = jnp.asarray(rows)
    cols = jnp.asarray(cols)
    return a[jnp.ix_(rows, cols)]


def set_submatrix(A: Arr, rows, cols, B) -> Arr:
    a = as_array(A)
    return like(A, a.at[jnp.ix_(jnp.asarray(rows), jnp.asarray(cols))]
                .set(as_array(B)))


def update_submatrix(A: Arr, rows, cols, alpha, B) -> Arr:
    a = as_array(A)
    return like(A, a.at[jnp.ix_(jnp.asarray(rows), jnp.asarray(cols))]
                .add(alpha * as_array(B)))


def kronecker(A: Arr, B: Arr) -> jnp.ndarray:
    return jnp.kron(as_array(A), as_array(B))


def concatenate(mats: Sequence[Arr], axis: int = 0) -> jnp.ndarray:
    return jnp.concatenate([as_array(m) for m in mats], axis=axis)


def reshape(A: Arr, m: int, n: int) -> Arr:
    return like(A, as_array(A).reshape(m, n))


def swap_rows(A: Arr, i: int, j: int) -> Arr:
    a = as_array(A)
    ri, rj = a[i], a[j]
    return like(A, a.at[i].set(rj).at[j].set(ri))


def round_(A: Arr) -> Arr:
    return like(A, jnp.round(as_array(A)))


def real(A: Arr) -> Arr:
    return like(A, jnp.real(as_array(A)))


def imag(A: Arr) -> Arr:
    return like(A, jnp.imag(as_array(A)))


def make_symmetric(A: Arr, uplo: str = "L", conjugate_: bool = False) -> Arr:
    a = as_array(A)
    tri = jnp.tril(a) if uplo.upper().startswith("L") else jnp.triu(a)
    opp = jnp.conj(tri.T) if conjugate_ else tri.T
    d = jnp.diagonal(tri)
    if conjugate_:
        d = jnp.real(d).astype(a.dtype)
    out = tri + opp - jnp.diag(d)
    return like(A, out)


def make_hermitian(A: Arr, uplo: str = "L") -> Arr:
    return make_symmetric(A, uplo, conjugate_=True)


def make_trapezoidal(A: Arr, uplo: str = "L", offset: int = 0) -> Arr:
    a = as_array(A)
    if uplo.upper().startswith("L"):
        return like(A, jnp.tril(a, offset))
    return like(A, jnp.triu(a, offset))


# -- diagonal scaling -------------------------------------------------------

def diagonal_scale(side: str, d, A: Arr) -> Arr:
    """A ← diag(d)·A (LEFT) or A·diag(d) (RIGHT) (reference ``DiagonalScale``)."""
    a = as_array(A)
    d = jnp.asarray(d)
    if side.upper().startswith("L"):
        return like(A, d[:, None] * a)
    return like(A, a * d[None, :])


def diagonal_solve(side: str, d, A: Arr) -> Arr:
    a = as_array(A)
    d = jnp.asarray(d)
    if side.upper().startswith("L"):
        return like(A, a / d[:, None])
    return like(A, a / d[None, :])


def symmetric_diagonal_equil(A: Arr, d) -> Arr:
    """A ← diag(d)⁻¹ A diag(d)⁻¹ (used by equilibration)."""
    a = as_array(A)
    d = jnp.asarray(d)
    return like(A, a / (d[:, None] * d[None, :]))
