"""Matrix functions (reference ``src/lapack_like/funcs``: HermitianFunction,
Sign (Newton), SquareRoot, Pseudoinverse, Inverse incl. triangular/HPD/
symmetric).  All iterations are matmul/solve loops."""

from __future__ import annotations

from typing import Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision
from .cholesky import cholesky
from .lu import lu, solve_after as lu_solve
from .spectral import hermitian_eig

Arr = Union[jnp.ndarray, DistMatrix]


@with_precision
def inverse(A: Arr) -> Arr:
    """General inverse via LU (reference ``funcs/Inverse``)."""
    a = as_array(A)
    fact = lu(a)
    eye = jnp.eye(a.shape[0], dtype=a.dtype)
    return like(A, as_array(lu_solve(fact, eye)))


def triangular_inverse(uplo: str, diag: str, A: Arr) -> Arr:
    """Triangular inverse (reference ``TriangularInverse``) via trsm vs I."""
    a = as_array(A)
    eye = jnp.eye(a.shape[0], dtype=a.dtype)
    out = as_array(trsm("L", uplo, "N", diag, 1, a, eye))
    mask = jnp.tril(jnp.ones_like(out)) if uplo.upper().startswith("L") \
        else jnp.triu(jnp.ones_like(out))
    return like(A, out * mask)


def hpd_inverse(uplo: str, A: Arr) -> Arr:
    """HPD inverse via Cholesky (reference ``HPDInverse``)."""
    a = as_array(A)
    L = as_array(cholesky("L", a if uplo.upper().startswith("L")
                          else jnp.conj(as_array(A).T)))
    Linv = as_array(triangular_inverse("L", "N", L))
    inv = jnp.conj(Linv.T) @ Linv
    return like(A, inv)


def symmetric_inverse(A: Arr, conjugate: bool = False) -> Arr:
    """Symmetric/Hermitian inverse via LDL (reference ``SymmetricInverse``)."""
    from .ldl import ldl, solve_after
    a = as_array(A)
    fact = ldl(a, conjugate=conjugate)
    eye = jnp.eye(a.shape[0], dtype=a.dtype)
    return like(A, as_array(solve_after(fact, eye, conjugate=conjugate)))


@with_precision
def pseudoinverse(A: Arr, tol: float = None) -> Arr:
    """Moore-Penrose pseudoinverse via SVD (reference ``Pseudoinverse``)."""
    a = as_array(A)
    u, s, vh = jnp.linalg.svd(a, full_matrices=False)
    eps = jnp.finfo(s.dtype).eps
    cutoff = (tol if tol is not None
              else max(a.shape) * eps) * jnp.max(s)
    sinv = jnp.where(s > cutoff, 1.0 / s, 0.0).astype(a.dtype)
    return like(A, jnp.conj(vh.T) @ (sinv[:, None] * jnp.conj(u.T)))


@with_precision
def sign(A: Arr, iters: int = 100, tol: float = 1e-12) -> Arr:
    """Matrix sign function via scaled Newton iteration X ← (cX + (cX)⁻¹)/2
    (reference ``funcs/Sign`` — the Sylvester/Lyapunov/Riccati engine)."""
    a = as_array(A)
    n = a.shape[0]

    def cond(state):
        x, diff, it = state
        return jnp.logical_and(diff > tol, it < iters)

    def body(state):
        x, _, it = state
        xinv = jnp.linalg.inv(x)
        # determinantal scaling: c = |det X|^(−1/n)
        _, logdet = jnp.linalg.slogdet(x)
        c = jnp.exp(-jnp.real(logdet) / n).astype(a.dtype)
        xnew = (c * x + xinv / c) / 2
        diff = jnp.linalg.norm(xnew - x) / jnp.maximum(
            jnp.linalg.norm(xnew), 1e-30)
        return (xnew, diff, it + 1)

    x, _, _ = jax.lax.while_loop(cond, body,
                                 (a, jnp.asarray(jnp.inf, jnp.float64
                                                 if a.dtype == jnp.float64
                                                 else jnp.float32),
                                  jnp.zeros((), jnp.int32)))
    return like(A, x)


@with_precision
def square_root(A: Arr, iters: int = 64, tol: float = 1e-12) -> Arr:
    """Principal matrix square root via the Denman–Beavers iteration
    (reference ``funcs/SquareRoot``)."""
    a = as_array(A)
    n = a.shape[0]
    eye = jnp.eye(n, dtype=a.dtype)

    def cond(state):
        y, z, diff, it = state
        return jnp.logical_and(diff > tol, it < iters)

    def body(state):
        y, z, _, it = state
        yinv = jnp.linalg.inv(y)
        zinv = jnp.linalg.inv(z)
        ynew = (y + zinv) / 2
        znew = (z + yinv) / 2
        diff = jnp.linalg.norm(ynew @ ynew - a) / jnp.maximum(
            jnp.linalg.norm(a), 1e-30)
        return (ynew, znew, diff, it + 1)

    rdt = jnp.float64 if a.dtype in (jnp.float64, jnp.complex128) \
        else jnp.float32
    y, z, _, _ = jax.lax.while_loop(
        cond, body, (a, eye, jnp.asarray(jnp.inf, rdt),
                     jnp.zeros((), jnp.int32)))
    return like(A, y)


def hpd_square_root(uplo: str, A: Arr) -> Arr:
    """Square root of an HPD matrix via its eigendecomposition (reference
    ``HPDSquareRoot``)."""
    return hermitian_function(uplo, A, jnp.sqrt)


def hermitian_function(uplo: str, A: Arr, fn) -> Arr:
    """f(A) for Hermitian A via eigendecomposition (reference
    ``HermitianFunction``)."""
    pair = hermitian_eig(uplo, A, vectors=True)
    w = fn(pair.w)
    a = as_array(A)
    out = (pair.q * w[None, :].astype(a.dtype)) @ jnp.conj(pair.q.T)
    return like(A, out)
