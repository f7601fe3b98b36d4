"""Cholesky factorization (reference ``src/lapack_like/factor/Cholesky*``:
blocked right-looking Variant3 L/U, reverse, pivoted, LowerMod rank-update,
SolveAfter; dist panel loop in ``Cholesky/LowerVariant3.hpp:80-140``).

Design: *recursive* blocked Cholesky.  The reference's panel loop
([MC,MR]→[*,*] allgather of A11, local potrf, [VC,*] panel trsm, Trrk trailing
update) re-expressed as a midpoint recursion — the same math, but each level's
trailing update is one large sharded matmul which GSPMD tiles over the mesh (cuBLAS
on each device), and only O(log n) distinct shapes are compiled.  The O(nb²) base case
uses XLA's ``cholesky`` primitive.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision

Arr = Union[jnp.ndarray, DistMatrix]

_BASE = 256


def _chol_lower_rec(a: jnp.ndarray) -> jnp.ndarray:
    n = a.shape[0]
    if n <= _BASE:
        return jax.lax.linalg.cholesky(a)
    m = n // 2
    A11, A21, A22 = a[:m, :m], a[m:, :m], a[m:, m:]
    L11 = _chol_lower_rec(A11)
    # L21 = A21 · L11⁻ᴴ
    L21 = jax.lax.linalg.triangular_solve(
        L11, A21, left_side=False, lower=True, transpose_a=True,
        conjugate_a=True)
    A22u = A22 - jnp.matmul(L21, jnp.conj(L21.T),
                            preferred_element_type=a.dtype)
    L22 = _chol_lower_rec(A22u)
    top = jnp.concatenate([L11, jnp.zeros((m, n - m), a.dtype)], axis=1)
    bot = jnp.concatenate([L21, L22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


@with_precision
def cholesky(uplo: str, A: Arr) -> Arr:
    """Return the Cholesky factor of Hermitian positive-definite A: lower L
    with A = L·Lᴴ, or upper U with A = Uᴴ·U (reference ``Cholesky``,
    ``Cholesky.cpp:144``)."""
    a = as_array(A)
    if uplo.upper().startswith("L"):
        out = jnp.tril(_chol_lower_rec(a))
    else:
        # U = (chol_lower(Aᴴ))ᴴ with A Hermitian: chol of conj(A) transposed
        lower = _chol_lower_rec(jnp.conj(a.T))
        out = jnp.conj(jnp.tril(lower).T)
    return like(A, out)


def reverse_cholesky(uplo: str, A: Arr) -> Arr:
    """Reverse Cholesky (reference ``Cholesky/ReverseLowerVariant3.hpp``):
    elimination from the bottom-right, yielding the UL-style factorizations
    A = Lᴴ·L (LOWER, L lower-triangular) or A = U·Uᴴ (UPPER).  Computed by
    flipping both axes, factoring, and flipping back."""
    a = as_array(A)
    flipped = a[::-1, ::-1]
    if uplo.upper().startswith("L"):
        u = as_array(cholesky("U", flipped))
        return like(A, u[::-1, ::-1])
    l = as_array(cholesky("L", flipped))
    return like(A, l[::-1, ::-1])


class PivotedCholesky(NamedTuple):
    factor: jnp.ndarray
    perm: jnp.ndarray   # permutation vector p: A[p][:,p] = L·Lᴴ
    rank: jnp.ndarray   # numerical rank detected


def pivoted_cholesky(uplo: str, A: Arr, tol: float = 0.0) -> PivotedCholesky:
    """Diagonally-pivoted Cholesky (reference ``Cholesky/PivotedLowerVariant3``):
    at step k pivot the largest remaining diagonal entry to position k.
    Unblocked ``fori_loop`` — pivoting is a max-reduction + row/col swap per
    step, formulated with static shapes."""
    a = as_array(A)
    if not uplo.upper().startswith("L"):
        a = jnp.conj(a.T)
    n = a.shape[0]
    p0 = jnp.arange(n)

    def body(k, state):
        a, p, rank = state
        d = jnp.real(jnp.diagonal(a))
        masked = jnp.where(jnp.arange(n) >= k, d, -jnp.inf)
        j = jnp.argmax(masked)
        # swap rows/cols k <-> j
        idx = jnp.arange(n).at[k].set(j).at[j].set(k)
        a = a[idx][:, idx]
        p = p[idx]
        pivot = jnp.real(a[k, k])
        ok = pivot > tol
        rank = jnp.where(ok, rank + 1, rank)
        root = jnp.sqrt(jnp.where(ok, pivot, 1.0)).astype(a.dtype)
        col = jnp.where(jnp.arange(n) > k, a[:, k], 0.0) / root
        a = a.at[:, k].set(jnp.where(jnp.arange(n) > k, col, a[:, k]))
        a = a.at[k, k].set(root)
        upd = jnp.outer(col, jnp.conj(col))
        mask = ((jnp.arange(n) > k)[:, None]) & ((jnp.arange(n) > k)[None, :])
        a = jnp.where(mask, a - upd, a)
        return (a, p, rank)

    a, p, rank = jax.lax.fori_loop(0, n, body, (a, p0, jnp.zeros((), jnp.int32)))
    return PivotedCholesky(jnp.tril(a), p, rank)


def cholesky_mod(uplo: str, L: Arr, alpha, V: Arr) -> Arr:
    """Update the factor after a rank-k perturbation: given A = L·Lᴴ, return
    the factor of A + α·V·Vᴴ (reference ``Cholesky/LowerMod.hpp``).  Dense
    reformation — correctness path; a hyperbolic-rotation streaming update is
    a later optimisation."""
    l = as_array(L)
    v = as_array(V)
    lower = uplo.upper().startswith("L")
    base = l @ jnp.conj(l.T) if lower else jnp.conj(l.T) @ l
    newA = base + alpha * (v @ jnp.conj(v.T))
    return like(L, as_array(cholesky(uplo, newA)))


def solve_after(uplo: str, orient: str, L: Arr, B: Arr) -> Arr:
    """Solve A·X = B given the Cholesky factor (reference
    ``factor/Cholesky/SolveAfter.hpp``): two triangular solves."""
    lower = uplo.upper().startswith("L")
    if lower:
        y = trsm("L", "L", "N", "N", 1, L, B)
        x = trsm("L", "L", "C", "N", 1, L, y)
    else:
        y = trsm("L", "U", "C", "N", 1, L, B)
        x = trsm("L", "U", "N", "N", 1, L, y)
    return like(B, as_array(x))


def hpd_solve(uplo: str, A: Arr, B: Arr) -> Arr:
    """Factor + solve (reference ``HPDSolve``)."""
    L = cholesky(uplo, A)
    return solve_after(uplo, "N", L, B)
