"""LU factorization (reference ``src/lapack_like/factor/LU/``: partial/full
pivoting, panel dist, rank-update Mod, SolveAfter — dormant tier, spec'd by its
headers and tests).

Design: partial pivoting uses XLA's fused ``lu`` primitive (blocked with
pivoting on-device); full pivoting is an explicit masked ``fori_loop`` (max
|a_ij| reduction + row/col permutation per step — pivot search maps to vector
reductions).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision

Arr = Union[jnp.ndarray, DistMatrix]


class LU(NamedTuple):
    lu: jnp.ndarray        # packed unit-lower L and U
    perm: jnp.ndarray      # row permutation p: A[p] = L·U
    pivots: jnp.ndarray    # LAPACK-style sequential pivot rows


class LUFull(NamedTuple):
    lu: jnp.ndarray
    rowperm: jnp.ndarray
    colperm: jnp.ndarray


@with_precision
def lu(A: Arr) -> LU:
    """Partial-pivoted LU: P·A = L·U (reference ``LU``)."""
    a = as_array(A)
    packed, pivots, perm = jax.lax.linalg.lu(a)
    return LU(packed, perm, pivots)


@with_precision
def lu_full(A: Arr) -> LUFull:
    """Fully-pivoted LU (reference ``LU/Full.hpp``): P·A·Q = L·U."""
    a = as_array(A)
    n = a.shape[0]
    rp0 = jnp.arange(n)
    cp0 = jnp.arange(a.shape[1])

    def body(k, state):
        a, rp, cp = state
        absa = jnp.abs(a)
        live = ((jnp.arange(a.shape[0]) >= k)[:, None]
                & (jnp.arange(a.shape[1]) >= k)[None, :])
        masked = jnp.where(live, absa, -1.0)
        flat = jnp.argmax(masked)
        i, j = jnp.unravel_index(flat, a.shape)
        ridx = jnp.arange(a.shape[0]).at[k].set(i).at[i].set(k)
        cidx = jnp.arange(a.shape[1]).at[k].set(j).at[j].set(k)
        a = a[ridx][:, cidx]
        rp, cp = rp[ridx], cp[cidx]
        pivot = a[k, k]
        col = jnp.where(jnp.arange(a.shape[0]) > k, a[:, k] / pivot, a[:, k])
        lcol = jnp.where(jnp.arange(a.shape[0]) > k, col, 0.0)
        urow = jnp.where(jnp.arange(a.shape[1]) > k, a[k, :], 0.0)
        a = a - jnp.outer(lcol, urow)
        a = a.at[:, k].set(col)
        return (a, rp, cp)

    steps = min(a.shape)
    a, rp, cp = jax.lax.fori_loop(0, steps, body, (a, rp0, cp0))
    return LUFull(a, rp, cp)


def solve_after(fact: LU, B: Arr, orient: str = "N") -> Arr:
    """Solve A·X = B from a partial-pivoted factorization (reference
    ``LU/SolveAfter.hpp``)."""
    b = as_array(B)
    if orient.upper().startswith("N"):
        pb = b[fact.perm]
        y = trsm("L", "L", "N", "U", 1, fact.lu, pb)
        x = trsm("L", "U", "N", "N", 1, fact.lu, as_array(y))
        return like(B, as_array(x))
    # Aᵀ X = B  →  Uᵀ Lᵀ Pᵀ... solve Uᵀ y = B, Lᵀ z = y, X = Pᵀ z
    o = orient.upper()[0]
    y = trsm("L", "U", o, "N", 1, fact.lu, b)
    z = trsm("L", "L", o, "U", 1, fact.lu, as_array(y))
    inv = jnp.argsort(fact.perm)
    return like(B, as_array(z)[inv])


def solve_after_full(fact: LUFull, B: Arr) -> Arr:
    b = as_array(B)
    pb = b[fact.rowperm]
    y = trsm("L", "L", "N", "U", 1, fact.lu, pb)
    x = as_array(trsm("L", "U", "N", "N", 1, fact.lu, as_array(y)))
    inv = jnp.argsort(fact.colperm)
    return like(B, x[inv])


def lu_mod(fact: LU, u: Arr, v: Arr) -> LU:
    """Rank-one update of an LU factorization: factor A + u·vᴴ (reference
    ``LU/Mod.hpp``).  Dense re-factorization correctness path."""
    a = fact.lu
    L = jnp.tril(a, -1) + jnp.eye(a.shape[0], dtype=a.dtype)
    U = jnp.triu(a)
    inv = jnp.argsort(fact.perm)
    A = (L @ U)[inv]
    newA = A + jnp.outer(as_array(u).ravel(), jnp.conj(as_array(v).ravel()))
    return lu(newA)


def linear_solve(A: Arr, B: Arr) -> Arr:
    """General solve via partial-pivoted LU (reference ``LinearSolve``)."""
    return solve_after(lu(A), B)


def determinant(A: Arr):
    """det(A) via LU (reference ``props/Determinant``)."""
    fact = lu(A)
    d = jnp.diagonal(fact.lu)
    # each sequential pivot row differing from its index contributes one swap
    swaps = jnp.sum(jnp.where(fact.pivots != jnp.arange(fact.pivots.shape[0]),
                              1, 0))
    sign = jnp.where(swaps % 2 == 0, 1.0, -1.0).astype(d.dtype)
    return sign * jnp.prod(d)
