"""Equilibration (reference ``src/lapack_like/equilibrate``: Ruiz, Geom,
SymmetricRuiz/Geom/Diagonal — the IPM preprocessing scalings).

Each returns scaled matrix + the row/col scaling vectors so callers can
unscale solutions; iterations are ``fori_loop``s of row/col max-reductions
(pure elementwise work, shards along both mesh axes)."""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like

Arr = Union[jnp.ndarray, DistMatrix]


class Equilibrated(NamedTuple):
    a: jnp.ndarray
    drow: jnp.ndarray  # A_scaled = diag(1/drow) · A · diag(1/dcol)
    dcol: jnp.ndarray


def _safe(x):
    return jnp.where(x == 0, 1.0, x)


def ruiz_equil(A: Arr, iters: int = 3) -> Equilibrated:
    """Ruiz scaling: iteratively divide rows/cols by sqrt of their max-abs
    (reference ``Ruiz``)."""
    a = as_array(A)
    m, n = a.shape
    dr0 = jnp.ones((m,), jnp.real(a).dtype)
    dc0 = jnp.ones((n,), jnp.real(a).dtype)

    def body(i, state):
        a, dr, dc = state
        rmax = jnp.sqrt(_safe(jnp.max(jnp.abs(a), axis=1)))
        a = a / rmax[:, None].astype(a.dtype)
        dr = dr * rmax
        cmax = jnp.sqrt(_safe(jnp.max(jnp.abs(a), axis=0)))
        a = a / cmax[None, :].astype(a.dtype)
        dc = dc * cmax
        return (a, dr, dc)

    a, dr, dc = jax.lax.fori_loop(0, iters, body, (a, dr0, dc0))
    return Equilibrated(a, dr, dc)


def geom_equil(A: Arr, iters: int = 3) -> Equilibrated:
    """Geometric-mean scaling: divide by sqrt(min·max) per row/col
    (reference ``GeomEquil``)."""
    a = as_array(A)
    m, n = a.shape
    dr0 = jnp.ones((m,), jnp.real(a).dtype)
    dc0 = jnp.ones((n,), jnp.real(a).dtype)
    tiny = jnp.finfo(jnp.real(a).dtype).tiny

    def geo(x, axis):
        ab = jnp.abs(x)
        mx = jnp.max(ab, axis=axis)
        mn = jnp.min(jnp.where(ab == 0, jnp.inf, ab), axis=axis)
        mn = jnp.where(jnp.isinf(mn), 1.0, mn)
        return jnp.sqrt(_safe(jnp.sqrt(mx * jnp.maximum(mn, tiny))) ** 2)

    def body(i, state):
        a, dr, dc = state
        r = geo(a, 1)
        a = a / r[:, None].astype(a.dtype)
        dr = dr * r
        c = geo(a, 0)
        a = a / c[None, :].astype(a.dtype)
        dc = dc * c
        return (a, dr, dc)

    a, dr, dc = jax.lax.fori_loop(0, iters, body, (a, dr0, dc0))
    return Equilibrated(a, dr, dc)


def symmetric_ruiz_equil(A: Arr, iters: int = 3) -> Tuple[jnp.ndarray,
                                                          jnp.ndarray]:
    """Symmetric Ruiz: A ← D⁻¹AD⁻¹ preserving symmetry (reference
    ``SymmetricRuiz``); returns (A_scaled, d)."""
    a = as_array(A)
    n = a.shape[0]
    d0 = jnp.ones((n,), jnp.real(a).dtype)

    def body(i, state):
        a, d = state
        s = jnp.sqrt(_safe(jnp.max(jnp.abs(a), axis=1)))
        a = a / (s[:, None] * s[None, :]).astype(a.dtype)
        return (a, d * s)

    return jax.lax.fori_loop(0, iters, body, (a, d0))


def symmetric_diagonal_equil(A: Arr) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jacobi scaling by sqrt of the diagonal (reference
    ``SymmetricDiagonalEquil``)."""
    a = as_array(A)
    d = jnp.sqrt(_safe(jnp.abs(jnp.real(jnp.diagonal(a)))))
    return a / (d[:, None] * d[None, :]).astype(a.dtype), d
