"""Euclidean minimization (reference ``src/lapack_like/euclidean_min``:
LeastSquares, Ridge, Tikhonov, GLM, LSE)."""

from __future__ import annotations

from typing import Tuple, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision
from .cholesky import cholesky, solve_after as chol_solve
from .qr import qr

Arr = Union[jnp.ndarray, DistMatrix]


@with_precision
def least_squares(orient: str, A: Arr, B: Arr) -> Arr:
    """min ‖op(A)·X − B‖_F (reference ``LeastSquares``) via QR for m ≥ n,
    minimum-norm solution via LQ for m < n."""
    a = as_array(A)
    if not orient.upper().startswith("N"):
        a = jnp.conj(a.T) if orient.upper()[0] in ("C", "A") else a.T
    b = as_array(B)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    m, n = a.shape
    if m >= n:
        q, r = qr(a)
        x = as_array(trsm("L", "U", "N", "N", 1, r, jnp.conj(q.T) @ b))
    else:
        # minimum-norm: x = Aᴴ (A Aᴴ)⁻¹ b via QR of Aᴴ
        q, r = qr(jnp.conj(a.T))
        y = as_array(trsm("L", "U", "C", "N", 1, r, b))
        x = q @ y
    if squeeze:
        x = x[:, 0]
    return like(B, x)


@with_precision
def ridge(orient: str, A: Arr, B: Arr, gamma: float) -> Arr:
    """min ‖A·X − B‖² + γ²‖X‖² (reference ``Ridge``) via the normal equations
    (AᴴA + γ²I) X = AᴴB with a Cholesky solve — all matmul work."""
    a = as_array(A)
    if not orient.upper().startswith("N"):
        a = jnp.conj(a.T)
    b = as_array(B)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n = a.shape[1]
    g = jnp.matmul(jnp.conj(a.T), a, preferred_element_type=a.dtype)
    g = g + (gamma ** 2) * jnp.eye(n, dtype=a.dtype)
    rhs = jnp.conj(a.T) @ b
    L = cholesky("L", g)
    x = as_array(chol_solve("L", "N", L, rhs))
    if squeeze:
        x = x[:, 0]
    return like(B, x)


def tikhonov(orient: str, A: Arr, B: Arr, G: Arr) -> Arr:
    """min ‖A·X − B‖² + ‖G·X‖² with general regularizer G (reference
    ``Tikhonov``): normal equations (AᴴA + GᴴG) X = AᴴB."""
    a = as_array(A)
    if not orient.upper().startswith("N"):
        a = jnp.conj(a.T)
    g = as_array(G)
    b = as_array(B)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    lhs = jnp.conj(a.T) @ a + jnp.conj(g.T) @ g
    L = cholesky("L", lhs)
    x = as_array(chol_solve("L", "N", L, jnp.conj(a.T) @ b))
    if squeeze:
        x = x[:, 0]
    return like(B, x)


def lse(A: Arr, B: Arr, c, d) -> jnp.ndarray:
    """Equality-constrained least squares: min ‖A·x − c‖ s.t. B·x = d
    (reference ``LSE``), via the nullspace method on B's LQ."""
    a, b = as_array(A), as_array(B)
    c = as_array(c).ravel()
    d = as_array(d).ravel()
    p, n = b.shape
    # B = L·Q with Q (p×n) orthonormal rows; x = Qᴴ y1 + Z y2
    q_full, r_full = jnp.linalg.qr(jnp.conj(b.T), mode="complete")
    r = r_full[:p, :]
    # B x = d  ⇒  rᴴ (q1ᴴ x) = d
    y1 = jax.lax.linalg.triangular_solve(jnp.conj(r.T), d[:, None],
                                         left_side=True, lower=True)[:, 0]
    q1, q2 = q_full[:, :p], q_full[:, p:]
    resid_rhs = c - a @ (q1 @ y1)
    y2 = as_array(least_squares("N", a @ q2, resid_rhs))
    return q1 @ y1 + q2 @ y2


def glm(A: Arr, B: Arr, d) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """General (Gauss-Markov) linear model: min ‖y‖ s.t. d = A·x + B·y
    (reference ``GLM``), solved via the augmented least-squares system."""
    a, b = as_array(A), as_array(B)
    d = as_array(d).ravel()
    n, p = a.shape[1], b.shape[1]
    # minimize ||y|| subject to [A B][x;y] = d: x free ⇒ weighted min-norm.
    # Solve via KKT: [[0,0,Aᴴ],[0,I,Bᴴ],[A,B,0]] [x;y;λ] = [0;0;d]
    m = a.shape[0]
    z = jnp.zeros
    dt = a.dtype
    kkt = jnp.block([
        [z((n, n), dt), z((n, p), dt), jnp.conj(a.T)],
        [z((p, n), dt), jnp.eye(p, dtype=dt), jnp.conj(b.T)],
        [a, b, z((m, m), dt)],
    ])
    rhs = jnp.concatenate([z((n,), dt), z((p,), dt), d])
    sol = jnp.linalg.solve(kkt, rhs)
    return sol[:n], sol[n:n + p]
