"""Solvers (reference ``src/lapack_like/solve``: Linear, HPD, Symmetric/
Hermitian, SQSD, MultiShiftHess; headers ``include/El/lapack_like/solve/
{GMRES,LGMRES,FGMRES,Refined}.hpp``).

Krylov loops are ``lax.scan``/``fori_loop`` bodies — fixed restart length m,
static shapes, mask-guarded breakdown handling — so the whole solve compiles
to one XLA program; the operator is any callable (dense matmul, sharded SpMV).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like
from .cholesky import hpd_solve  # noqa: F401  (re-exported)
from .ldl import LDL, ldl, solve_after as ldl_solve_after
from .lu import linear_solve  # noqa: F401  (re-exported)

Arr = Union[jnp.ndarray, DistMatrix]


def symmetric_solve(A: Arr, B: Arr, conjugate: bool = False) -> Arr:
    """Solve with symmetric (or Hermitian when conjugate) A via dense LDL
    (reference ``SymmetricSolve``/``HermitianSolve``)."""
    fact = ldl(A, conjugate=conjugate)
    return ldl_solve_after(fact, B, conjugate=conjugate)


def hermitian_solve(A: Arr, B: Arr) -> Arr:
    return symmetric_solve(A, B, conjugate=True)


def sqsd_solve(A: Arr, B: Arr) -> Arr:
    """Symmetric quasi-semidefinite solve (reference ``SQSDSolve``): LDL
    without pivoting is stable for SQSD operands."""
    return symmetric_solve(A, B, conjugate=False)


def multishift_hess_solve(H: Arr, shifts, B: Arr) -> Arr:
    """Solve (H − σ_j I) x_j = b_j with upper-Hessenberg H (reference
    ``MultiShiftHessSolve``), batched over shifts via vmap."""
    h = as_array(H)
    b = as_array(B)
    shifts = jnp.asarray(shifts)
    eye = jnp.eye(h.shape[0], dtype=h.dtype)

    def one(sigma, rhs):
        return jnp.linalg.solve(h - sigma * eye, rhs)

    x = jax.vmap(one, in_axes=(0, 1), out_axes=1)(shifts, b)
    return like(B, x)


# --------------------------------------------------------------------------
# Krylov: GMRES / FGMRES / LGMRES + iterative refinement
# --------------------------------------------------------------------------

class KrylovResult(NamedTuple):
    x: jnp.ndarray
    residual: jnp.ndarray
    iterations: jnp.ndarray


def _gmres_cycle(apply_a: Callable, precond: Callable, b, x0, m: int):
    """One restart cycle of right-preconditioned GMRES(m) with modified
    Gram-Schmidt Arnoldi, fixed m, masked breakdown."""
    n = b.shape[0]
    dtype = b.dtype
    r0 = b - apply_a(x0)
    beta = jnp.linalg.norm(r0)
    safe_beta = jnp.where(beta == 0, 1.0, beta)
    V0 = jnp.zeros((m + 1, n), dtype).at[0].set(r0 / safe_beta)
    H0 = jnp.zeros((m + 1, m), dtype)
    Z0 = jnp.zeros((m, n), dtype)

    def arnoldi(j, state):
        V, H, Z = state
        z = precond(V[j])
        w = apply_a(z)

        def mgs(i, carry):
            w, H = carry
            hij = jnp.vdot(V[i], w) * (i <= j)
            H = H.at[i, j].set(hij)
            return (w - hij * V[i], H)

        w, H = jax.lax.fori_loop(0, m + 1, mgs, (w, H))
        hnorm = jnp.linalg.norm(w)
        H = H.at[j + 1, j].set(hnorm.astype(dtype))
        V = V.at[j + 1].set(w / jnp.where(hnorm == 0, 1.0, hnorm))
        Z = Z.at[j].set(z)
        return (V, H, Z)

    V, H, Z = jax.lax.fori_loop(0, m, arnoldi, (V0, H0, Z0))
    # least squares min ||beta e1 − H y||
    e1 = jnp.zeros((m + 1,), dtype).at[0].set(beta.astype(dtype))
    y, *_ = jnp.linalg.lstsq(H, e1)
    x = x0 + Z.T @ y
    res = jnp.linalg.norm(b - apply_a(x))
    return x, res


def gmres(apply_a: Callable, b, x0=None, restart: int = 30,
          max_cycles: int = 20, tol: float = 1e-8,
          precond: Callable = None) -> KrylovResult:
    """Restarted GMRES (reference ``solve/GMRES.hpp``).  ``apply_a`` is any
    linear operator; supply ``precond`` for right preconditioning (making this
    FGMRES when the preconditioner varies)."""
    b = as_array(b).ravel()
    x0 = jnp.zeros_like(b) if x0 is None else as_array(x0).ravel()
    precond = precond if precond is not None else (lambda v: v)
    bnorm = jnp.linalg.norm(b)
    target = tol * jnp.where(bnorm == 0, 1.0, bnorm)

    def cond(state):
        x, res, it = state
        return jnp.logical_and(res > target, it < max_cycles)

    def body(state):
        x, res, it = state
        x, res = _gmres_cycle(apply_a, precond, b, x, restart)
        return (x, res, it + 1)

    r0 = jnp.linalg.norm(b - apply_a(x0))
    x, res, it = jax.lax.while_loop(cond, body, (x0, r0, jnp.zeros((), jnp.int32)))
    return KrylovResult(x, res, it)


def fgmres(apply_a: Callable, b, precond: Callable, **kw) -> KrylovResult:
    """Flexible GMRES (reference ``solve/FGMRES.hpp``) — the Arnoldi basis
    stores preconditioned vectors, so the preconditioner may change per
    iteration (e.g. an inner iterative solve)."""
    return gmres(apply_a, b, precond=precond, **kw)


def lgmres(apply_a: Callable, b, **kw) -> KrylovResult:
    """LGMRES: restarted GMRES augmented with previous-cycle error
    approximations (reference ``solve/LGMRES.hpp``).  This implementation uses
    plain restarts (the augmentation vectors are subsumed by a longer restart
    window, where the Arnoldi basis lives comfortably in device memory)."""
    kw.setdefault("restart", 40)
    return gmres(apply_a, b, **kw)


def refined_solve(apply_a: Callable, apply_inv: Callable, b,
                  max_iters: int = 10, tol: float = 1e-12) -> KrylovResult:
    """Iterative refinement x ← x + Ã⁻¹(b − A·x) (reference
    ``solve/Refined.hpp``), used to recover full precision from an approximate
    (e.g. regularized or low-precision) factorization."""
    b = as_array(b)
    x0 = apply_inv(b)
    bnorm = jnp.linalg.norm(b)
    target = tol * jnp.where(bnorm == 0, 1.0, bnorm)

    def cond(state):
        x, res, it = state
        return jnp.logical_and(res > target, it < max_iters)

    def body(state):
        x, res, it = state
        r = b - apply_a(x)
        x = x + apply_inv(r)
        return (x, jnp.linalg.norm(b - apply_a(x)), it + 1)

    r0 = jnp.linalg.norm(b - apply_a(x0))
    x, res, it = jax.lax.while_loop(cond, body,
                                    (x0, r0, jnp.zeros((), jnp.int32)))
    return KrylovResult(x, res, it)


def cg(apply_a: Callable, b, x0=None, max_iters: int = 1000,
       tol: float = 1e-8, precond: Callable = None) -> KrylovResult:
    """Preconditioned conjugate gradients for HPD operators — the driver for
    the sparse end-to-end slice (SURVEY §7 minimum slice)."""
    b = as_array(b).ravel()
    x = jnp.zeros_like(b) if x0 is None else as_array(x0).ravel()
    M = precond if precond is not None else (lambda v: v)
    r = b - apply_a(x)
    z = M(r)
    p = z
    rz = jnp.vdot(r, z)
    bnorm = jnp.linalg.norm(b)
    target = tol * jnp.where(bnorm == 0, 1.0, bnorm)

    def cond(state):
        x, r, z, p, rz, it = state
        return jnp.logical_and(jnp.linalg.norm(r) > target, it < max_iters)

    def body(state):
        x, r, z, p, rz, it = state
        ap = apply_a(p)
        denom = jnp.vdot(p, ap)
        alpha = rz / jnp.where(denom == 0, 1.0, denom)
        x = x + alpha * p
        r = r - alpha * ap
        z = M(r)
        rz_new = jnp.vdot(r, z)
        beta = rz_new / jnp.where(rz == 0, 1.0, rz)
        p = z + beta * p
        return (x, r, z, p, rz_new, it + 1)

    x, r, z, p, rz, it = jax.lax.while_loop(
        cond, body, (x, r, z, p, rz, jnp.zeros((), jnp.int32)))
    return KrylovResult(x, jnp.linalg.norm(r), it)
