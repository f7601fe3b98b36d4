"""Symmetric tridiagonal eigensolver — the PMRRR slot (reference external
``pmrrr`` §2.6 item 1: MPI+pthreads MRRR; wrapped by
``src/core/imports/pmrrr.cpp``).

XLA re-expression of MRRR's division of labor:
  * eigenvalue isolation — Sturm-sequence bisection, **vmapped over all n
    eigenvalues at once** (each bisection step is one fused scan over (d,e),
    batched elementwise — the parallel-over-eigenvalues structure PMRRR gets
    from MPI ranks);
  * eigenvectors — shifted tridiagonal inverse iteration, each solve a
    Thomas-algorithm ``lax.scan`` (O(n)), vmapped over eigenpairs, with one
    Gram-Schmidt pass inside clusters of close eigenvalues.

Subset queries (``il:iu`` / value range) come free from bisection, matching
``HermitianTridiagEigEstimate``/partial-spectrum use (§3.4)."""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp


def _sturm_count(d: jnp.ndarray, e2: jnp.ndarray, sigma) -> jnp.ndarray:
    """#eigenvalues < sigma via the LDL pivot-sign scan."""
    big = jnp.asarray(1e300 if d.dtype == jnp.float64 else 1e30, d.dtype)

    def body(q, de):
        di, e2p = de
        q = di - sigma - e2p / jnp.where(q == 0, 1e-300, q)
        return q, (q < 0).astype(jnp.int32)

    _, negs = jax.lax.scan(body, big, (d, e2))
    return jnp.sum(negs)


def tridiag_eigvalsh(d: jnp.ndarray, e: jnp.ndarray,
                     select: Optional[Tuple[int, int]] = None,
                     iters: int = 60) -> jnp.ndarray:
    """All (or an index range of) eigenvalues by batched bisection."""
    n = d.shape[0]
    e2 = jnp.concatenate([jnp.zeros((1,), d.dtype), e * e])
    # Gershgorin bounds
    rad = jnp.zeros(n, d.dtype)
    rad = rad.at[:-1].add(jnp.abs(e))
    rad = rad.at[1:].add(jnp.abs(e))
    lo = jnp.min(d - rad)
    hi = jnp.max(d + rad)
    il, iu = (0, n - 1) if select is None else select
    targets = jnp.arange(il, iu + 1)

    def bisect(target):
        def body(i, bounds):
            a, b = bounds
            mid = (a + b) / 2
            cnt = _sturm_count(d, e2, mid)
            go_right = cnt <= target
            return (jnp.where(go_right, mid, a),
                    jnp.where(go_right, b, mid))

        a, b = jax.lax.fori_loop(0, iters, body, (lo, hi))
        return (a + b) / 2

    return jax.vmap(bisect)(targets)


def _tridiag_solve(d: jnp.ndarray, e: jnp.ndarray, rhs: jnp.ndarray):
    """Thomas algorithm for (T − already-shifted) with diagonal d and
    off-diagonal e — two lax.scans (forward elim + back substitution)."""
    n = d.shape[0]
    el = jnp.concatenate([jnp.zeros((1,), d.dtype), e])   # lower offdiag
    eu = jnp.concatenate([e, jnp.zeros((1,), d.dtype)])   # upper offdiag

    def fwd(carry, inp):
        cp_prev, dp_prev = carry
        di, eli, eui_prev, bi = inp
        denom = di - eli * cp_prev
        denom = jnp.where(jnp.abs(denom) < 1e-300,
                          jnp.asarray(1e-300, d.dtype), denom)
        cp = eui_prev / denom          # note: c'_i uses u_i; we shift below
        dp = (bi - eli * dp_prev) / denom
        return (cp, dp), (cp, dp)

    # u_i enters at its own row: pass eu_i with row i
    inps = (d, el, eu, rhs)
    (_, _), (cps, dps) = jax.lax.scan(fwd, (jnp.zeros((), d.dtype),
                                            jnp.zeros((), d.dtype)), inps)

    def bwd(x_next, inp):
        cp, dp = inp
        x = dp - cp * x_next
        return x, x

    _, xs = jax.lax.scan(bwd, jnp.zeros((), d.dtype), (cps, dps),
                         reverse=True)
    return xs


def tridiag_eig(d: jnp.ndarray, e: jnp.ndarray,
                select: Optional[Tuple[int, int]] = None,
                inv_iters: int = 3):
    """(w, Z): eigenvalues by bisection + eigenvectors by vmapped shifted
    inverse iteration with intra-cluster Gram-Schmidt."""
    n = d.shape[0]
    w = tridiag_eigvalsh(d, e, select)
    eps = jnp.finfo(d.dtype).eps
    tnorm = jnp.max(jnp.abs(d)) + 2 * jnp.max(jnp.abs(e)) if e.size else \
        jnp.max(jnp.abs(d))
    # separate shifts inside clusters so inverse iteration can distinguish
    # nearly equal eigenvalues (the MRRR "relatively robust representation"
    # role, done here by perturbed shifts + reorthogonalization)
    pert = (jnp.arange(w.shape[0]) % 7 - 3) * 16 * eps * tnorm
    shifts = w + pert

    key = jax.random.PRNGKey(0)
    v0 = jax.random.normal(key, (w.shape[0], n), d.dtype)

    def one(shift, v):
        def body(i, v):
            x = _tridiag_solve(d - shift, e, v)
            return x / jnp.linalg.norm(x)

        return jax.lax.fori_loop(0, inv_iters, body,
                                 v / jnp.linalg.norm(v))

    Z = jax.vmap(one)(shifts, v0)      # (k, n)

    # one Gram-Schmidt sweep over neighbours within clusters
    gap = jnp.abs(jnp.diff(w))
    close = jnp.concatenate([jnp.zeros((1,), bool),
                             gap < 1e3 * eps * tnorm])

    def gs(carry, inp):
        prev = carry
        z, is_close = inp
        z = jnp.where(is_close, z - (prev @ z) * prev, z)
        z = z / jnp.linalg.norm(z)
        return z, z

    _, Z = jax.lax.scan(gs, Z[0], (Z, close))
    return w, Z.T
