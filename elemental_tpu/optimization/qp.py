"""Interior-point quadratic programming (reference MISSING ``optimization/``
QP solvers, spec from ``examples/interface/QP*.py`` callers):

  direct form:  min ½ xᵀQx + cᵀx  s.t.  A·x = b,  x ≥ 0
  box form:     min ½ xᵀQx + cᵀx  s.t.  l ≤ x ≤ u

Mehrotra predictor-corrector on the fixed-pattern quasi-definite KKT
[[Q + Θ + γI, Aᵀ], [A, −δI]] through the multifrontal RegularizedLDL —
Θ = z/x is the only per-iteration change (``ChangeNonzeroValues`` reuse,
``DistSparseLDLFactorization.cpp:149``); the whole step is one jitted
device program."""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp

from ..sparse.csr import SparseMatrix
from .kkt import KKTBuilder
from .lp import LPCtrl, LPResult, _steplen_j


def qp_direct(Q, A, b: np.ndarray, c: np.ndarray,
              ctrl: Optional[LPCtrl] = None) -> LPResult:
    """min ½xᵀQx + cᵀx s.t. Ax = b, x ≥ 0 (reference ``QPDirect``)."""
    ctrl = ctrl or LPCtrl()
    if not isinstance(Q, SparseMatrix):
        Q = SparseMatrix.from_dense(np.asarray(Q))
    if not isinstance(A, SparseMatrix):
        A = SparseMatrix.from_dense(np.asarray(A))
    m, n = A.shape
    N = n + m
    from .lp import _resolve_numerics, _resolve_refine
    gamma, _tol_eff = _resolve_numerics(ctrl)
    delta = gamma

    kb = KKTBuilder(N)
    qrows = np.repeat(np.arange(n), Q.row_nnz())
    arows = np.repeat(np.arange(m), A.row_nnz()) + n
    kb.add_static(qrows, Q.colind, Q.vals)
    kb.add_static(arows, A.colind, A.vals)
    kb.add_static(A.colind, arows, A.vals)
    kb.add_static(np.arange(n), np.arange(n), np.full(n, gamma))
    kb.add_static(np.arange(n, N), np.arange(n, N), np.full(m, -delta))
    kb.add_dynamic(np.arange(n), np.arange(n))  # Θ
    kkt = kb.finalize(perm=ctrl.ordering)
    reg_diag = jnp.concatenate([jnp.full(n, gamma), jnp.full(m, -delta)])


    Qd = Q.device_csr()
    Ad, Atd = A.device_csr(), A.transpose().device_csr()
    bj, cj = jnp.asarray(b), jnp.asarray(c)
    tau, tol = ctrl.tau, _tol_eff
    nref = _resolve_refine(ctrl)
    unroll = ctrl.refine_unroll

    @jax.jit
    def step(x, y, z, kkt, reg_diag, Qd, Ad, Atd, bj, cj):
        rb = bj - Ad.matvec(x)
        rc = cj + Qd.matvec(x) - Atd.matvec(y) - z
        mu = x @ z / n
        theta = z / x
        fact = kkt.prepare(kkt.assemble([theta]))

        def directions(rmu):
            # (Q+Θ)dx − Aᵀdy = −rc + rmu/x ; A dx = rb
            # symmetric K[p;q] = [f;g] with dy = −q
            rhs = jnp.concatenate([-rc + rmu / x, rb])
            sol = fact.solve_refined(rhs, reg_diag, iters=nref,
                                     unroll=unroll)
            dx, dy = sol[:n], -sol[n:]
            dz = (rmu - z * dx) / x
            return dx, dy, dz

        dxa, _, dza = directions(-x * z)
        ap = _steplen_j(x, dxa, 1.0)
        ad = _steplen_j(z, dza, 1.0)
        mu_aff = (x + ap * dxa) @ (z + ad * dza) / n
        sigma = jnp.where(mu > 0, (mu_aff / mu) ** 3, 0.0)
        dx, dy, dz = directions(sigma * mu - x * z - dxa * dza)
        alpha = jnp.minimum(_steplen_j(x, dx, tau), _steplen_j(z, dz, tau))
        xn, yn, zn = x + alpha * dx, y + alpha * dy, z + alpha * dz
        # finiteness of the NEW iterate (the residuals are of the input)
        ok = (jnp.all(jnp.isfinite(xn)) & jnp.all(jnp.isfinite(yn))
              & jnp.all(jnp.isfinite(zn)))
        return (xn, yn, zn, jnp.linalg.norm(rb), jnp.linalg.norm(rc), mu, ok)

    x = jnp.ones(n, bj.dtype)
    y = jnp.zeros(m, bj.dtype)
    z = jnp.ones(n, bj.dtype)
    bnorm = float(np.linalg.norm(b)) + 1.0
    cnorm = float(np.linalg.norm(c)) + 1.0

    it = 0
    converged = False
    for it in range(1, ctrl.max_iters + 1):
        xp, yp, zp = x, y, z
        x, y, z, rbn, rcn, mu, ok = step(x, y, z, kkt, reg_diag, Qd, Ad, Atd, bj, cj)
        if not bool(ok) or not np.isfinite(float(rbn) + float(rcn)
                                           + float(mu)):
            x, y, z = xp, yp, zp
            break
        if (float(rbn) / bnorm < tol and float(rcn) / cnorm < tol
                and float(mu) < tol):
            x, y, z = xp, yp, zp
            converged = True
            break
        if ctrl.verbose:
            print(f"  it {it}: mu={float(mu):.3e}")

    x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
    Qx = np.asarray(Qd.matvec(jnp.asarray(x)))
    obj = float(0.5 * x @ Qx + c @ x)
    return LPResult(x, y, z, obj, it, converged)


def qp_box(Q, c: np.ndarray, lower: np.ndarray, upper: np.ndarray,
           ctrl: Optional[LPCtrl] = None) -> np.ndarray:
    """min ½xᵀQx + cᵀx s.t. l ≤ x ≤ u (reference box-constrained QP), via
    the shift x = l + s, s + t = u − l, s,t ≥ 0 in direct form."""
    ctrl = ctrl or LPCtrl()
    n = c.shape[0]
    lower = np.asarray(lower, float)
    upper = np.asarray(upper, float)
    span = upper - lower
    Qs = Q if isinstance(Q, SparseMatrix) \
        else SparseMatrix.from_dense(np.asarray(Q))
    # variables v = [s; t]; Q̂ acts on s only; constraint s + t = span
    qrows = np.repeat(np.arange(n), Qs.row_nnz())
    Qh = SparseMatrix.from_coo(2 * n, 2 * n, qrows, Qs.colind, Qs.vals)
    Ql = np.zeros(n)
    np.add.at(Ql, qrows, Qs.vals * lower[Qs.colind])
    ch = np.concatenate([c + Ql, np.zeros(n)])
    idx = np.arange(n)
    Ah = SparseMatrix.from_coo(
        n, 2 * n, np.concatenate([idx, idx]),
        np.concatenate([idx, idx + n]), np.ones(2 * n))
    res = qp_direct(Qh, Ah, span, ch, ctrl)
    return lower + res.x[:n]


def qp_affine(Q, A, b: np.ndarray, G, h: np.ndarray, c: np.ndarray,
              ctrl: Optional[LPCtrl] = None) -> LPResult:
    """min ½xᵀQx + cᵀx s.t. Ax = b, Gx + s = h, s ≥ 0 (reference
    ``QPAffine``, spec from ``examples/interface/QPAffine.py``) via the
    fixed-pattern regularized quasi-definite KKT
    [[Q+γI, Aᵀ, Gᵀ], [A, −δI, 0], [G, 0, −(W+δ)I]], W = s/z the dynamic
    slot, factored by the multifrontal LDL every iteration (symbolic
    reused — ``ChangeNonzeroValues``)."""
    ctrl = ctrl or LPCtrl()
    if not isinstance(Q, SparseMatrix):
        Q = SparseMatrix.from_dense(np.asarray(Q))
    if not isinstance(A, SparseMatrix):
        A = SparseMatrix.from_dense(np.asarray(A))
    if not isinstance(G, SparseMatrix):
        G = SparseMatrix.from_dense(np.asarray(G))
    m, n = A.shape
    k = G.shape[0]
    N = n + m + k
    from .lp import _resolve_numerics, _resolve_refine
    gamma, tol = _resolve_numerics(ctrl)
    delta = gamma

    kb = KKTBuilder(N)
    qrows = np.repeat(np.arange(n), Q.row_nnz())
    arows = np.repeat(np.arange(m), A.row_nnz()) + n
    grows = np.repeat(np.arange(k), G.row_nnz()) + n + m
    kb.add_static(qrows, Q.colind, Q.vals)
    kb.add_static(arows, A.colind, A.vals)
    kb.add_static(A.colind, arows, A.vals)
    kb.add_static(grows, G.colind, G.vals)
    kb.add_static(G.colind, grows, G.vals)
    kb.add_static(np.arange(n), np.arange(n), np.full(n, gamma))
    kb.add_static(np.arange(n, n + m), np.arange(n, n + m),
                  np.full(m, -delta))
    kb.add_static(np.arange(n + m, N), np.arange(n + m, N),
                  np.full(k, -delta))
    kb.add_dynamic(np.arange(n + m, N), np.arange(n + m, N))     # −W
    kkt = kb.finalize(perm=ctrl.ordering)
    reg_diag = jnp.concatenate([jnp.full(n, gamma), jnp.full(m, -delta),
                                jnp.full(k, -delta)])

    Qd = Q.device_csr()
    Ad, Atd = A.device_csr(), A.transpose().device_csr()
    Gd, Gtd = G.device_csr(), G.transpose().device_csr()
    bj, hj, cj = jnp.asarray(b), jnp.asarray(h), jnp.asarray(c)
    tau = ctrl.tau
    nref = _resolve_refine(ctrl)
    unroll = ctrl.refine_unroll

    @jax.jit
    def step(x, y, s, z, kkt, reg_diag, Qd, Ad, Atd, Gd, Gtd, bj, hj, cj):
        rb = bj - Ad.matvec(x)
        rh = hj - Gd.matvec(x) - s
        rc = -(cj + Qd.matvec(x) + Atd.matvec(y) + Gtd.matvec(z))
        mu = s @ z / k
        pobj = 0.5 * x @ Qd.matvec(x) + cj @ x
        gap = jnp.abs(mu) / (1 + jnp.abs(pobj))
        w = s / z
        fact = kkt.prepare(kkt.assemble([-w]))

        def directions(rmu):
            rhs = jnp.concatenate([rc, rb, rh - rmu / z])
            sol = fact.solve_refined(rhs, reg_diag, iters=nref,
                                     unroll=unroll)
            dx, dy, dz = sol[:n], sol[n:n + m], sol[n + m:]
            ds = (rmu - s * dz) / z
            return dx, dy, dz, ds

        dxa, dya, dza, dsa = directions(-s * z)
        ap = _steplen_j(s, dsa, 1.0)
        ad = _steplen_j(z, dza, 1.0)
        mu_aff = (s + ap * dsa) @ (z + ad * dza) / k
        sigma = jnp.where(mu > 0, (mu_aff / mu) ** 3, 0.0)
        dx, dy, dz, ds = directions(sigma * mu - s * z - dsa * dza)

        alpha = jnp.minimum(_steplen_j(s, ds, tau), _steplen_j(z, dz, tau))
        xn, yn = x + alpha * dx, y + alpha * dy
        sn, zn = s + alpha * ds, z + alpha * dz
        ok = (jnp.all(jnp.isfinite(xn)) & jnp.all(jnp.isfinite(yn))
              & jnp.all(jnp.isfinite(sn)) & jnp.all(jnp.isfinite(zn)))
        return (xn, yn, sn, zn, jnp.linalg.norm(rb), jnp.linalg.norm(rh),
                jnp.linalg.norm(rc), gap, mu, ok)

    x = jnp.zeros(n, jnp.result_type(hj, cj))
    y = jnp.zeros(m, x.dtype)
    s = jnp.maximum(hj - Gd.matvec(x), 1.0)
    z = jnp.ones(k, x.dtype)
    bn = 1 + float(np.linalg.norm(b))
    hn = 1 + float(np.linalg.norm(h))
    cn = 1 + float(np.linalg.norm(c))
    it = 0
    converged = False
    for it in range(1, ctrl.max_iters + 1):
        xp, yp, sp, zp = x, y, s, z
        x, y, s, z, rbn, rhn, rcn, gap, mu, ok = step(
            x, y, s, z, kkt, reg_diag, Qd, Ad, Atd, Gd, Gtd, bj, hj, cj)
        if not bool(ok) or not np.isfinite(float(rbn) + float(rcn)
                                           + float(gap)):
            x, y, s, z = xp, yp, sp, zp
            break
        if (float(rbn) < tol * bn and float(rhn) < tol * hn
                and float(rcn) < tol * cn
                and (float(gap) < tol or float(mu) < tol)):
            x, y, s, z = xp, yp, sp, zp
            converged = True
            break
        if ctrl.verbose:
            print(f"  it {it}: mu={float(mu):.3e} gap={float(gap):.3e}")

    x, y, s, z = (np.asarray(v) for v in (x, y, s, z))
    Qx = np.asarray(Qd.matvec(jnp.asarray(x)))
    obj = float(0.5 * x @ Qx + c @ x)
    return LPResult(x, y, z, obj, it, converged, s=s, tol_effective=tol)
