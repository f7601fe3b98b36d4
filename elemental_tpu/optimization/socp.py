"""Second-order-cone programming (reference MISSING tier; API spec from
``examples/interface/SOCP_trivial.py`` / ``SOCAtom.py`` — Jordan-algebra
atoms over a product of Lorentz cones given by ``orders``/``firstInds``).

  affine form:  min cᵀx  s.t.  A·x = b,  G·x + s = h,  s ∈ K
  K = K₁ × ... × K_r, each K_i = {(s₀, s̄) : s₀ ≥ ‖s̄‖}

Solver: Nesterov–Todd-scaled Mehrotra predictor-corrector (the standard
self-scaled-cone IPM; NT scaling point per Alizadeh–Goldfarb).  The
Newton system is the fixed-pattern quasi-definite KKT
[[γI, Aᵀ, Gᵀ], [A, −δI, 0], [G, 0, −Q_w−δI]] where Q_w = 2wwᵀ − det(w)·J
is the quadratic representation of the NT point w (Q_w z = s); the
per-cone Q_w blocks are the dynamic slot — cones are grouped by order and
the block values computed with one vmapped einsum per group, so each
iteration is a single jitted device program through the multifrontal LDL
(symbolic analysis reused across iterations).  A one-sided dual-HKM
linearization with fixed σ stalls on genuine SOC instances (nothing
recenters the primal slack; see ``step``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..sparse.csr import SparseMatrix
from .kkt import KKTBuilder
from .lp import LPCtrl


# --------------------------------------------------------------------------
# Jordan-algebra / SOC atoms (reference SOCAtom.py surface)
# --------------------------------------------------------------------------

class Cones:
    """Product of Lorentz cones described by member orders (reference
    ``orders``/``firstInds`` vectors)."""

    def __init__(self, orders: Sequence[int]):
        self.orders = tuple(int(o) for o in orders)
        self.first = np.cumsum([0] + list(self.orders[:-1]))
        self.dim = int(sum(self.orders))

    def blocks(self, s: np.ndarray) -> List[np.ndarray]:
        return [s[f:f + o] for f, o in zip(self.first, self.orders)]


def soc_dets(s: np.ndarray, cones: Cones) -> np.ndarray:
    """det(s_i) = s₀² − ‖s̄‖² per cone (reference ``SOCDets``)."""
    return np.array([b[0] ** 2 - b[1:] @ b[1:] for b in cones.blocks(s)])


def soc_identity(cones: Cones) -> np.ndarray:
    e = np.zeros(cones.dim)
    e[cones.first] = 1.0
    return e


def soc_apply(x: np.ndarray, y: np.ndarray, cones: Cones) -> np.ndarray:
    """Jordan product x∘y per cone (reference ``SOCApply``)."""
    out = np.zeros(cones.dim)
    for f, o in zip(cones.first, cones.orders):
        xb, yb = x[f:f + o], y[f:f + o]
        out[f] = xb @ yb
        out[f + 1:f + o] = xb[0] * yb[1:] + yb[0] * xb[1:]
    return out


def soc_inverse(x: np.ndarray, cones: Cones) -> np.ndarray:
    """Jordan inverse per cone."""
    out = np.zeros(cones.dim)
    for f, o in zip(cones.first, cones.orders):
        xb = x[f:f + o]
        det = xb[0] ** 2 - xb[1:] @ xb[1:]
        out[f] = xb[0] / det
        out[f + 1:f + o] = -xb[1:] / det
    return out


def soc_min_eig(s: np.ndarray, cones: Cones) -> float:
    """min over cones of λ_min(s_i) = s₀ − ‖s̄‖ (reference ``SOCMinEig``)."""
    return min(b[0] - np.linalg.norm(b[1:]) for b in cones.blocks(s))


def in_cone(s: np.ndarray, cones: Cones, margin: float = 0.0) -> bool:
    return soc_min_eig(s, cones) > margin


def max_step(s: np.ndarray, ds: np.ndarray, cones: Cones,
             tau: float = 0.995) -> float:
    """Largest α ≤ 1 with s + α·ds ∈ K (fraction-to-boundary)."""
    lo, hi = 0.0, 1.0
    if in_cone(s + ds, cones):
        return 1.0
    for _ in range(50):
        mid = (lo + hi) / 2
        if in_cone(s + mid * ds, cones):
            lo = mid
        else:
            hi = mid
    return tau * lo


def _barrier_hessian(s: np.ndarray, cones: Cones) -> np.ndarray:
    """∇²F(s) = (4/det²)(Js)(Js)ᵀ − (2/det)J per cone, J = diag(1,−1,…,−1)
    (host helper; the device hot loop uses the closed-form inverse)."""
    H = np.zeros((cones.dim, cones.dim))
    for f, o in zip(cones.first, cones.orders):
        sb = s[f:f + o]
        det = sb[0] ** 2 - sb[1:] @ sb[1:]
        J = -np.eye(o)
        J[0, 0] = 1.0
        Js = J @ sb
        H[f:f + o, f:f + o] = (4.0 / det ** 2) * np.outer(Js, Js) \
            - (2.0 / det) * J
    return H


def _barrier_grad(s: np.ndarray, cones: Cones) -> np.ndarray:
    g = np.zeros(cones.dim)
    for f, o in zip(cones.first, cones.orders):
        sb = s[f:f + o]
        det = sb[0] ** 2 - sb[1:] @ sb[1:]
        g[f] = -2.0 * sb[0] / det
        g[f + 1:f + o] = 2.0 * sb[1:] / det
    return g


class ConeOps:
    """Order-grouped, jit-safe cone operations: cones of equal order are
    stacked so every per-cone formula is one vmapped tensor op."""

    def __init__(self, cones: Cones):
        orders = np.asarray(cones.orders)
        first = np.asarray(cones.first)
        self.dim = cones.dim
        self.r = len(cones.orders)
        self.groups: List[Tuple[int, jnp.ndarray]] = []
        for o in sorted(set(orders.tolist())):
            f = first[orders == o]
            idx = f[:, None] + np.arange(o)[None, :]
            self.groups.append((int(o), jnp.asarray(idx.astype(np.int32))))

    @staticmethod
    def _det(sb: jnp.ndarray) -> jnp.ndarray:
        return sb[:, 0] ** 2 - jnp.sum(sb[:, 1:] ** 2, axis=1)

    @staticmethod
    def _jmul(vb: jnp.ndarray) -> jnp.ndarray:
        """J·v per row, J = diag(1, −1, …, −1)."""
        return jnp.concatenate([vb[:, :1], -vb[:, 1:]], axis=1)

    def min_eig(self, s: jnp.ndarray) -> jnp.ndarray:
        vals = [jnp.min(s[idx][:, 0]
                        - jnp.linalg.norm(s[idx][:, 1:], axis=1))
                for _, idx in self.groups]
        return jnp.min(jnp.stack(vals))

    def grad(self, s: jnp.ndarray) -> jnp.ndarray:
        """∇F(s) = −2·Js/det per cone."""
        g = jnp.zeros_like(s)
        for _, idx in self.groups:
            sb = s[idx]
            det = self._det(sb)
            gb = -2.0 * self._jmul(sb) / det[:, None]
            g = g.at[idx].set(gb)
        return g

    def duality(self, s: jnp.ndarray, z: jnp.ndarray) -> jnp.ndarray:
        return s @ z / self.r

    def hinv_vals(self, s: jnp.ndarray) -> jnp.ndarray:
        """Flattened per-cone blocks of (∇²F(s))⁻¹ = ssᵀ − (det/2)·J, in
        group-major order (matches the dynamic-slot layout)."""
        outs = []
        for o, idx in self.groups:
            sb = s[idx]
            det = self._det(sb)
            blocks = jnp.einsum("ci,cj->cij", sb, sb)
            jdiag = jnp.concatenate(
                [jnp.ones((1,), s.dtype), -jnp.ones((o - 1,), s.dtype)])
            blocks = blocks - 0.5 * det[:, None, None] * jnp.diag(jdiag)[None]
            outs.append(blocks.reshape(-1))
        return jnp.concatenate(outs)

    def hinv_apply(self, s: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
        """(∇²F(s))⁻¹·v = s(sᵀv) − (det/2)·Jv per cone."""
        out = jnp.zeros_like(v)
        for _, idx in self.groups:
            sb, vb = s[idx], v[idx]
            det = self._det(sb)
            dot = jnp.sum(sb * vb, axis=1)
            ob = sb * dot[:, None] - 0.5 * det[:, None] * self._jmul(vb)
            out = out.at[idx].set(ob)
        return out

    def hess_vals(self, z: jnp.ndarray) -> jnp.ndarray:
        """Flattened per-cone blocks of ∇²F(z) = (4/det²)(Jz)(Jz)ᵀ −
        (2/det)J, group-major (matches the dynamic-slot layout)."""
        outs = []
        for o, idx in self.groups:
            zb = z[idx]
            det = self._det(zb)
            jz = self._jmul(zb)
            blocks = (4.0 / det[:, None, None] ** 2) \
                * jnp.einsum("ci,cj->cij", jz, jz)
            jdiag = jnp.concatenate(
                [jnp.ones((1,), z.dtype), -jnp.ones((o - 1,), z.dtype)])
            blocks = blocks - (2.0 / det[:, None, None]) \
                * jnp.diag(jdiag)[None]
            outs.append(blocks.reshape(-1))
        return jnp.concatenate(outs)

    def hess_apply(self, z: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
        """∇²F(z)·v = (4/det²)(Jz)((Jz)ᵀv) − (2/det)Jv per cone."""
        out = jnp.zeros_like(v)
        for _, idx in self.groups:
            zb, vb = z[idx], v[idx]
            det = self._det(zb)
            jz = self._jmul(zb)
            dot = jnp.sum(jz * vb, axis=1)
            ob = (4.0 / det[:, None] ** 2) * jz * dot[:, None] \
                - (2.0 / det[:, None]) * self._jmul(vb)
            out = out.at[idx].set(ob)
        return out

    # -- Jordan/NT-scaling atoms (jit-safe, order-grouped) ----------------

    def jprod(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Jordan product a∘b per cone (device ``SOCApply``)."""
        out = jnp.zeros_like(a)
        for _, idx in self.groups:
            ab, bb = a[idx], b[idx]
            head = jnp.sum(ab * bb, axis=1, keepdims=True)
            tail = ab[:, :1] * bb[:, 1:] + bb[:, :1] * ab[:, 1:]
            out = out.at[idx].set(jnp.concatenate([head, tail], axis=1))
        return out

    def jsqrt(self, a: jnp.ndarray) -> jnp.ndarray:
        """Jordan square root: √a = (a + √det(a)·e)/√(2(a₀ + √det(a)))."""
        out = jnp.zeros_like(a)
        for o, idx in self.groups:
            ab = a[idx]
            rd = jnp.sqrt(jnp.maximum(self._det(ab), 0.0))
            denom = jnp.sqrt(jnp.maximum(2.0 * (ab[:, 0] + rd), 1e-30))
            head = (ab[:, :1] + rd[:, None]) / denom[:, None]
            tail = ab[:, 1:] / denom[:, None]
            out = out.at[idx].set(jnp.concatenate([head, tail], axis=1))
        return out

    def jinv(self, a: jnp.ndarray) -> jnp.ndarray:
        """Jordan inverse a⁻¹ = J·a / det(a) per cone."""
        out = jnp.zeros_like(a)
        for _, idx in self.groups:
            ab = a[idx]
            det = self._det(ab)
            out = out.at[idx].set(self._jmul(ab) / det[:, None])
        return out

    def qrep_apply(self, u: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
        """Q_u·v = 2u(uᵀv) − det(u)·Jv per cone (quadratic rep)."""
        out = jnp.zeros_like(v)
        for _, idx in self.groups:
            ub, vb = u[idx], v[idx]
            det = self._det(ub)
            dot = jnp.sum(ub * vb, axis=1)
            ob = 2.0 * ub * dot[:, None] - det[:, None] * self._jmul(vb)
            out = out.at[idx].set(ob)
        return out

    def qrep_vals(self, u: jnp.ndarray) -> jnp.ndarray:
        """Flattened per-cone blocks of Q_u = 2uuᵀ − det(u)·J, group-major
        (matches the dynamic-slot layout)."""
        outs = []
        for o, idx in self.groups:
            ub = u[idx]
            det = self._det(ub)
            blocks = 2.0 * jnp.einsum("ci,cj->cij", ub, ub)
            jdiag = jnp.concatenate(
                [jnp.ones((1,), u.dtype), -jnp.ones((o - 1,), u.dtype)])
            blocks = blocks - det[:, None, None] * jnp.diag(jdiag)[None]
            outs.append(blocks.reshape(-1))
        return jnp.concatenate(outs)

    def arrow_solve(self, lam: jnp.ndarray, q: jnp.ndarray) -> jnp.ndarray:
        """u with λ∘u = q per cone: u₀ = (λ₀q₀ − λ̄ᵀq̄)/det(λ),
        ū = (q̄ − u₀λ̄)/λ₀."""
        out = jnp.zeros_like(q)
        for _, idx in self.groups:
            lb, qb = lam[idx], q[idx]
            det = self._det(lb)
            u0 = (lb[:, 0] * qb[:, 0]
                  - jnp.sum(lb[:, 1:] * qb[:, 1:], axis=1)) / det
            ut = (qb[:, 1:] - u0[:, None] * lb[:, 1:]) / lb[:, :1]
            out = out.at[idx].set(
                jnp.concatenate([u0[:, None], ut], axis=1))
        return out

    def nt_scaling(self, s: jnp.ndarray, z: jnp.ndarray):
        """Nesterov–Todd scaling point per cone: w = η·w̄ with
        w̄ = (s̃ + Jz̃)/√(2(1 + s̃ᵀz̃)), s̃ = s/√det(s), z̃ = z/√det(z),
        η = (det(s)/det(z))^¼ — the unique w with Q_w z = s.  Returns
        (w, w^½, w^{−½}, λ = Q_{w^½} z)."""
        w = jnp.zeros_like(s)
        for _, idx in self.groups:
            sb, zb = s[idx], z[idx]
            sd = jnp.sqrt(jnp.maximum(self._det(sb), 1e-30))
            zd = jnp.sqrt(jnp.maximum(self._det(zb), 1e-30))
            st = sb / sd[:, None]
            zt = zb / zd[:, None]
            dot = jnp.sum(st * zt, axis=1)
            denom = jnp.sqrt(jnp.maximum(2.0 * (1.0 + dot), 1e-30))
            wb = (st + self._jmul(zt)) / denom[:, None]
            eta = (sd / zd) ** 0.5
            w = w.at[idx].set(eta[:, None] * wb)
        wh = self.jsqrt(w)
        whi = self.jinv(wh)
        lam = self.qrep_apply(wh, z)
        return w, wh, whi, lam

    def dyn_indices(self, offset: int) -> Tuple[np.ndarray, np.ndarray]:
        """(rows, cols) of the per-cone dense blocks, group-major, shifted
        by ``offset`` — the dynamic-slot pattern for :class:`KKTBuilder`."""
        rows, cols = [], []
        for o, idx in self.groups:
            gi = np.asarray(idx) + offset
            rows.append(np.broadcast_to(gi[:, :, None],
                                        (gi.shape[0], o, o)).reshape(-1))
            cols.append(np.broadcast_to(gi[:, None, :],
                                        (gi.shape[0], o, o)).reshape(-1))
        return np.concatenate(rows), np.concatenate(cols)

    def max_step(self, s: jnp.ndarray, ds: jnp.ndarray,
                 tau: float) -> jnp.ndarray:
        """min(1, τ·α*) with α* = sup{α : s + α·ds ∈ K}, ANALYTIC.

        Exit happens where det(s+αds) = 0: with a = det(ds),
        b = s₀d₀ − s̄ᵀd̄, c = det(s) > 0 the quadratic aα² + 2bα + c has
        its smallest positive root α* = c/(−b + √(b²−ac)), existing iff
        a < 0 or (b < 0 and b² ≥ ac); otherwise the ray stays in the
        cone.  (A bisection that returns EXACTLY 1.0 for in-cone full
        steps lets an iterate land on the boundary, after which every
        subsequent bisection returns 0: a permanent stall on the RLS
        driver.  τ always margins the boundary.)"""
        alpha = jnp.full((), np.inf, s.dtype)
        for _, idx in self.groups:
            sb, db = s[idx], ds[idx]
            a = self._det(db)
            b = sb[:, 0] * db[:, 0] - jnp.sum(sb[:, 1:] * db[:, 1:],
                                              axis=1)
            c = self._det(sb)
            disc = b * b - a * c
            sqd = jnp.sqrt(jnp.maximum(disc, 0.0))
            exists = (a < 0) | ((b < 0) & (disc >= 0))
            denom = -b + sqd
            root = c / jnp.where(denom > 0, denom, 1.0)
            cand = jnp.where(exists & (denom > 0), root, np.inf)
            alpha = jnp.minimum(alpha, jnp.min(cand))
        return jnp.minimum(1.0, tau * alpha)


def _coneops_flatten(o):
    from ..core.statics import _aux_of
    return [idx for _, idx in o.groups], _aux_of(o)


def _coneops_unflatten(aux, leaves):
    src = aux.value
    new = object.__new__(ConeOps)
    new.__dict__.update(src.__dict__)
    new.groups = [(o, idx) for (o, _), idx in zip(src.groups, leaves)]
    new.__dict__["_aux"] = aux
    return new


# pytree: the cone index groups ride through jit as ARGUMENTS (see
# core/statics.py)
jax.tree_util.register_pytree_node(ConeOps, _coneops_flatten,
                                   _coneops_unflatten)


@dataclasses.dataclass
class SOCPResult:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    s: np.ndarray
    objective: float
    iterations: int
    converged: bool


def socp_affine(A, b: np.ndarray, G, h: np.ndarray, c: np.ndarray,
                cones: Cones, ctrl: Optional[LPCtrl] = None) -> SOCPResult:
    """min cᵀx s.t. Ax = b, Gx + s = h, s ∈ K (reference ``SOCPAffine``)."""
    ctrl = ctrl or LPCtrl()
    if not isinstance(A, SparseMatrix):
        A = SparseMatrix.from_dense(np.asarray(A))
    if not isinstance(G, SparseMatrix):
        G = SparseMatrix.from_dense(np.asarray(G))
    m, n = A.shape
    if n == 0:
        n = c.shape[0]
    k = cones.dim
    N = n + m + k
    from .lp import _resolve_numerics, _resolve_refine
    gamma, _tol_eff = _resolve_numerics(ctrl)
    delta = gamma
    ops = ConeOps(cones)

    kb = KKTBuilder(N)
    if A.nnz:
        arows = np.repeat(np.arange(m), A.row_nnz()) + n
        kb.add_static(arows, A.colind, A.vals)
        kb.add_static(A.colind, arows, A.vals)
    grows = np.repeat(np.arange(k), G.row_nnz()) + n + m
    kb.add_static(grows, G.colind, G.vals)
    kb.add_static(G.colind, grows, G.vals)
    kb.add_static(np.arange(n), np.arange(n), np.full(n, gamma))
    if m:
        kb.add_static(np.arange(n, n + m), np.arange(n, n + m),
                      np.full(m, -delta))
    kb.add_static(np.arange(n + m, N), np.arange(n + m, N),
                  np.full(k, -delta))
    drows, dcols = ops.dyn_indices(n + m)
    kb.add_dynamic(drows, dcols)  # −σμ∇²F(z) cone blocks
    kkt = kb.finalize(perm=ctrl.ordering)
    reg_diag = jnp.concatenate([jnp.full(n, gamma), jnp.full(m, -delta),
                                jnp.full(k, -delta)])


    Ad, Atd = A.device_csr(), A.transpose().device_csr()
    Gd, Gtd = G.device_csr(), G.transpose().device_csr()
    bj, hj, cj = jnp.asarray(b), jnp.asarray(h), jnp.asarray(c)
    tau, tol = ctrl.tau, _tol_eff
    nref = _resolve_refine(ctrl)
    unroll = ctrl.refine_unroll

    ident = jnp.asarray(soc_identity(cones))

    @jax.jit
    def step(x, y, s, z, kkt, reg_diag, ops, Ad, Atd, Gd, Gtd, bj, hj, cj):
        """Nesterov–Todd-scaled Mehrotra predictor-corrector (the
        reference's Mehrotra SOCP, SURVEY §3.6; NT per Alizadeh–Goldfarb).

        A dual-HKM linearization (block −σμ∇²F(z), fixed σ) STALLS on
        genuine SOC instances: nothing recenters the primal slack, s hits
        the cone boundary and the fraction-to-boundary collapses to 0
        permanently (RLS driver, x64).  NT scaling is symmetric — λ = W z = W⁻ᵀs — so both sides
        stay centered; the KKT (3,3) block is −Q_w (same fixed pattern),
        and the scaled complementarity gives
            ds = W(v − W dz),  v = λ⁻¹∘(target − λ∘λ − corrector)."""
        rb = bj - Ad.matvec(x)
        rh = hj - Gd.matvec(x) - s
        rc = -(cj + Atd.matvec(y) + Gtd.matvec(z))
        mu = ops.duality(s, z)
        gap = s @ z
        pobj = cj @ x
        w, wh, whi, lam = ops.nt_scaling(s, z)
        fact = kkt.prepare(kkt.assemble([-ops.qrep_vals(w)]))

        def directions(target):
            v = ops.arrow_solve(lam, target - ops.jprod(lam, lam))
            wv = ops.qrep_apply(wh, v)
            rhs = jnp.concatenate([rc, rb, rh - wv])
            sol = fact.solve_refined(rhs, reg_diag, iters=nref,
                                     unroll=unroll)
            dx, dy, dz = sol[:n], sol[n:n + m], sol[n + m:]
            ds = wv - ops.qrep_apply(w, dz)
            return dx, dy, dz, ds

        # predictor (affine): target 0
        dxa, dya, dza, dsa = directions(jnp.zeros_like(s))
        ap = ops.max_step(s, dsa, 1.0)
        ad = ops.max_step(z, dza, 1.0)
        aa = jnp.minimum(ap, ad)
        mu_aff = ((s + aa * dsa) @ (z + aa * dza)) / ops.r
        sigma_m = jnp.clip(jnp.where(mu > 0, (mu_aff / mu) ** 3, 0.0),
                           0.0, 1.0)
        # corrector: σμe − (W⁻ᵀdsₐ)∘(W dzₐ)
        corr = ops.jprod(ops.qrep_apply(whi, dsa),
                         ops.qrep_apply(wh, dza))
        dx, dy, dz, ds = directions(sigma_m * mu * ident - corr)
        alpha = jnp.minimum(ops.max_step(s, ds, tau),
                            ops.max_step(z, dz, tau))
        xn, yn = x + alpha * dx, y + alpha * dy
        sn, zn = s + alpha * ds, z + alpha * dz
        # finiteness of the NEW iterate (the residuals are of the input)
        ok = (jnp.all(jnp.isfinite(xn)) & jnp.all(jnp.isfinite(yn))
              & jnp.all(jnp.isfinite(sn)) & jnp.all(jnp.isfinite(zn)))
        return (xn, yn, sn, zn,
                jnp.linalg.norm(rb), jnp.linalg.norm(rh),
                jnp.linalg.norm(rc), gap, pobj, ok)

    e = jnp.asarray(soc_identity(cones))
    x = jnp.zeros(n, e.dtype)
    s = e
    z = e
    y = jnp.zeros(m, e.dtype)

    bn = 1 + float(np.linalg.norm(b))
    hn = 1 + float(np.linalg.norm(h))
    cn = 1 + float(np.linalg.norm(c))
    it = 0
    converged = False
    for it in range(1, ctrl.max_iters + 1):
        xp, yp, sp, zp = x, y, s, z
        x, y, s, z, rbn, rhn, rcn, gap, pobj, ok = step(
            x, y, s, z, kkt, reg_diag, ops, Ad, Atd, Gd, Gtd, bj, hj, cj)
        if not bool(ok) or not np.isfinite(float(rbn) + float(rcn)
                                           + float(gap)):
            x, y, s, z = xp, yp, sp, zp
            break
        if (float(rbn) < tol * bn and float(rhn) < tol * hn
                and float(rcn) < tol * cn
                and float(gap) < tol * (1 + abs(float(pobj)))):
            x, y, s, z = xp, yp, sp, zp
            converged = True
            break
        if ctrl.verbose:
            print(f"  it {it}: gap={float(gap):.3e} obj={float(pobj):.8g}")

    x, y, s, z = (np.asarray(v) for v in (x, y, s, z))
    return SOCPResult(x, y, z, s, float(c @ x), it, converged)
