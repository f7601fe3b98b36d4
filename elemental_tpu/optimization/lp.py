"""Interior-point linear programming (reference MISSING tier: spec from
``examples/interface/LPDirect.py:70-115`` — ``LPDirectCtrl`` with approach ∈
{LP_MEHROTRA, LP_IPF} — and the netlib MPS data it ships).

Forms (reference naming):
  * direct:  min cᵀx  s.t.  A·x = b,  x ≥ 0
  * affine:  min cᵀx  s.t.  A·x = b,  G·x + s = h,  s ≥ 0

Device-resident hot loop (SURVEY §3.6): the regularized quasi-definite
augmented KKT is assembled ONCE as a fixed sparse pattern
(:class:`..optimization.kkt.KKTBuilder`); each iteration is one jitted
device program — scatter the barrier diagonal Θ = z/x into the value
vector (the reference's ``ChangeNonzeroValues``,
``DistSparseLDLFactorization.cpp:149``), re-factor with the level-batched
multifrontal ``RegularizedLDL``, refined predictor/corrector solves,
fraction-to-boundary steps.  No densification and no host linear algebra
anywhere in the loop.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..sparse.csr import SparseMatrix
from ..sparse.io import MPSData
from .kkt import KKTBuilder, KKTSystem


def _resolve_numerics(ctrl):
    """Working-dtype-aware (reg, tol): the f64-era defaults (γ=δ=1e-9,
    tol=1e-8) are BELOW f32 resolution — without x64 they produce
    pivot blowups (NaN at the first iteration) and an
    unreachable stopping test.  Under f32 the regularization floor is
    ~√eps·0.1 and the tolerance floor ~50·eps (core/policy philosophy);
    under x64 the classical values pass through unchanged.

    When the caller's tolerance is clamped, a warning is emitted and the
    effective value is reported back via ``LPResult.tol_effective`` —
    ``converged`` always refers to the EFFECTIVE tolerance."""
    from ..core.policy import default_real_dtype
    eps = float(jnp.finfo(default_real_dtype()).eps)
    reg = ctrl.reg
    if reg is None:
        # f32: γ must ABSORB the pivot-free quasi-definite element growth.
        # On ConcatFD2D (Ruiz-equilibrated, θ=1) the element growth is
        # max|L| ≈ 2.7/γ and the factored-solve residual ≈ eps·growth², so
        # γ=0.1·√eps leaves an O(1)-error factor while γ ≈ 1e-2 leaves a
        # preconditioner FGMRES converges with.  FGMRES solves against the
        # UNregularized KKT, so a large γ costs only preconditioner
        # sharpness — √eps·30 ≈ 1e-2 is the knee.
        reg = 1e-9 if eps < 1e-10 else 30.0 * float(np.sqrt(eps))
    # f32 tolerance floor: with the γ above, FGMRES directions reach
    # ~1e-6 relative and the f32 matvec residual floor is ~eps·‖A‖‖x‖ ≈
    # 1e-7·scale — 50·eps (≈6e-6) is attainable
    tol = max(ctrl.tol, 50.0 * eps)
    if tol > ctrl.tol:
        import warnings
        warnings.warn(
            f"LP tolerance {ctrl.tol:g} is below the working-precision "
            f"floor; clamped to {tol:g} (eps={eps:g}).  LPResult.converged "
            f"refers to the clamped tolerance (LPResult.tol_effective); "
            f"enable x64 or use the DD-refined path for tighter targets.",
            stacklevel=3)
    return reg, tol


def _resolve_refine(ctrl) -> int:
    """Dtype-aware FGMRES depth (see LPCtrl.refine_iters)."""
    if ctrl.refine_iters is not None:
        return int(ctrl.refine_iters)
    from ..core.policy import default_real_dtype
    eps = float(jnp.finfo(default_real_dtype()).eps)
    return 8 if eps < 1e-10 else 16


class Approach:
    MEHROTRA = "mehrotra"
    IPF = "ipf"


# Above this KKT size the fused per-step jit is replaced by a
# python-orchestrated step with ONE compiled factor + ONE compiled
# refined-solve (see the ``large`` branch in :func:`lp_direct`): each
# multifrontal-solve instance embedded in a jit adds its whole level loop to
# the compile at scale — and only the python path can RESTART the
# refined solve adaptively (essential in f32; see ``ksolve_py``).
LARGE_FUSED_N = 4096


@dataclasses.dataclass
class LPCtrl:
    """Reference ``LPDirectCtrl`` analog."""
    approach: str = Approach.MEHROTRA
    max_iters: int = 100
    tol: float = 1e-8
    tau: float = 0.995          # fraction-to-boundary
    sigma_ipf: float = 0.3      # centering for IPF
    backend: str = "auto"       # kept for API parity; the path is sparse
    reg: 'Optional[float]' = None   # None: dtype-aware (1e-9 f64, ~1e-2 f32)
    refine_iters: 'Optional[int]' = None  # FGMRES steps vs the exact KKT
                                # None: 8 under x64, 16 under f32 (the f32
                                # factor is a γ≈1e-2-regularized
                                # preconditioner: 16 steps converge
                                # n1=64 where 8 stall at 7e-5)
    refine_unroll: bool = False  # straight-line FGMRES (small systems)
    verbose: bool = False
    ordering: Optional[np.ndarray] = None  # precomputed KKT fill ordering


@dataclasses.dataclass
class LPResult:
    x: np.ndarray
    y: np.ndarray
    z: np.ndarray
    objective: float
    iterations: int
    converged: bool                 # w.r.t. tol_effective, NOT ctrl.tol
    s: Optional[np.ndarray] = None  # affine-form slack
    tol_effective: Optional[float] = None  # the tolerance actually tested
    metric: Optional[float] = None  # achieved max(rb/‖b‖, rc/‖c‖, gap)
    iter_seconds: Optional[List[float]] = None  # wall time of each iteration


def sparse_ruiz(A: SparseMatrix, iters: int = 10
                ) -> Tuple[SparseMatrix, np.ndarray, np.ndarray]:
    """Ruiz equilibration on the CSR arrays (reference ``equilibrate/Ruiz``;
    never densifies): returns (Â, r, s) with Â = R⁻¹·A·S⁻¹."""
    m, n = A.shape
    rows = np.repeat(np.arange(m), A.row_nnz())
    cols = A.colind
    v = A.vals.astype(np.float64).copy()
    r = np.ones(m)
    s = np.ones(n)
    for _ in range(iters):
        rowmax = np.zeros(m)
        np.maximum.at(rowmax, rows, np.abs(v))
        rr = np.where(rowmax > 0, np.sqrt(rowmax), 1.0)
        v /= rr[rows]
        r *= rr
        colmax = np.zeros(n)
        np.maximum.at(colmax, cols, np.abs(v))
        ss = np.where(colmax > 0, np.sqrt(colmax), 1.0)
        v /= ss[cols]
        s *= ss
    return A.change_nonzero_values(v), r, s


def _steplen(v: np.ndarray, dv: np.ndarray, tau: float) -> float:
    neg = dv < 0
    if not neg.any():
        return 1.0
    return float(min(1.0, tau * np.min(-v[neg] / dv[neg])))


def _steplen_j(v: jnp.ndarray, dv: jnp.ndarray, tau: float) -> jnp.ndarray:
    """Fraction-to-boundary step length (jit-safe)."""
    ratios = jnp.where(dv < 0, -v / jnp.where(dv < 0, dv, -1.0), jnp.inf)
    return jnp.minimum(1.0, tau * jnp.min(ratios))


def _build_lp_kkt(A: SparseMatrix, gamma: float, delta: float,
                  ordering: Optional[np.ndarray]) -> Tuple[KKTSystem, int]:
    """Fixed-pattern K = [[Θ+γI, Aᵀ],[A, −δI]] with Θ the dynamic slot 0.
    Solving K[p;q]=[f;g] yields dx=p, dy=−q for the unsymmetric Newton rows
    Θ·dx − Aᵀ·dy = f, A·dx = g (quasi-definite ⇒ pivot-free LDL is stable)."""
    m, n = A.shape
    N = n + m
    kb = KKTBuilder(N)
    arows = np.repeat(np.arange(m), A.row_nnz()) + n
    kb.add_static(arows, A.colind, A.vals)
    kb.add_static(A.colind, arows, A.vals)
    kb.add_static(np.arange(n), np.arange(n), np.full(n, gamma))
    kb.add_static(np.arange(n, N), np.arange(n, N), np.full(m, -delta))
    slot = kb.add_dynamic(np.arange(n), np.arange(n))
    return kb.finalize(perm=ordering), slot


def lp_direct(A: SparseMatrix, b: np.ndarray, c: np.ndarray,
              ctrl: Optional[LPCtrl] = None) -> LPResult:
    """Solve min cᵀx s.t. Ax = b, x ≥ 0 (reference ``LPDirect``)."""
    ctrl = ctrl or LPCtrl()
    m, n = A.shape
    A, r, s = sparse_ruiz(A)
    b = b / r
    c = c / s

    gamma, tol = _resolve_numerics(ctrl)
    delta = gamma
    kkt, _ = _build_lp_kkt(A, gamma, delta, ctrl.ordering)
    reg_diag = jnp.concatenate([jnp.full(n, gamma), jnp.full(m, -delta)])

    Ad = A.device_csr()
    Atd = A.transpose().device_csr()
    bj, cj = jnp.asarray(b), jnp.asarray(c)
    bnorm = float(np.linalg.norm(b)) + 1.0
    cnorm = float(np.linalg.norm(c)) + 1.0
    tau = ctrl.tau
    nref = _resolve_refine(ctrl)

    # Dynamic pivot regularization (reference RegularizedLDL) at HALF the
    # static regularization.  This KKT is quasi-definite, so in exact
    # arithmetic, under any symmetric ordering, every pivot is ≥ γ on a
    # primal row and ≤ −δ on a dual row (a pivot is the reciprocal of a
    # diagonal entry of a quasi-definite submatrix's inverse).  A
    # computed pivot of magnitude below half that bound is therefore
    # rounding damage, and only such pivots are boosted; pivots at ±γ
    # stay untouched (boosting those makes the factored solve worse).
    pivot_floor = 0.5 * reg_diag

    # device containers (kkt, Ad, Atd) and data vectors are passed to the
    # jitted start/step as ARGUMENTS — closing over them would embed the
    # index arrays as jaxpr constants (core/statics.py)
    def kfactor(kkt, theta):
        return kkt.prepare(kkt.assemble([theta]), pivot_floor=pivot_floor)

    unroll = ctrl.refine_unroll

    def ksolve(fact, reg_diag, f, g):
        sol = fact.solve_refined(jnp.concatenate([f, g]), reg_diag,
                                 iters=nref, unroll=unroll)
        return sol[:n], sol[n:]

    @jax.jit
    def start(kkt, reg_diag, bj, cj):
        """Mehrotra starting point from the Θ=I system: min-norm Ax=b
        iterate and dual least squares, shifted into the orthant."""
        fact = kfactor(kkt, jnp.ones(n, bj.dtype))
        x_t, _ = ksolve(fact, reg_diag, jnp.zeros(n, bj.dtype), bj)
        z_t, yq = ksolve(fact, reg_diag, cj, jnp.zeros(m, bj.dtype))
        y = yq
        dx = jnp.maximum(-1.5 * jnp.min(x_t), 0.0)
        dz = jnp.maximum(-1.5 * jnp.min(z_t), 0.0)
        x_h = x_t + dx + 1e-10
        z_h = z_t + dz + 1e-10
        xs = x_h @ z_h
        x = x_h + 0.5 * xs / jnp.maximum(jnp.sum(z_h), 1e-10)
        z = z_h + 0.5 * xs / jnp.maximum(jnp.sum(x_h), 1e-10)
        return jnp.maximum(x, 1e-8), y, jnp.maximum(z, 1e-8)

    mehrotra = ctrl.approach == Approach.MEHROTRA
    sigma_ipf = ctrl.sigma_ipf

    # At scale, one fused step-jit would embed 2 multifrontal-solve
    # instances (plus 2 in start), each adding its level loop to the
    # compile.  The large path orchestrates the SAME math from python with
    # exactly one compiled factor and one compiled refined-solve, reused
    # for every solve of every iteration.
    large = kkt.N > LARGE_FUSED_N

    @jax.jit
    def step(x, y, z, kkt, reg_diag, Ad, Atd, bj, cj, nb):
        rb = bj - Ad.matvec(x)
        rc = cj - Atd.matvec(y) - z
        mu = x @ z / n
        gap = jnp.abs(cj @ x - bj @ y) / (1 + jnp.abs(cj @ x))
        theta = z / x
        fact = kfactor(kkt, theta)

        def directions(rmu):
            p, q = ksolve(fact, reg_diag, rmu / x - rc, rb)
            dx, dy = p, -q
            dz = rc - Atd.matvec(dy)
            return dx, dy, dz

        if mehrotra:
            dxa, _, dza = directions(-x * z)
            ap = _steplen_j(x, dxa, 1.0)
            ad = _steplen_j(z, dza, 1.0)
            mu_aff = (x + ap * dxa) @ (z + ad * dza) / n
            sigma = jnp.where(mu > 0, (mu_aff / mu) ** 3, 0.0)
            dx, dy, dz = directions(sigma * mu - x * z - dxa * dza)
        else:
            dx, dy, dz = directions(sigma_ipf * mu - x * z)

        ap = _steplen_j(x, dx, tau)
        ad = _steplen_j(z, dz, tau)
        # infeasible-IPM neighborhood safeguard: keep μ₊ coupled to ‖rb₊‖,
        # SCALE-FREE via nb = μ₀/‖rb₀‖ (r4 fix: the bare 1e-5 constant
        # compared an absolute μ to a relative residual and at larger
        # scales backed every step off to ~0.7⁴⁰ — a permanent stall)
        rbn = jnp.linalg.norm(rb) / bnorm

        def cond(carry):
            ap_c, ad_c, i = carry
            xn = x + ap_c * dx
            zn = z + ad_c * dz
            mun = xn @ zn / n
            rbn_new = jnp.linalg.norm(bj - Ad.matvec(xn)) / bnorm
            return ((i < 12) & (rbn > 10 * tol)
                    & (mun < 1e-5 * nb * rbn_new) & (rbn_new > 10 * tol))

        def backoff(carry):
            ap_c, ad_c, i = carry
            return ap_c * 0.7, ad_c * 0.7, i + 1

        ap, ad, _ = jax.lax.while_loop(cond, backoff, (ap, ad, 0))
        xn, yn, zn = x + ap * dx, y + ad * dy, z + ad * dz
        # finiteness of the NEW iterate: a NaN step must be caught in the
        # iteration that produced it (the residual norms below belong to the
        # INPUT iterate and stay finite one step too long).
        ok = (jnp.all(jnp.isfinite(xn)) & jnp.all(jnp.isfinite(yn))
              & jnp.all(jnp.isfinite(zn)))
        return (xn, yn, zn,
                jnp.linalg.norm(rb), jnp.linalg.norm(rc), gap, ok)

    if large:
        @jax.jit
        def jfactor(kkt, theta):
            fact = kkt.prepare(kkt.assemble([theta]),
                               pivot_floor=pivot_floor)
            # panel inverses once per FACTOR, not once per FGMRES sweep
            # (up to 12 sweeps/iteration)
            return fact, fact.solve_context()

        @jax.jit
        def jrefined(fact, reg_diag, rhs, ctx):
            return fact.solve_refined(rhs, reg_diag, iters=nref,
                                      unroll=False, ctx=ctx)

        @jax.jit
        def jresid(fact, reg_diag, rhs, sol):
            kx = fact.sys.matvec(fact.vals, sol) - reg_diag * sol
            return rhs - kx, jnp.linalg.norm(rhs - kx)

        def ksolve_py(fact_ctx, f, g):
            """Restarted FGMRES(nref): a single sweep can plateau at
            ~5e-2 relative early in the f32 IPM (at n=10⁵ the
            resulting O(‖rhs‖·5e-2) noise in dx clips every
            fraction-to-boundary step to ~1% — a permanent stall);
            restarting on the true residual squares the contraction per
            sweep at one extra tree-solve sweep each."""
            fact, ctx = fact_ctx
            rhs = jnp.concatenate([f, g])
            sol = jrefined(fact, reg_diag, rhs, ctx)
            rn0 = float(jnp.linalg.norm(rhs))
            for _ in range(5):
                r, rn = jresid(fact, reg_diag, rhs, sol)
                # 1e-6: near convergence the rhs (rmu/x − rc) carries
                # huge entries while the binding components of x are
                # ~μ-small — direction error 1e-4·‖rhs‖ swamps them and
                # the fraction-to-boundary collapses (the gap plateaus at
                # exactly the restart target's level)
                if float(rn) <= 1e-6 * rn0 or not np.isfinite(float(rn)):
                    break
                sol = sol + jrefined(fact, reg_diag, r, ctx)
            return sol[:n], sol[n:]

        @jax.jit
        def jstart_shift(x_t, z_t, y):
            dx = jnp.maximum(-1.5 * jnp.min(x_t), 0.0)
            dz = jnp.maximum(-1.5 * jnp.min(z_t), 0.0)
            x_h = x_t + dx + 1e-10
            z_h = z_t + dz + 1e-10
            xs = x_h @ z_h
            x = x_h + 0.5 * xs / jnp.maximum(jnp.sum(z_h), 1e-10)
            z = z_h + 0.5 * xs / jnp.maximum(jnp.sum(x_h), 1e-10)
            return jnp.maximum(x, 1e-8), y, jnp.maximum(z, 1e-8)

        # Compensated residual/gap evaluation (reference QD-tier role):
        # plain f32 rb/rc carry eps·‖A‖‖x‖-level EVALUATION noise that the
        # direction solves then chase (at n=10⁵ in f32, with accurate
        # directions the gap still floors at ~3e-5).  Per-row TwoProd/TwoSum chains
        # over the padded ELL rows evaluate b−Ax and c−Aᵀy−z to ~eps²;
        # rounding the RESULT to f32 is then accurate relative to its
        # own (tiny) value.  The gap uses extended.dd_dot for the same
        # reason (√n·eps ≈ 4e-5 f32 dot noise at n=10⁵).
        _ea = A.device_ell()
        _eat = A.transpose().device_ell()

        def _dd_minus_spmv(acc, cols, vals, x):
            """(hi, lo) of acc − A·x via compensated per-row chains."""
            from ..extended import two_prod, two_sum
            xg = x[cols]                       # (m, k) gather, k ≤ ~8
            hi = acc
            lo = jnp.zeros_like(acc)
            for j in range(cols.shape[1]):
                p, e = two_prod(vals[:, j], xg[:, j])
                hi, e2 = two_sum(hi, -p)
                lo = lo - e + e2
            return hi, lo

        @jax.jit
        def jpre(x, y, z, bj, cj, ca, va, cat, vat):
            from ..extended import dd_add, dd_dot, dd_neg, two_sum
            hi, lo = _dd_minus_spmv(bj, ca, va, x)
            rb = hi + lo
            hi, lo = _dd_minus_spmv(cj, cat, vat, y)
            hi, e2 = two_sum(hi, -z)
            rc = hi + (lo + e2)
            mu = x @ z / n
            cx = dd_dot(cj, x)
            by = dd_dot(bj, y)
            diff = dd_add(cx, dd_neg(by))
            gap = jnp.abs(diff.hi + diff.lo) / (1 + jnp.abs(cx.hi))
            return rb, rc, mu, gap, z / x

        @jax.jit
        def jpred(x, z, mu, p, q, rc, Atd):
            dxa, dya = p, -q
            dza = rc - Atd.matvec(dya)
            ap = _steplen_j(x, dxa, 1.0)
            ad = _steplen_j(z, dza, 1.0)
            mu_aff = (x + ap * dxa) @ (z + ad * dza) / n
            sigma = jnp.where(mu > 0, (mu_aff / mu) ** 3, 0.0)
            return sigma * mu - x * z - dxa * dza

        @jax.jit
        def jpost(x, y, z, p, q, rb, rc, gap, Ad, Atd, bj, nb):
            dx, dy = p, -q
            dz = rc - Atd.matvec(dy)
            ap = _steplen_j(x, dx, tau)
            ad = _steplen_j(z, dz, tau)
            rbn = jnp.linalg.norm(rb) / bnorm

            def cond(carry):
                ap_c, ad_c, i = carry
                xn = x + ap_c * dx
                zn = z + ad_c * dz
                mun = xn @ zn / n
                rbn_new = jnp.linalg.norm(bj - Ad.matvec(xn)) / bnorm
                return ((i < 12) & (rbn > 10 * tol)
                        & (mun < 1e-5 * nb * rbn_new)
                        & (rbn_new > 10 * tol))

            def backoff(carry):
                ap_c, ad_c, i = carry
                return ap_c * 0.7, ad_c * 0.7, i + 1

            ap, ad, _ = jax.lax.while_loop(cond, backoff, (ap, ad, 0))
            xn, yn, zn = x + ap * dx, y + ad * dy, z + ad * dz
            ok = (jnp.all(jnp.isfinite(xn)) & jnp.all(jnp.isfinite(yn))
                  & jnp.all(jnp.isfinite(zn)))
            return (xn, yn, zn,
                    jnp.linalg.norm(rb), jnp.linalg.norm(rc), gap, ok)

        @jax.jit
        def jaff_f(z, rc):               # predictor rhs: (−x·z)/x − rc
            return -z - rc

        @jax.jit
        def jrhs_f(x, rmu, rc):
            return rmu / x - rc

        @jax.jit
        def jrmu_ipf(x, z, mu):
            return sigma_ipf * mu - x * z

        def start_py():
            fact_ctx = jfactor(kkt, jnp.ones(n, bj.dtype))
            x_t, _ = ksolve_py(fact_ctx, jnp.zeros(n, bj.dtype), bj)
            z_t, yq = ksolve_py(fact_ctx, cj, jnp.zeros(m, bj.dtype))
            return jstart_shift(x_t, z_t, yq)

        def step_py(x, y, z):
            rb, rc, mu, gap, theta = jpre(x, y, z, bj, cj, _ea.cols,
                                          _ea.vals, _eat.cols, _eat.vals)
            fact_ctx = jfactor(kkt, theta)
            if mehrotra:
                p, q = ksolve_py(fact_ctx, jaff_f(z, rc), rb)
                rmu = jpred(x, z, mu, p, q, rc, Atd)
            else:
                rmu = jrmu_ipf(x, z, mu)
            p, q = ksolve_py(fact_ctx, jrhs_f(x, rmu, rc), rb)
            return jpost(x, y, z, p, q, rb, rc, gap, Ad, Atd, bj, nb)

        x, y, z = start_py()
    else:
        x, y, z = start(kkt, reg_diag, bj, cj)
    # neighborhood scale μ₀/‖rb₀‖ for the scale-free backoff safeguard
    mu0 = float(jnp.vdot(x, z)) / n
    rb0n = float(jnp.linalg.norm(bj - Ad.matvec(x))) / bnorm
    nb = jnp.asarray(mu0 / max(rb0n, 1e-30), bj.dtype)
    it = 0
    converged = False
    best_metric, best_xyz = np.inf, None
    iter_seconds = []
    for it in range(1, ctrl.max_iters + 1):
        t_it = time.perf_counter()
        xp, yp, zp = x, y, z
        if large:
            x, y, z, rbn, rcn, gap, ok = step_py(x, y, z)
        else:
            x, y, z, rbn, rcn, gap, ok = step(x, y, z, kkt, reg_diag,
                                              Ad, Atd, bj, cj, nb)
        rbn, rcn, gap = float(rbn), float(rcn), float(gap)
        iter_seconds.append(time.perf_counter() - t_it)
        metric = max(rbn / bnorm, rcn / cnorm, gap)
        if np.isfinite(metric) and metric < best_metric:
            # residuals belong to the PRE-step iterate — track the best
            # (fp32 IPM trajectories degrade after stagnating; on
            # breakdown the best iterate is the answer, not the last)
            best_metric, best_xyz = metric, (xp, yp, zp)
        if np.isfinite(metric) and metric < tol:
            # the residuals belong to the PRE-step iterate: if it meets the
            # tolerance, convergence stands even when the (pointless) step
            # just taken blew up — checked BEFORE the breakdown guard
            x, y, z = xp, yp, zp
            converged = True
            break
        if not bool(ok) or not np.isfinite(rbn + rcn + gap):
            if best_xyz is not None:
                x, y, z = best_xyz
            else:
                x, y, z = xp, yp, zp
            break
        if ctrl.verbose:
            print(f"  it {it}: rb={rbn:.2e} rc={rcn:.2e} gap={gap:.2e}")
    else:
        # max_iters exhausted without convergence or breakdown: the last
        # iterate is unevaluated and fp32 trajectories degrade after
        # stagnating — return the best tracked iterate when it beats the
        # final one (ADVICE r4)
        if best_xyz is not None:
            fin = _lp_metric(Ad, Atd, bj, cj, x, y, z, bnorm, cnorm)
            if not np.isfinite(fin) or best_metric < fin:
                x, y, z = best_xyz

    achieved = _lp_metric(Ad, Atd, bj, cj, jnp.asarray(x), jnp.asarray(y),
                          jnp.asarray(z), bnorm, cnorm)
    x, y, z = np.asarray(x), np.asarray(y), np.asarray(z)
    obj = float(c @ x)  # ĉᵀx̂ = cᵀx: the objective is scaling-invariant
    return LPResult(x / s, y / r, z * s, obj, it, converged,
                    tol_effective=tol, metric=achieved,
                    iter_seconds=iter_seconds)


def _lp_metric(Ad, Atd, bj, cj, x, y, z, bnorm, cnorm) -> float:
    """max(‖b−Ax‖/‖b‖, ‖c−Aᵀy−z‖/‖c‖, relgap) of an iterate (device);
    the gap via double-word dots (see jpre — f32 dot noise ≈ √n·eps)."""
    from ..extended import dd_add, dd_dot, dd_neg
    rb = float(jnp.linalg.norm(bj - Ad.matvec(x)))
    rc = float(jnp.linalg.norm(cj - Atd.matvec(y) - z))
    cx = dd_dot(cj, x)
    by = dd_dot(bj, y)
    diff = dd_add(cx, dd_neg(by))
    gap = float(jnp.abs(diff.hi + diff.lo) / (1 + jnp.abs(cx.hi)))
    return max(rb / bnorm, rc / cnorm, gap)


def lp_affine(A: SparseMatrix, b: np.ndarray, G: SparseMatrix,
              h: np.ndarray, c: np.ndarray,
              ctrl: Optional[LPCtrl] = None) -> LPResult:
    """Solve min cᵀx s.t. Ax = b, Gx + s = h, s ≥ 0 (reference ``LPAffine``)
    via the fixed-pattern regularized quasi-definite KKT
    [[γI, Aᵀ, Gᵀ], [A, −δI, 0], [G, 0, −(W+δ)I]], W = s/z the dynamic slot,
    factored by the multifrontal LDL every iteration (symbolic reused)."""
    ctrl = ctrl or LPCtrl()
    if not isinstance(A, SparseMatrix):
        A = SparseMatrix.from_dense(np.asarray(A))
    if not isinstance(G, SparseMatrix):
        G = SparseMatrix.from_dense(np.asarray(G))
    m, n = A.shape
    k = G.shape[0]
    N = n + m + k
    gamma, _tol_eff = _resolve_numerics(ctrl)
    delta = gamma

    kb = KKTBuilder(N)
    arows = np.repeat(np.arange(m), A.row_nnz()) + n
    grows = np.repeat(np.arange(k), G.row_nnz()) + n + m
    kb.add_static(arows, A.colind, A.vals)
    kb.add_static(A.colind, arows, A.vals)
    kb.add_static(grows, G.colind, G.vals)
    kb.add_static(G.colind, grows, G.vals)
    kb.add_static(np.arange(n), np.arange(n), np.full(n, gamma))
    kb.add_static(np.arange(n, n + m), np.arange(n, n + m),
                  np.full(m, -delta))
    kb.add_static(np.arange(n + m, N), np.arange(n + m, N),
                  np.full(k, -delta))
    kb.add_dynamic(np.arange(n + m, N), np.arange(n + m, N))  # −W
    kkt = kb.finalize(perm=ctrl.ordering)
    reg_diag = jnp.concatenate([jnp.full(n, gamma), jnp.full(m, -delta),
                                jnp.full(k, -delta)])


    Ad, Atd = A.device_csr(), A.transpose().device_csr()
    Gd, Gtd = G.device_csr(), G.transpose().device_csr()
    bj, hj, cj = jnp.asarray(b), jnp.asarray(h), jnp.asarray(c)
    tau, tol = ctrl.tau, _tol_eff
    nref = _resolve_refine(ctrl)
    unroll = ctrl.refine_unroll
    mehrotra = ctrl.approach == Approach.MEHROTRA
    sigma_ipf = ctrl.sigma_ipf

    @jax.jit
    def step(x, y, s, z, kkt, reg_diag, Ad, Atd, Gd, Gtd, bj, hj, cj):
        rb = bj - Ad.matvec(x)
        rh = hj - Gd.matvec(x) - s
        rc = -(cj + Atd.matvec(y) + Gtd.matvec(z))
        mu = s @ z / k
        pobj = cj @ x
        dobj = -(bj @ y + hj @ z)
        gap = jnp.abs(pobj - dobj) / (1 + jnp.abs(pobj))
        w = s / z
        fact = kkt.prepare(kkt.assemble([-w]))

        def directions(rmu):
            # rows: Aᵀdy + Gᵀdz = rc ; A dx = rb ; G dx − W dz = rh − rmu/z
            rhs = jnp.concatenate([rc, rb, rh - rmu / z])
            sol = fact.solve_refined(rhs, reg_diag, iters=nref,
                                     unroll=unroll)
            dx, dy, dz = sol[:n], sol[n:n + m], sol[n + m:]
            ds = (rmu - s * dz) / z
            return dx, dy, dz, ds

        if mehrotra:
            dxa, dya, dza, dsa = directions(-s * z)
            ap = _steplen_j(s, dsa, 1.0)
            ad = _steplen_j(z, dza, 1.0)
            mu_aff = (s + ap * dsa) @ (z + ad * dza) / k
            sigma = jnp.where(mu > 0, (mu_aff / mu) ** 3, 0.0)
            dx, dy, dz, ds = directions(sigma * mu - s * z - dsa * dza)
        else:
            dx, dy, dz, ds = directions(sigma_ipf * mu - s * z)

        alpha = jnp.minimum(_steplen_j(s, ds, tau), _steplen_j(z, dz, tau))
        xn, yn = x + alpha * dx, y + alpha * dy
        sn, zn = s + alpha * ds, z + alpha * dz
        ok = (jnp.all(jnp.isfinite(xn)) & jnp.all(jnp.isfinite(yn))
              & jnp.all(jnp.isfinite(sn)) & jnp.all(jnp.isfinite(zn)))
        return (xn, yn, sn, zn,
                jnp.linalg.norm(rb), jnp.linalg.norm(rh),
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
            x, y, s, z, kkt, reg_diag, Ad, Atd, Gd, Gtd, bj, hj, cj)
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
    return LPResult(x, y, z, float(c @ x), it, converged, s=s,
                    tol_effective=tol)


# --------------------------------------------------------------------------
# General-form (MPS) front end
# --------------------------------------------------------------------------

def mps_to_standard(lp: MPSData
                    ) -> Tuple[SparseMatrix, np.ndarray, np.ndarray, float,
                               Callable[[np.ndarray], np.ndarray]]:
    """General form → standard form (Ax=b, x≥0): shift finite lower bounds,
    split free variables, slack the ≤ rows, row-ify finite upper bounds.
    Returns (A, b, c, obj_shift, recover(x_std) → x_orig)."""
    import scipy.sparse as sp

    n = lp.c.shape[0]
    Aeq = lp.A_eq.to_scipy()
    Ale = lp.A_le.to_scipy()
    lower, upper = lp.lower.copy(), lp.upper.copy()

    # x = xs + l for finite l; free vars (l = −inf) → xp − xm
    finite_l = ~np.isneginf(lower)
    shift = np.where(finite_l, lower, 0.0)
    b_eq = lp.b_eq - Aeq @ shift
    b_le = lp.b_le - Ale @ shift
    ub = np.where(np.isposinf(upper), np.inf, upper - shift)

    free = ~finite_l
    nfree = int(free.sum())
    cols = [sp.eye(n, format="csc")]
    if nfree:
        neg = sp.csc_matrix((-np.ones(nfree), (np.nonzero(free)[0],
                                               np.arange(nfree))),
                            shape=(n, nfree))
        cols.append(neg)
    X = sp.hstack(cols, format="csc")  # x_orig−shift = X @ [xs; xm]

    nvar = X.shape[1]
    c_std = X.T @ lp.c

    # upper bounds become rows: xs_j + u_slack = ub_j
    ub_rows = np.nonzero(np.isfinite(ub))[0]
    nub = len(ub_rows)

    m_eq, m_le = Aeq.shape[0], Ale.shape[0]
    A_top = Aeq @ X
    A_mid = Ale @ X
    blocks = []
    # [Aeq·X   0      0   ]
    # [Ale·X   I_le   0   ]
    # [E_ub    0      I_ub]
    blocks.append(sp.hstack([A_top,
                             sp.csr_matrix((m_eq, m_le)),
                             sp.csr_matrix((m_eq, nub))]))
    if m_le:
        blocks.append(sp.hstack([A_mid, sp.eye(m_le),
                                 sp.csr_matrix((m_le, nub))]))
    if nub:
        E = sp.csr_matrix((np.ones(nub), (np.arange(nub), ub_rows)),
                          shape=(nub, nvar))
        blocks.append(sp.hstack([E, sp.csr_matrix((nub, m_le)),
                                 sp.eye(nub)]))
    A_std = sp.vstack(blocks).tocsr()
    b_std = np.concatenate([b_eq, b_le, ub[ub_rows]])
    c_full = np.concatenate([c_std, np.zeros(m_le + nub)])
    obj_shift = float(lp.c @ shift) + lp.c0

    def recover(x_std: np.ndarray) -> np.ndarray:
        return np.asarray(X @ x_std[:nvar]) + shift

    return (SparseMatrix.from_scipy(A_std), b_std, c_full, obj_shift,
            recover)


def solve_mps(lp: MPSData, ctrl: Optional[LPCtrl] = None
              ) -> Tuple[LPResult, np.ndarray]:
    """End-to-end: general-form MPS → standard form → IPM → recovered x."""
    A, b, c, shift, recover = mps_to_standard(lp)
    res = lp_direct(A, b, c, ctrl)
    res = dataclasses.replace(res, objective=res.objective + shift)
    return res, recover(res.x)
