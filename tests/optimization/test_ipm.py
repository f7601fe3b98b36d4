"""IPM tests (model: reference examples/interface drivers + netlib data;
optima cross-checked against scipy HiGHS and analytic solutions)."""

import os

import numpy as np
import pytest

from elemental_tpu.sparse import SparseMatrix, read_mps
from elemental_tpu.optimization import (Approach, Cones, LPCtrl, basis_pursuit,
                                        bpdn, chebyshev_point,
                                        dantzig_selector, lav, lp_affine,
                                        lp_direct, nnls, portfolio, qp_direct,
                                        robust_least_squares, soc_dets,
                                        soc_apply, soc_identity, soc_inverse,
                                        socp_affine, solve_mps, svm,
                                        total_variation)

REF_DATA = "/root/reference/data/optimization"
RNG = np.random.default_rng(53)


def _rand_lp(m=15, n=40):
    A = RNG.standard_normal((m, n))
    x0 = np.abs(RNG.standard_normal(n))
    b = A @ x0
    c = RNG.standard_normal(n)
    c = c - A.T @ np.linalg.lstsq(A.T, c, rcond=None)[0] \
        + A.T @ RNG.standard_normal(m)
    c = np.abs(RNG.standard_normal(n)) + A.T @ RNG.standard_normal(m)
    return SparseMatrix.from_dense(A), b, c


def test_lp_direct_vs_highs():
    import scipy.optimize as so
    A, b, c = _rand_lp()
    res = lp_direct(A, b, c, LPCtrl(tol=1e-9))
    ref = so.linprog(c, A_eq=A.to_dense(), b_eq=b, bounds=(0, None),
                     method="highs")
    assert res.converged
    np.testing.assert_allclose(res.objective, ref.fun, rtol=1e-6)


@pytest.mark.skipif(not os.path.isdir(REF_DATA),
                    reason="reference data not mounted")
@pytest.mark.parametrize("name,opt", [
    ("afiro", -464.75314286), ("adlittle", 225494.96316),
    ("share2b", -415.73224074), ("share1b", -76589.318579),
])
def test_netlib_instances(name, opt):
    """The reference's shipped LP data, solved to its known optima."""
    lp = read_mps(os.path.join(REF_DATA, f"{name}.mps"))
    res, x = solve_mps(lp, LPCtrl(max_iters=200))
    assert res.converged, name
    np.testing.assert_allclose(res.objective, opt, rtol=1e-6)


@pytest.mark.skipif(not os.path.isdir(REF_DATA),
                    reason="reference data not mounted")
def test_afiro_ipf():
    lp = read_mps(os.path.join(REF_DATA, "afiro.mps"))
    res, _ = solve_mps(lp, LPCtrl(approach=Approach.IPF, max_iters=300))
    assert res.converged
    np.testing.assert_allclose(res.objective, -464.75314286, rtol=1e-6)


def test_lp_affine():
    import scipy.optimize as so
    m, k, n = 5, 12, 8
    A = RNG.standard_normal((m, n))
    x0 = RNG.standard_normal(n)
    b = A @ x0
    G = RNG.standard_normal((k, n))
    h = G @ x0 + np.abs(RNG.standard_normal(k)) + 0.1
    c = RNG.standard_normal(n)
    res = lp_affine(SparseMatrix.from_dense(A), b,
                    SparseMatrix.from_dense(G), h, c, LPCtrl(tol=1e-9))
    ref = so.linprog(c, A_ub=G, b_ub=h, A_eq=A, b_eq=b,
                     bounds=(None, None), method="highs")
    if ref.success:
        assert res.converged
        np.testing.assert_allclose(res.objective, ref.fun, rtol=1e-5)


def test_qp_direct():
    n, m = 10, 3
    L = RNG.standard_normal((n, n))
    Q = L @ L.T + np.eye(n)
    A = RNG.standard_normal((m, n))
    b = A @ np.abs(RNG.standard_normal(n))
    c = RNG.standard_normal(n)
    res = qp_direct(Q, A, b, c, LPCtrl(tol=1e-9))
    assert res.converged
    # KKT optimality: Qx + c = Aᵀy + z, x ≥ 0, z ≥ 0, x∘z ≈ 0
    x, y, z = res.x, res.y, res.z
    np.testing.assert_allclose(Q @ x + c, A.T @ y + z, atol=1e-6)
    assert x.min() > -1e-9 and z.min() > -1e-9
    assert abs(x @ z) < 1e-6


def test_soc_atoms():
    cones = Cones([3, 2])
    e = soc_identity(cones)
    np.testing.assert_array_equal(e, [1, 0, 0, 1, 0])
    s = np.array([2.0, 1.0, 0.5, 3.0, 1.0])
    dets = soc_dets(s, cones)
    np.testing.assert_allclose(dets, [4 - 1.25, 8.0])
    sinv = soc_inverse(s, cones)
    np.testing.assert_allclose(soc_apply(s, sinv, cones), e, atol=1e-12)


def test_socp_least_squares():
    """min ‖Bu − d‖₂ as SOCP must match lstsq."""
    B = RNG.standard_normal((12, 5))
    d = RNG.standard_normal(12)
    n = 6
    G = np.zeros((13, n))
    G[0, 5] = -1.0
    G[1:, :5] = -B
    h = np.concatenate([[0], -d])
    c = np.zeros(n)
    c[5] = 1.0
    res = socp_affine(np.zeros((0, n)), np.zeros(0), G, h, c, Cones([13]),
                      LPCtrl(max_iters=200, tol=1e-9))
    assert res.converged
    expect, *_ = np.linalg.lstsq(B, d, rcond=None)
    np.testing.assert_allclose(res.x[:5], expect, atol=1e-6)


def test_basis_pursuit():
    """Recover a sparse signal from random measurements (BP.py scenario)."""
    m, n, k = 20, 50, 3
    A = RNG.standard_normal((m, n)) / np.sqrt(m)
    x0 = np.zeros(n)
    idx = RNG.choice(n, k, replace=False)
    x0[idx] = RNG.standard_normal(k) * 3
    b = A @ x0
    x = basis_pursuit(A, b, LPCtrl(tol=1e-10))
    np.testing.assert_allclose(x, x0, atol=1e-5)


def test_lav_and_cp():
    import scipy.optimize as so
    m, n = 25, 6
    A = RNG.standard_normal((m, n))
    b = RNG.standard_normal(m)
    x = lav(A, b, LPCtrl(tol=1e-9))
    # cross-check objective vs HiGHS LP
    c = np.concatenate([np.zeros(2 * n), np.ones(2 * m)])
    blocks = np.concatenate([A, -A, -np.eye(m), np.eye(m)], axis=1)
    ref = so.linprog(c, A_eq=blocks, b_eq=b, bounds=(0, None),
                     method="highs")
    np.testing.assert_allclose(np.abs(A @ x - b).sum(), ref.fun, rtol=1e-5)
    xc = chebyshev_point(A, b, LPCtrl(tol=1e-9))
    # ∞-norm optimality: compare against scipy linprog formulation
    ref2 = so.linprog(
        np.concatenate([np.zeros(n), [1.0]]),
        A_ub=np.block([[A, -np.ones((m, 1))], [-A, -np.ones((m, 1))]]),
        b_ub=np.concatenate([b, -b]), bounds=(None, None), method="highs")
    np.testing.assert_allclose(np.abs(A @ xc - b).max(), ref2.fun,
                               rtol=1e-4)


def test_nnls():
    import scipy.optimize as so
    A = RNG.standard_normal((15, 8))
    b = RNG.standard_normal(15)
    x = nnls(A, b, LPCtrl(tol=1e-10))
    ref, _ = so.nnls(A, b)
    np.testing.assert_allclose(np.linalg.norm(A @ x - b),
                               np.linalg.norm(A @ ref - b), rtol=1e-6)
    assert x.min() > -1e-8


def test_bpdn_soft_threshold():
    """With orthogonal A, BPDN = soft thresholding (analytic solution)."""
    n = 12
    q, _ = np.linalg.qr(RNG.standard_normal((n, n)))
    b = RNG.standard_normal(n)
    lam = 0.3
    x = bpdn(q, b, lam, LPCtrl(tol=1e-10))
    qtb = q.T @ b
    expect = np.sign(qtb) * np.maximum(np.abs(qtb) - lam, 0)
    np.testing.assert_allclose(x, expect, atol=1e-6)


def test_svm_separable():
    """Linearly separable data: SVM must classify perfectly."""
    m = 40
    w_true = np.array([1.0, -2.0])
    X = RNG.standard_normal((m, 2))
    y = np.sign(X @ w_true + 0.1)
    wb = svm(X, y, lam=1e-3, ctrl=LPCtrl(tol=1e-9, max_iters=200))
    pred = np.sign(X @ wb[:2] + wb[2])
    assert (pred == y).mean() == 1.0


def test_total_variation():
    n = 30
    x_true = np.concatenate([np.zeros(15), np.ones(15)])
    b = x_true + 0.05 * RNG.standard_normal(n)
    x = total_variation(b, lam=0.4, ctrl=LPCtrl(tol=1e-9, max_iters=200))
    # TV solution is flatter than the noisy signal (truth has TV = 1.0)
    assert np.abs(np.diff(x)).sum() < np.abs(np.diff(b)).sum() * 0.5
    # and closer to the truth
    assert np.linalg.norm(x - x_true) < np.linalg.norm(b - x_true)


def test_dantzig_selector():
    m, n = 25, 10
    A = RNG.standard_normal((m, n)) / np.sqrt(m)
    x0 = np.zeros(n)
    x0[:2] = [3.0, -2.0]
    b = A @ x0
    x = dantzig_selector(A, b, lam=1e-4, ctrl=LPCtrl(tol=1e-9))
    np.testing.assert_allclose(x, x0, atol=1e-2)


def test_portfolio():
    n = 8
    L = RNG.standard_normal((n, n))
    Sigma = L @ L.T + np.eye(n)
    mu = RNG.standard_normal(n)
    x = portfolio(Sigma, mu, gamma=1.0, ctrl=LPCtrl(tol=1e-9))
    np.testing.assert_allclose(x.sum(), 1.0, atol=1e-6)
    assert x.min() > -1e-8


def test_robust_least_squares():
    A = RNG.standard_normal((10, 4))
    b = RNG.standard_normal(10)
    x = robust_least_squares(A, b, rho=0.1,
                             ctrl=LPCtrl(tol=1e-9, max_iters=300))
    # optimality vs brute-force smooth minimization
    import scipy.optimize as so
    f = lambda v: np.linalg.norm(A @ v - b) + 0.1 * np.linalg.norm(v)
    ref = so.minimize(f, np.zeros(4), method="Nelder-Mead",
                      options={"xatol": 1e-10, "fatol": 1e-12,
                               "maxiter": 20000})
    assert f(x) <= ref.fun + 1e-5


def test_lp_direct_large_path_matches_fused(monkeypatch):
    """The python-orchestrated at-scale step (one compiled factor + one
    compiled refined solve, lp.py ``large`` branch) must reproduce the
    fused-jit path."""
    from elemental_tpu.optimization import lp as lpmod
    A, b, c = _rand_lp(12, 30)
    ref = lp_direct(A, b, c, LPCtrl(tol=1e-9))
    monkeypatch.setattr(lpmod, "LARGE_FUSED_N", 1)   # force the large path
    res = lp_direct(A, b, c, LPCtrl(tol=1e-9))
    assert res.converged
    np.testing.assert_allclose(res.objective, ref.objective, rtol=1e-7)
    np.testing.assert_allclose(res.x, ref.x, atol=1e-6)


def test_lp_direct_large_path_ipf(monkeypatch):
    from elemental_tpu.optimization import lp as lpmod
    A, b, c = _rand_lp(10, 24)
    monkeypatch.setattr(lpmod, "LARGE_FUSED_N", 1)
    res = lp_direct(A, b, c, LPCtrl(tol=1e-8, approach=Approach.IPF,
                                    max_iters=300))
    assert res.converged
    import scipy.optimize as so
    refo = so.linprog(c, A_eq=A.to_dense(), b_eq=b, bounds=(0, None),
                      method="highs")
    np.testing.assert_allclose(res.objective, refo.fun, rtol=1e-6)


def test_kkt_pivot_floor_in_matrix_scale():
    """``prepare`` maps floors given in the matrix's own scale into the
    equilibrated scale (× D²): a floor at half the LP KKT's regularization
    leaves the factor untouched, a large one lifts every pivot to it."""
    import jax.numpy as jnp
    from elemental_tpu.optimization.lp import _build_lp_kkt, sparse_ruiz
    rng = np.random.default_rng(4)
    a = np.abs(rng.standard_normal((12, 30))) + 0.1
    A, _, _ = sparse_ruiz(SparseMatrix.from_dense(a))
    kkt, _ = _build_lp_kkt(A, 1e-6, 1e-6, None)
    vals = kkt.assemble([jnp.asarray(np.abs(rng.standard_normal(30)) + .1)])
    sign = jnp.concatenate([jnp.ones(30), -jnp.ones(12)])
    f0 = kkt.prepare(vals)
    f1 = kkt.prepare(vals, pivot_floor=0.5e-6 * sign)
    np.testing.assert_array_equal(np.asarray(f1.d), np.asarray(f0.d))
    f2 = kkt.prepare(vals, pivot_floor=1e3 * sign)
    floor = 1e3 * np.asarray(f2.scale) ** 2
    perm = np.asarray(kkt.symb.perm)
    assert np.all(np.abs(np.asarray(f2.d)) >= floor[perm] * (1 - 1e-12))
    assert np.array_equal(np.sign(np.asarray(f2.d)), np.sign(np.asarray(f0.d)))


def test_pivot_floor_boosts_zero_pivot_keeps_regularization_pivots():
    """The LP's half-regularization floor on a matrix with one exactly zero
    pivot (the block [[1, 1], [1, 1]]) and pivots exactly at ±γ: without
    the floor the factored solve is not finite; with it the zero pivot is
    lifted to γ/2 and the ±γ pivots stay as they are."""
    import jax.numpy as jnp
    from elemental_tpu.sparse_direct.numeric import factor
    from elemental_tpu.sparse_direct.symbolic import analyze
    g = 1e-6
    a = np.zeros((6, 6))
    a[:2, :2] = 1.0
    a[2, 2], a[3, 3] = g, -g
    a[4:, 4:] = [[2.0, 1.0], [1.0, -3.0]]
    A = SparseMatrix.from_dense(a)
    symb = analyze(A).device()
    floor = 0.5 * np.array([g, g, g, -g, g, -g])
    perm = np.asarray(symb.perm)
    b = np.arange(1.0, 7.0)
    f0 = factor(symb, jnp.asarray(A.vals), dtype=jnp.float64)
    assert not np.all(np.isfinite(np.asarray(f0.solve(jnp.asarray(b)))))
    f1 = factor(symb, jnp.asarray(A.vals), dtype=jnp.float64,
                pivot_floor=jnp.asarray(floor))
    d0, d1 = np.asarray(f0.d)[np.argsort(perm)], np.asarray(f1.d)[
        np.argsort(perm)]
    zero = np.flatnonzero(d0 == 0)
    assert zero.size == 1 and zero[0] < 2
    assert d1[zero[0]] == floor[zero[0]]
    keep = np.setdiff1d(np.arange(6), zero)
    np.testing.assert_array_equal(d1[keep], d0[keep])
    np.testing.assert_array_equal(d1[[2, 3]], [g, -g])
    assert np.all(np.isfinite(np.asarray(f1.solve(jnp.asarray(b)))))
