"""Spectral / solver / props / funcs tests (model: reference
``tests/lapack_like/{HermitianEig,HermitianTridiagEig}.cpp`` and the dormant
tiers' example programs)."""

import numpy as np
import pytest

import jax.numpy as jnp

from elemental_tpu import lapack as la

RNG = np.random.default_rng(5)


def _herm(n, dtype=np.float64):
    a = RNG.standard_normal((n, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * RNG.standard_normal((n, n))
    a = a.astype(dtype)
    return ((a + a.conj().T) / 2).astype(dtype)


def _rand(shape, dtype=np.float64):
    a = RNG.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * RNG.standard_normal(shape)
    return a.astype(dtype)


# -- eigensolvers -----------------------------------------------------------

@pytest.mark.parametrize("alg", ["direct", "tridiag"])
def test_hermitian_eig(alg):
    n = 50
    a = _herm(n)
    pair = la.hermitian_eig("L", jnp.asarray(a), alg=alg)
    w, q = np.asarray(pair.w), np.asarray(pair.q)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(a), rtol=1e-8,
                               atol=1e-8)
    # residual ‖AQ − QΛ‖
    assert np.abs(a @ q - q * w[None, :]).max() < 1e-7


def test_hermitian_eig_complex():
    n = 40
    a = _herm(n, np.complex128)
    pair = la.hermitian_eig("L", jnp.asarray(a))
    w, q = np.asarray(pair.w), np.asarray(pair.q)
    assert np.abs(a @ q - q * w[None, :]).max() < 1e-8


def test_hermitian_eig_subset():
    n = 30
    a = _herm(n)
    pair = la.hermitian_eig("L", jnp.asarray(a), subset=(5, 10))
    assert pair.w.shape == (6,)
    np.testing.assert_allclose(np.asarray(pair.w),
                               np.linalg.eigvalsh(a)[5:11], rtol=1e-9)


def test_hermitian_tridiag():
    n = 30
    a = _herm(n, np.complex128)
    t = la.hermitian_tridiag("L", jnp.asarray(a))
    d, e, q = np.asarray(t.d), np.asarray(t.e), np.asarray(t.q)
    T = np.diag(d) + np.diag(e, -1) + np.diag(e, 1)
    np.testing.assert_allclose(q @ T @ q.conj().T, a, rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(q @ q.conj().T, np.eye(n), atol=1e-8)


def test_tridiag_eig_estimate():
    n = 40
    d = RNG.standard_normal(n)
    e = RNG.standard_normal(n - 1) * 0.5
    T = np.diag(d) + np.diag(e, -1) + np.diag(e, 1)
    w = np.linalg.eigvalsh(T)
    cnt = int(la.hermitian_tridiag_eig_estimate(jnp.asarray(d),
                                                jnp.asarray(e),
                                                w[9] + 1e-9, w[29] + 1e-9))
    assert cnt == 20


def test_skew_hermitian_eig():
    n = 20
    a = RNG.standard_normal((n, n))
    a = a - a.T  # real skew
    pair = la.skew_hermitian_eig("L", jnp.asarray(a))
    w = np.asarray(pair.w)
    expect = np.sort(np.imag(np.linalg.eigvals(a)))
    np.testing.assert_allclose(np.sort(w), expect, atol=1e-8)


def test_svd_and_norms():
    m, n = 40, 25
    a = _rand((m, n))
    out = la.svd(jnp.asarray(a))
    u, s, vh = np.asarray(out.u), np.asarray(out.s), np.asarray(out.vh)
    np.testing.assert_allclose(u @ np.diag(s) @ vh, a, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(float(la.two_norm(jnp.asarray(a))), s[0],
                               rtol=1e-10)
    np.testing.assert_allclose(float(la.nuclear_norm(jnp.asarray(a))),
                               s.sum(), rtol=1e-10)
    est = float(la.two_norm_estimate(jnp.asarray(a), iters=100))
    assert abs(est - s[0]) / s[0] < 1e-3


def test_schur_and_eig():
    n = 20
    a = _rand((n, n))
    sch = la.schur(jnp.asarray(a))
    t, q = np.asarray(sch.t), np.asarray(sch.q)
    np.testing.assert_allclose(q @ t @ q.conj().T, a, rtol=1e-9, atol=1e-9)
    assert np.abs(np.tril(t, -1)).max() < 1e-10


def test_triang_eig():
    n = 15
    t = np.triu(_rand((n, n))) + np.diag(np.arange(1.0, n + 1) * 2)
    X = np.asarray(la.triang_eig(jnp.asarray(t)))
    lam = np.diag(t)
    res = t @ X - X * lam[None, :]
    assert np.abs(res).max() < 1e-7


def test_pseudospectra():
    n = 24
    a = _rand((n, n))
    shifts = np.array([0.5 + 0.1j, 2.0 - 1.0j, -1.0 + 0.5j])
    smin = np.asarray(la.pseudospectra(jnp.asarray(a),
                                       jnp.asarray(shifts), iters=200))
    expect = np.array([np.linalg.svd(a - z * np.eye(n), compute_uv=False)[-1]
                       for z in shifts])
    np.testing.assert_allclose(smin, expect, rtol=1e-2)


def test_polar():
    n = 18
    a = _rand((n, n)) + 3 * np.eye(n)
    q, p = la.polar(jnp.asarray(a))
    q, p = np.asarray(q), np.asarray(p)
    np.testing.assert_allclose(q @ p, a, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(q.T @ q, np.eye(n), atol=1e-6)
    assert np.all(np.linalg.eigvalsh((p + p.T) / 2) > 0)


def test_secular_evd():
    n = 12
    d = np.sort(RNG.standard_normal(n))
    z = RNG.standard_normal(n)
    rho = 0.7
    w = np.asarray(la.secular_evd(jnp.asarray(d), rho, jnp.asarray(z),
                                  iters=80))
    expect = np.linalg.eigvalsh(np.diag(d) + rho * np.outer(z, z))
    np.testing.assert_allclose(np.sort(w), expect, atol=1e-6)


# -- solvers ----------------------------------------------------------------

def test_linear_and_symmetric_solves():
    n = 60
    a = _rand((n, n)) + n * np.eye(n)
    b = _rand((n, 3))
    x = np.asarray(la.linear_solve(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-8)
    s = (a + a.T) / 2
    x = np.asarray(la.symmetric_solve(jnp.asarray(s), jnp.asarray(b)))
    np.testing.assert_allclose(x, np.linalg.solve(s, b), rtol=1e-8)


def test_gmres():
    n = 80
    a = _rand((n, n)) + n * np.eye(n)
    b = _rand((n,))
    res = la.gmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                   restart=40, tol=1e-10)
    x = np.asarray(res.x)
    assert np.linalg.norm(a @ x - b) / np.linalg.norm(b) < 1e-8


def test_fgmres_preconditioned():
    n = 80
    a = _rand((n, n)) + n * np.eye(n)
    b = _rand((n,))
    dinv = 1.0 / np.diag(a)
    res = la.fgmres(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                    precond=lambda v: jnp.asarray(dinv) * v, tol=1e-10)
    assert np.linalg.norm(a @ np.asarray(res.x) - b) < 1e-7


def test_cg_hpd():
    n = 100
    a = _rand((n, n))
    a = a @ a.T + n * np.eye(n)
    b = _rand((n,))
    res = la.cg(lambda v: jnp.asarray(a) @ v, jnp.asarray(b), tol=1e-12)
    np.testing.assert_allclose(np.asarray(res.x), np.linalg.solve(a, b),
                               rtol=1e-6, atol=1e-8)


def test_refined_solve():
    n = 50
    a = _rand((n, n)) + n * np.eye(n)
    b = _rand((n,))
    # approximate inverse: single-precision LU
    a32 = a.astype(np.float32)
    fact = la.lu(jnp.asarray(a32))
    res = la.refined_solve(
        lambda v: jnp.asarray(a) @ v,
        lambda v: la.lu_solve_after(fact, v.astype(jnp.float32))
                    .astype(jnp.float64),
        jnp.asarray(b), tol=1e-13)
    assert np.linalg.norm(a @ np.asarray(res.x) - b) < 1e-9


def test_multishift_hess_solve():
    n, k = 20, 4
    h = np.triu(_rand((n, n)), -1) + n * np.eye(n)
    shifts = RNG.standard_normal(k)
    b = _rand((n, k))
    x = np.asarray(la.multishift_hess_solve(jnp.asarray(h),
                                            jnp.asarray(shifts),
                                            jnp.asarray(b)))
    for j in range(k):
        np.testing.assert_allclose(
            (h - shifts[j] * np.eye(n)) @ x[:, j], b[:, j], atol=1e-8)


# -- least squares / funcs / equilibrate ------------------------------------

def test_least_squares():
    m, n = 60, 25
    a = _rand((m, n))
    b = _rand((m,))
    x = np.asarray(la.least_squares("N", jnp.asarray(a), jnp.asarray(b)))
    expect, *_ = np.linalg.lstsq(a, b, rcond=None)
    np.testing.assert_allclose(x, expect, rtol=1e-8, atol=1e-8)
    # underdetermined → minimum norm
    a2 = _rand((n, m))
    b2 = _rand((n,))
    x2 = np.asarray(la.least_squares("N", jnp.asarray(a2), jnp.asarray(b2)))
    expect2, *_ = np.linalg.lstsq(a2, b2, rcond=None)
    np.testing.assert_allclose(x2, expect2, rtol=1e-8, atol=1e-8)


def test_ridge_tikhonov():
    m, n = 50, 20
    a, b = _rand((m, n)), _rand((m,))
    gamma = 0.3
    x = np.asarray(la.ridge("N", jnp.asarray(a), jnp.asarray(b), gamma))
    expect = np.linalg.solve(a.T @ a + gamma ** 2 * np.eye(n), a.T @ b)
    np.testing.assert_allclose(x, expect, rtol=1e-9, atol=1e-9)
    g = _rand((n, n)) * 0.1
    x = np.asarray(la.tikhonov("N", jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(g)))
    expect = np.linalg.solve(a.T @ a + g.T @ g, a.T @ b)
    np.testing.assert_allclose(x, expect, rtol=1e-8, atol=1e-8)


def test_lse():
    m, n, p = 40, 20, 8
    a, b = _rand((m, n)), _rand((p, n))
    c, d = _rand((m,)), _rand((p,))
    x = np.asarray(la.lse(jnp.asarray(a), jnp.asarray(b), c, d))
    np.testing.assert_allclose(b @ x, d, atol=1e-8)
    # KKT optimality: residual orthogonal to nullspace of B
    import scipy.linalg as sla
    Z = sla.null_space(b)
    np.testing.assert_allclose(Z.T @ (a.T @ (a @ x - c)), 0, atol=1e-6)


def test_glm():
    m, n, p = 30, 12, 30
    a, b = _rand((m, n)), _rand((m, p))
    d = _rand((m,))
    x, y = la.glm(jnp.asarray(a), jnp.asarray(b), d)
    np.testing.assert_allclose(a @ np.asarray(x) + b @ np.asarray(y), d,
                               atol=1e-8)


def test_inverse_funcs():
    n = 30
    a = _rand((n, n)) + n * np.eye(n)
    np.testing.assert_allclose(np.asarray(la.inverse(jnp.asarray(a))),
                               np.linalg.inv(a), rtol=1e-8, atol=1e-8)
    hpd = a @ a.T
    np.testing.assert_allclose(np.asarray(la.hpd_inverse("L", jnp.asarray(hpd))),
                               np.linalg.inv(hpd), rtol=1e-6, atol=1e-6)
    pinv = np.asarray(la.pseudoinverse(jnp.asarray(_rand((40, 20)))))
    # verified via Moore-Penrose conditions on a fresh matrix
    b = _rand((40, 20))
    pb = np.asarray(la.pseudoinverse(jnp.asarray(b)))
    np.testing.assert_allclose(b @ pb @ b, b, rtol=1e-8, atol=1e-8)


def test_sign_and_sqrt():
    n = 20
    a = _rand((n, n))
    a = a @ a.T + n * np.eye(n)  # SPD → sign = I
    s = np.asarray(la.sign(jnp.asarray(a)))
    np.testing.assert_allclose(s, np.eye(n), atol=1e-6)
    r = np.asarray(la.square_root(jnp.asarray(a)))
    np.testing.assert_allclose(r @ r, a, rtol=1e-7, atol=1e-6)
    r2 = np.asarray(la.hpd_square_root("L", jnp.asarray(a)))
    np.testing.assert_allclose(r2 @ r2, a, rtol=1e-7, atol=1e-6)


def test_equilibrate():
    m, n = 30, 20
    a = _rand((m, n)) * np.exp(RNG.standard_normal((m, n)) * 3)
    eq = la.ruiz_equil(jnp.asarray(a), iters=10)
    scaled = np.asarray(eq.a)
    assert np.abs(scaled).max() < 2.0
    np.testing.assert_allclose(
        np.asarray(eq.drow)[:, None] * scaled * np.asarray(eq.dcol)[None, :],
        a, rtol=1e-9)
    eq2 = la.geom_equil(jnp.asarray(a))
    np.testing.assert_allclose(
        np.asarray(eq2.drow)[:, None] * np.asarray(eq2.a)
        * np.asarray(eq2.dcol)[None, :], a, rtol=1e-9)
    s = a[:n, :n] + a[:n, :n].T
    sa, d = la.symmetric_ruiz_equil(jnp.asarray(s))
    np.testing.assert_allclose(
        np.asarray(d)[:, None] * np.asarray(sa) * np.asarray(d)[None, :],
        s, rtol=1e-6)


def test_permutation():
    n = 10
    p = la.Permutation(RNG.permutation(n))
    a = _rand((n, n))
    pa = np.asarray(p.permute_rows(jnp.asarray(a)))
    np.testing.assert_array_equal(pa, a[np.asarray(p.perm)])
    back = np.asarray(p.inverse().permute_rows(jnp.asarray(pa)))
    np.testing.assert_array_equal(back, a[np.asarray(p.compose(p.inverse()).perm)])
    roundtrip = np.asarray(p.permute_rows(p.permute_rows(jnp.asarray(a)),
                                          inverse=True))
    np.testing.assert_array_equal(roundtrip, a)


def test_condense_bidiag_hessenberg():
    m, n = 25, 25
    a = _rand((m, n))
    bd = la.bidiag(jnp.asarray(a))
    B = np.diag(np.asarray(bd.d)) + np.diag(np.asarray(bd.e), 1)
    u, v = np.asarray(bd.u), np.asarray(bd.v)
    np.testing.assert_allclose(u.conj().T @ a @ v, B, atol=1e-8)
    h = la.hessenberg("L", jnp.asarray(a))
    hh, q = np.asarray(h.h), np.asarray(h.q)
    np.testing.assert_allclose(q @ hh @ q.conj().T, a, atol=1e-8)
    assert np.abs(np.tril(hh, -2)).max() < 1e-10


def test_hermitian_tridiag_blocked_matches_unblocked():
    """Blocked (latrd panel + rank-2nb) == rank-2 loop reduction."""
    import jax.numpy as jnp
    from elemental_tpu.lapack.condense import (_hermitian_tridiag_blocked,
                                               hermitian_tridiag)
    rng = np.random.default_rng(5)
    for n, cplx in [(60, False), (197, False), (80, True)]:
        a = rng.standard_normal((n, n))
        if cplx:
            a = a + 1j * rng.standard_normal((n, n))
        a = (a + a.conj().T) / 2
        d, e, q = _hermitian_tridiag_blocked("L", jnp.asarray(a), nb=16)
        d, e, q = np.asarray(d), np.asarray(e), np.asarray(q)
        T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
        assert np.abs(q @ T @ q.conj().T - a).max() < 1e-11 * n
        assert np.abs(q.conj().T @ q - np.eye(n)).max() < 1e-11
        # eigenvalues agree with the unblocked path
        d2, e2, _ = hermitian_tridiag("L", jnp.asarray(a), blocksize=8)
        T2 = np.diag(np.asarray(d2)) + np.diag(np.asarray(e2), 1) \
            + np.diag(np.asarray(e2), -1)
        np.testing.assert_allclose(np.sort(np.linalg.eigvalsh(T)),
                                   np.sort(np.linalg.eigvalsh(T2)),
                                   rtol=1e-9, atol=1e-9)


def test_blocked_bidiag_hessenberg_match():
    """Blocked (latrd-style panel) Bidiag/Hessenberg == rank-1 variants'
    invariants at sizes above the dispatch threshold."""
    import jax
    import jax.numpy as jnp
    from elemental_tpu.lapack.condense import (_bidiag_blocked,
                                               _hessenberg_blocked)
    rng = np.random.default_rng(11)
    a = rng.standard_normal((210, 200))
    d, e, U, V = jax.jit(lambda a: _bidiag_blocked(a, nb=32))(jnp.asarray(a))
    d, e, U, V = map(np.asarray, (d, e, U, V))
    B = np.zeros((210, 200))
    B[np.arange(200), np.arange(200)] = d
    B[np.arange(199), np.arange(1, 200)] = e
    assert np.abs(U @ B @ V.T - a).max() / np.abs(a).max() < 1e-12
    assert np.abs(U.T @ U - np.eye(210)).max() < 1e-12
    assert np.abs(V.T @ V - np.eye(200)).max() < 1e-12

    h = rng.standard_normal((200, 200)) + 1j * rng.standard_normal((200, 200))
    H, Q = jax.jit(lambda a: _hessenberg_blocked(a, nb=32))(jnp.asarray(h))
    H, Q = np.asarray(H), np.asarray(Q)
    assert np.abs(Q @ H @ Q.conj().T - h).max() / np.abs(h).max() < 1e-12
    assert np.abs(Q.conj().T @ Q - np.eye(200)).max() < 1e-12
    assert np.abs(np.tril(H, -2)).max() == 0.0
