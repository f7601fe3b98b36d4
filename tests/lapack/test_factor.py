"""Factorization tests (model: reference ``tests/lapack_like/Cholesky.cpp``:
random well-conditioned input, factor, solve, check residual
‖X − A⁻¹Y‖∞/(ε·n·‖Y‖₁) < 100; same pattern for LU/QR/LDL)."""

import numpy as np
import pytest

import jax.numpy as jnp

from elemental_tpu.core import MC, MR, distribute, epsilon
from elemental_tpu import lapack as la

RNG = np.random.default_rng(3)


def _hpd(n, dtype=np.float64):
    a = RNG.standard_normal((n, n))
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * RNG.standard_normal((n, n))
    a = a.astype(dtype)
    return (a @ a.conj().T + n * np.eye(n)).astype(dtype)


def _rand(shape, dtype=np.float64):
    a = RNG.standard_normal(shape)
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        a = a + 1j * RNG.standard_normal(shape)
    return a.astype(dtype)


# -- Cholesky ---------------------------------------------------------------

@pytest.mark.parametrize("uplo", ["L", "U"])
def test_cholesky_residual(dtype, uplo):
    n = 100
    a = _hpd(n, dtype)
    f = np.asarray(la.cholesky(uplo, jnp.asarray(a)))
    recon = f @ f.conj().T if uplo == "L" else f.conj().T @ f
    eps = epsilon(dtype)
    rel = np.abs(recon - a).max() / (eps * n * np.abs(a).max())
    assert rel < 100, rel


def test_cholesky_solve_residual(rdtype):
    """The reference's acceptance bound (Cholesky.cpp:41-44)."""
    n, k = 120, 5
    a = _hpd(n, rdtype)
    y = _rand((n, k), rdtype)
    x = np.asarray(la.hpd_solve("L", jnp.asarray(a), jnp.asarray(y)))
    eps = epsilon(rdtype)
    relerr = np.abs(x - np.linalg.solve(a, y)).max() / (
        eps * n * np.abs(y).sum(axis=0).max())
    assert relerr < 100, relerr


def test_cholesky_recursive_large():
    n = 700  # exercises recursion (base 256)
    a = _hpd(n, np.float64)
    f = np.asarray(la.cholesky("L", jnp.asarray(a)))
    assert np.allclose(f @ f.T, a, rtol=1e-10, atol=1e-8)
    assert np.allclose(np.triu(f, 1), 0)


def test_pivoted_cholesky():
    n = 40
    a = _hpd(n, np.float64)
    fact = la.pivoted_cholesky("L", jnp.asarray(a))
    L = np.asarray(fact.factor)
    p = np.asarray(fact.perm)
    assert np.allclose(L @ L.T, a[p][:, p], rtol=1e-9, atol=1e-9)
    assert int(fact.rank) == n
    # pivoted order → non-increasing diagonal
    d = np.diag(L)
    assert np.all(d[:-1] >= d[1:] - 1e-12)


def test_reverse_cholesky():
    n = 30
    a = _hpd(n)
    l = np.asarray(la.reverse_cholesky("L", jnp.asarray(a)))
    assert np.allclose(l.T @ l, a, rtol=1e-9, atol=1e-9)  # A = LᴴL
    assert np.allclose(np.triu(l, 1), 0)  # lower-triangular factor
    u = np.asarray(la.reverse_cholesky("U", jnp.asarray(a)))
    assert np.allclose(u @ u.T, a, rtol=1e-9, atol=1e-9)  # A = U·Uᴴ
    assert np.allclose(np.tril(u, -1), 0)


def test_cholesky_mod():
    n, k = 25, 3
    a = _hpd(n)
    L = np.asarray(la.cholesky("L", jnp.asarray(a)))
    v = _rand((n, k))
    L2 = np.asarray(la.cholesky_mod("L", jnp.asarray(L), 0.5, jnp.asarray(v)))
    assert np.allclose(L2 @ L2.T, a + 0.5 * v @ v.T, rtol=1e-8, atol=1e-8)


def test_cholesky_distributed(grid8):
    n = 96
    a = _hpd(n, np.float32)
    A = distribute(a, MC, MR, grid8)
    F = la.cholesky("L", A)
    assert F.dist() == (MC, MR)
    f = F.to_numpy()
    assert np.allclose(f @ f.T, a, rtol=1e-2, atol=1e-2)


# -- LU ---------------------------------------------------------------------

def test_lu_solve(dtype):
    n, k = 80, 4
    a = _rand((n, n), dtype) + n * np.eye(n, dtype=dtype)
    b = _rand((n, k), dtype)
    fact = la.lu(jnp.asarray(a))
    x = np.asarray(la.lu_solve_after(fact, jnp.asarray(b)))
    rtol = 1e-3 if np.dtype(dtype).itemsize <= 8 and np.dtype(dtype).kind != "f" or np.dtype(dtype) in (np.float32, np.complex64) else 1e-9
    np.testing.assert_allclose(x, np.linalg.solve(a, b), rtol=1e-3, atol=1e-3)


def test_lu_transpose_solve():
    n = 50
    a = _rand((n, n)) + n * np.eye(n)
    b = _rand((n, 2))
    fact = la.lu(jnp.asarray(a))
    x = np.asarray(la.lu_solve_after(fact, jnp.asarray(b), orient="T"))
    np.testing.assert_allclose(x, np.linalg.solve(a.T, b), rtol=1e-8)


def test_lu_full_pivoting():
    n = 30
    a = _rand((n, n))
    fact = la.lu_full(jnp.asarray(a))
    lu = np.asarray(fact.lu)
    L = np.tril(lu, -1) + np.eye(n)
    U = np.triu(lu)
    rp, cp = np.asarray(fact.rowperm), np.asarray(fact.colperm)
    np.testing.assert_allclose(L @ U, a[rp][:, cp], rtol=1e-9, atol=1e-9)
    x = np.asarray(la.solve_after_full(fact, jnp.asarray(a[:, 0])[:, None] * 0 + _rand((n, 1))))
    # just check the full-pivot solve runs and satisfies the residual
    b = _rand((n, 1))
    x = np.asarray(la.solve_after_full(fact, jnp.asarray(b)))
    np.testing.assert_allclose(a @ x, b, rtol=1e-7, atol=1e-7)


def test_determinant():
    n = 12
    a = _rand((n, n))
    np.testing.assert_allclose(float(la.determinant(jnp.asarray(a))),
                               np.linalg.det(a), rtol=1e-8)


# -- QR ---------------------------------------------------------------------

def test_qr_residual(dtype):
    m, n = 60, 40
    a = _rand((m, n), dtype)
    q, r = la.qr(jnp.asarray(a))
    q, r = np.asarray(q), np.asarray(r)
    assert np.allclose(q @ r, a, rtol=1e-4, atol=1e-4)
    assert np.allclose(q.conj().T @ q, np.eye(n), atol=1e-4)
    assert np.allclose(np.tril(r, -1), 0, atol=1e-6)


def test_tsqr_matches_qr(grid8):
    from elemental_tpu.core import VC, STAR
    m, n = 512, 24
    a = _rand((m, n), np.float64)
    A = distribute(a, VC, STAR, grid8)
    q, r = la.tsqr(A, grid8)
    q, r = np.asarray(q), np.asarray(r)
    assert np.allclose(q @ r, a, rtol=1e-9, atol=1e-9)
    assert np.allclose(q.T @ q, np.eye(n), atol=1e-9)


def test_cholesky_qr():
    m, n = 200, 16
    a = _rand((m, n))
    q, r = la.cholesky_qr(jnp.asarray(a))
    q, r = np.asarray(q), np.asarray(r)
    assert np.allclose(q @ r, a, rtol=1e-8, atol=1e-8)
    assert np.allclose(q.T @ q, np.eye(n), atol=1e-8)


def test_qr_pivoted():
    m, n = 40, 25
    a = _rand((m, n))
    fact = la.qr_pivoted(jnp.asarray(a))
    q, r, p = np.asarray(fact.q), np.asarray(fact.r), np.asarray(fact.perm)
    assert np.allclose(q @ r, a[:, p], rtol=1e-8, atol=1e-8)
    d = np.abs(np.diag(r))
    assert np.all(d[:-1] >= d[1:] - 1e-8)  # pivoting ⇒ decreasing |r_kk|
    # orthonormality of the loop-formed Q (the loop's own factorization
    # is the output — no second QR)
    assert np.allclose(q.T @ q, np.eye(n), atol=1e-8)


def test_qr_pivoted_complex():
    m, n = 24, 16
    rng = np.random.default_rng(7)
    a = rng.standard_normal((m, n)) + 1j * rng.standard_normal((m, n))
    fact = la.qr_pivoted(jnp.asarray(a))
    q, r, p = np.asarray(fact.q), np.asarray(fact.r), np.asarray(fact.perm)
    assert np.allclose(q @ r, a[:, p], rtol=1e-8, atol=1e-8)
    assert np.allclose(q.conj().T @ q, np.eye(n), atol=1e-8)
    assert np.abs(np.tril(r, -1)).max() < 1e-10


def test_lq_rq():
    m, n = 30, 50
    a = _rand((m, n))
    l, q = la.lq(jnp.asarray(a))
    assert np.allclose(np.asarray(l) @ np.asarray(q), a, rtol=1e-9, atol=1e-9)
    assert np.allclose(np.triu(np.asarray(l), 1), 0, atol=1e-9)
    r, q2 = la.rq(jnp.asarray(a))
    assert np.allclose(np.asarray(r) @ np.asarray(q2), a, rtol=1e-9, atol=1e-9)


def test_apply_q_householder():
    m, n = 30, 30
    a = _rand((m, n))
    packed, taus = la.qr_householder(jnp.asarray(a))
    q = np.asarray(la.expand_packed_reflectors(np.asarray(packed), taus))
    b = _rand((m, 3))
    qb = np.asarray(la.apply_q(np.asarray(packed), np.asarray(taus),
                               jnp.asarray(b)))
    np.testing.assert_allclose(qb, q @ b, rtol=1e-8, atol=1e-8)


# -- LDL --------------------------------------------------------------------

@pytest.mark.parametrize("conjugate", [False, True])
def test_ldl_residual(conjugate):
    n = 90
    dt = np.complex128 if conjugate else np.float64
    a = _hpd(n, dt)
    if not conjugate:
        a = (a + a.T) / 2
    fact = la.ldl(jnp.asarray(a), conjugate=conjugate)
    L, d = np.asarray(fact.lower), np.asarray(fact.diag)
    rhs = L.conj().T if conjugate else L.T
    recon = (L * d[None, :]) @ rhs
    assert np.allclose(recon, a, rtol=1e-9, atol=1e-8)
    assert np.allclose(np.diag(L), 1.0)


def test_ldl_indefinite_quasidefinite():
    """Quasi-definite KKT-style matrix (the IPM case): LDL must succeed
    without pivoting."""
    n, m = 30, 20
    A = _rand((m, n))
    kkt = np.block([[np.eye(n), A.T], [A, -np.eye(m)]])
    fact = la.ldl(jnp.asarray(kkt), conjugate=False)
    L, d = np.asarray(fact.lower), np.asarray(fact.diag)
    assert np.allclose((L * d[None, :]) @ L.T, kkt, rtol=1e-9, atol=1e-8)
    pos, neg, zero = la.ldl_inertia(fact)
    assert (int(pos), int(neg)) == (n, m)


def test_regularized_ldl_solve_refined():
    n = 60
    a = _hpd(n)
    reg = np.full(n, 1e-4)
    fact = la.regularized_ldl(jnp.asarray(a), jnp.asarray(reg))
    b = _rand((n,))
    x = np.asarray(la.solve_after_refined(jnp.asarray(a), fact,
                                          jnp.asarray(b)))
    np.testing.assert_allclose(a @ x, b, rtol=1e-8, atol=1e-8)


def test_inertia():
    d = np.array([3.0, -2.0, 5.0, -1.0, 4.0])
    a = np.diag(d)
    q, _ = np.linalg.qr(_rand((5, 5)))
    a = q @ a @ q.T
    pos, neg, zero = la.inertia(jnp.asarray((a + a.T) / 2), conjugate=False)
    assert (int(pos), int(neg), int(zero)) == (3, 2, 0)


def test_tsqr_tree_matches_gather(grid8):
    """Butterfly tree TSQR == all-gather TSQR == reference QR."""
    import jax.numpy as jnp
    from elemental_tpu.lapack.qr import tsqr
    a = RNG.standard_normal((256, 12))
    for tree in (False, True):
        q, r = tsqr(jnp.asarray(a), grid=grid8, tree=tree)
        q, r = np.asarray(q), np.asarray(r)
        np.testing.assert_allclose(q @ r, a, atol=1e-10)
        np.testing.assert_allclose(q.T @ q, np.eye(12), atol=1e-10)
        assert np.abs(np.tril(r, -1)).max() < 1e-12


def test_bunch_kaufman_pivoted_ldl():
    """Bunch-Kaufman handles indefinite matrices with tiny diagonals where
    the unpivoted LDL breaks down; growth stays bounded."""
    import jax.numpy as jnp
    from elemental_tpu.lapack.ldl import ldl_pivoted, solve_after_pivoted
    rng = np.random.default_rng(9)
    for n, cplx in [(2, False), (31, False), (64, False), (24, True)]:
        a = rng.standard_normal((n, n))
        if cplx:
            a = a + 1j * rng.standard_normal((n, n))
        a = (a + a.conj().T) / 2
        np.fill_diagonal(a, 1e-12 * np.real(np.diag(a)))
        f = ldl_pivoted(jnp.asarray(a), conjugate=cplx)
        L, d, e, p = (np.asarray(v) for v in f)
        D = np.diag(d)
        if n > 1:
            D = D + np.diag(e, -1) + np.diag(np.conj(e) if cplx else e, 1)
        recon = L @ D @ L.conj().T if cplx else L @ D @ L.T
        err = np.abs(recon - a[np.ix_(p, p)]).max()
        assert err < 1e-12 * max(1, np.abs(a).max()) * n, err
        assert np.abs(L).max() < 10.0   # bounded growth
        b = rng.standard_normal(n)
        x = np.asarray(solve_after_pivoted(f, jnp.asarray(b),
                                           conjugate=cplx))
        assert np.linalg.norm(a @ x - b) < 1e-8 * np.linalg.norm(b)
