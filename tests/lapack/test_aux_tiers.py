"""Tests for control, io, 3D gemm, tridiag-eig (MRRR slot), FlamePart/Proxy,
native ordering."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from elemental_tpu import control, io as elio
from elemental_tpu.core import MC, MR, distribute
from elemental_tpu.core.flamepart import (merge_2x2, partition_down,
                                          repartition_down_diagonal)
from elemental_tpu.core.proxy import ReadProxy, ReadWriteProxy
from elemental_tpu.lapack import tridiag_eig, tridiag_eigvalsh
from elemental_tpu.lapack.spectral import hermitian_tridiag_eig
from elemental_tpu.ops import gemm_3d, make_3d_mesh

RNG = np.random.default_rng(61)


# -- control ------------------------------------------------------------------

def test_sylvester():
    m, n = 12, 9
    A = RNG.standard_normal((m, m))
    A = A @ A.T / 10 + 2 * np.eye(m)       # spectra in right half-plane
    B = RNG.standard_normal((n, n))
    B = B @ B.T / 10 + 2 * np.eye(n)
    X0 = RNG.standard_normal((m, n))
    C = A @ X0 + X0 @ B
    X = np.asarray(control.sylvester(jnp.asarray(A), jnp.asarray(B),
                                     jnp.asarray(C)))
    np.testing.assert_allclose(X, X0, rtol=1e-6, atol=1e-7)


def test_lyapunov():
    n = 10
    A = RNG.standard_normal((n, n))
    A = A @ A.T / 10 + 2 * np.eye(n)
    X0 = RNG.standard_normal((n, n))
    X0 = X0 + X0.T
    C = A @ X0 + X0 @ A.T
    X = np.asarray(control.lyapunov(jnp.asarray(A), jnp.asarray(C)))
    np.testing.assert_allclose(X, X0, rtol=1e-6, atol=1e-7)


def test_riccati():
    n = 6
    A = -2 * np.eye(n) + 0.1 * RNG.standard_normal((n, n))
    K = np.eye(n)
    L = np.eye(n) * 0.5
    X = np.asarray(control.ricatti_hamiltonian(jnp.asarray(A),
                                               jnp.asarray(K),
                                               jnp.asarray(L)))
    res = A.T @ X + X @ A + K - X @ L @ X
    assert np.abs(res).max() < 1e-6
    # stabilizing solution is symmetric PSD
    np.testing.assert_allclose(X, X.T, atol=1e-8)
    assert np.linalg.eigvalsh((X + X.T) / 2).min() > -1e-8


# -- io -----------------------------------------------------------------------

def test_io_roundtrips(tmp_path):
    a = RNG.standard_normal((7, 5))
    for fmt in ("ascii", "binary", "binary_flat", "matrix_market"):
        p = str(tmp_path / f"m.{fmt}")
        elio.write(p, jnp.asarray(a), fmt=fmt)
        back = np.asarray(elio.read(p, fmt=fmt, shape=a.shape))
        np.testing.assert_allclose(back, a, rtol=1e-12)
    # matlab format is write-only; just exercise it
    elio.write(str(tmp_path / "m.m"), jnp.asarray(a), fmt="ascii_matlab")
    import io as _io
    buf = _io.StringIO()
    elio.print_matrix(jnp.asarray(a), "t", file=buf)
    assert "t" in buf.getvalue()


def test_display_spy(tmp_path):
    a = RNG.standard_normal((6, 6))
    elio.display(jnp.asarray(a), "d", save=str(tmp_path / "d.png"))
    from elemental_tpu.sparse import SparseMatrix
    elio.spy(SparseMatrix.from_dense(np.triu(a)), save=str(tmp_path / "s.png"))
    assert (tmp_path / "d.png").exists() and (tmp_path / "s.png").exists()


# -- 3D gemm -------------------------------------------------------------------

def test_gemm_3d(grid8):
    mesh = make_3d_mesh(jax.devices("cpu"), depth=2)
    m = k = n = 32
    a = RNG.standard_normal((m, k)).astype(np.float32)
    b = RNG.standard_normal((k, n)).astype(np.float32)
    c = np.asarray(gemm_3d(jnp.asarray(a), jnp.asarray(b), mesh))
    np.testing.assert_allclose(c, a @ b, rtol=1e-4, atol=1e-4)


# -- tridiag eig (PMRRR slot) ---------------------------------------------------

def test_tridiag_bisection_eigenvalues():
    n = 60
    d = RNG.standard_normal(n)
    e = RNG.standard_normal(n - 1)
    w = np.asarray(tridiag_eigvalsh(jnp.asarray(d), jnp.asarray(e)))
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(T), atol=1e-10)


def test_tridiag_bisection_subset():
    n = 40
    d = RNG.standard_normal(n)
    e = RNG.standard_normal(n - 1)
    w = np.asarray(tridiag_eigvalsh(jnp.asarray(d), jnp.asarray(e),
                                    select=(5, 14)))
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(w, np.linalg.eigvalsh(T)[5:15], atol=1e-10)


def test_tridiag_eig_vectors():
    n = 50
    d = RNG.standard_normal(n)
    e = RNG.standard_normal(n - 1)
    w, Z = tridiag_eig(jnp.asarray(d), jnp.asarray(e))
    w, Z = np.asarray(w), np.asarray(Z)
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    res = np.abs(T @ Z - Z * w[None, :]).max()
    assert res < 1e-7, res
    # orthogonality (loose — one GS sweep)
    ortho = np.abs(Z.T @ Z - np.eye(n)).max()
    assert ortho < 1e-5, ortho


def test_hermitian_tridiag_eig_mrrr_path():
    n = 30
    d = RNG.standard_normal(n)
    e = RNG.standard_normal(n - 1)
    w, Z = hermitian_tridiag_eig(jnp.asarray(d), jnp.asarray(e), alg="mrrr")
    T = np.diag(d) + np.diag(e, 1) + np.diag(e, -1)
    np.testing.assert_allclose(np.asarray(w), np.linalg.eigvalsh(T),
                               atol=1e-9)


# -- FlamePart / Proxy ----------------------------------------------------------

def test_flamepart():
    a = jnp.asarray(RNG.standard_normal((10, 10)))
    top, bot = partition_down(a, 4)
    assert top.shape == (4, 10) and bot.shape == (6, 10)
    blocks = repartition_down_diagonal(a, 3, 4)
    recon = merge_2x2(
        merge_2x2(blocks[0], blocks[1], blocks[3], blocks[4]),
        jnp.concatenate([blocks[2], blocks[5]], axis=0),
        jnp.concatenate([blocks[6], blocks[7]], axis=1),
        blocks[8])
    np.testing.assert_array_equal(np.asarray(recon), np.asarray(a))


def test_proxy(grid8):
    from elemental_tpu.core import VC, STAR
    a = RNG.standard_normal((16, 16)).astype(np.float32)
    A = distribute(a, MC, MR, grid8)
    p = ReadProxy(A, VC, STAR)
    assert p.get().dist() == (VC, STAR)
    rw = ReadWriteProxy(A, VC, STAR)
    out = rw.restore(rw.value)
    assert out.dist() == (MC, MR)
    np.testing.assert_array_equal(out.to_numpy(), a)


def test_native_minimum_degree():
    from elemental_tpu.sparse_direct import native
    if not native.available():
        pytest.skip("native lib not built")
    adj = [np.array([1, 2]), np.array([0, 2]), np.array([0, 1, 3]),
           np.array([2])]
    p = native.minimum_degree(adj)
    assert sorted(p.tolist()) == [0, 1, 2, 3]
    assert p[0] == 3  # degree-1 vertex eliminated first


def test_ricatti_overloads():
    """ricatti(W) and ricatti(uplo, A, K, L) match solve_continuous_are."""
    import scipy.linalg as sla
    import jax.numpy as jnp
    from elemental_tpu import control
    rng = np.random.default_rng(11)
    n = 6
    A = rng.standard_normal((n, n)) - 3 * np.eye(n)
    B = rng.standard_normal((n, 2))
    Q = rng.standard_normal((n, n)); Q = Q @ Q.T + np.eye(n)
    L = B @ B.T
    ref = sla.solve_continuous_are(A, B, Q, np.eye(2))
    W = np.block([[A, -L], [-Q, -A.T]])
    X1 = np.asarray(control.ricatti(jnp.asarray(W)))
    np.testing.assert_allclose(X1, ref, rtol=1e-6, atol=1e-8)
    X2 = np.asarray(control.ricatti("L", jnp.asarray(A),
                                    jnp.asarray(np.tril(Q)),
                                    jnp.asarray(np.tril(L))))
    np.testing.assert_allclose(X2, ref, rtol=1e-6, atol=1e-8)
