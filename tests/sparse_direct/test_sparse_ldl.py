"""Sparse-direct tests (model: reference ``tests/lapack_like/SparseLDL.cpp``:
3D Laplacian n1×n2×n3, multiple RHS, solve-vs-identity residual per RHS
``:186-210``; plus ordering/symbolic unit checks)."""

import numpy as np
import pytest

import jax.numpy as jnp

from elemental_tpu.matrices import (sparse_helmholtz_2d, sparse_laplacian_2d,
                                    sparse_laplacian_3d)
from elemental_tpu.sparse import SparseMatrix
from elemental_tpu.sparse_direct import (SparseLDLFactorization, analyze,
                                         etree, minimum_degree,
                                         natural_nested_dissection,
                                         nested_dissection, postorder,
                                         reverse_cuthill_mckee)

RNG = np.random.default_rng(41)


def _spd_sparse(n, density=0.05):
    nnz = int(n * n * density)
    rows = RNG.integers(0, n, nnz)
    cols = RNG.integers(0, n, nnz)
    vals = RNG.standard_normal(nnz)
    A = SparseMatrix.from_coo(n, n, np.concatenate([rows, cols]),
                              np.concatenate([cols, rows]),
                              np.concatenate([vals, vals]))
    return A.update_diagonal(np.full(n, 4.0 * np.abs(A.vals).max() + n * 0.1))


# -- orderings ---------------------------------------------------------------

def test_orderings_are_permutations():
    A = sparse_laplacian_2d(7, 9, scaled=False)
    n = A.height
    for perm in (minimum_degree(A), nested_dissection(A, cutoff=8),
                 reverse_cuthill_mckee(A),
                 natural_nested_dissection((7, 9))):
        assert sorted(perm.tolist()) == list(range(n)), perm


def test_ordering_reduces_fill():
    A = sparse_laplacian_2d(12, 12, scaled=False)
    sy_nat = analyze(A, perm=np.arange(A.height))
    sy_nd = analyze(A)
    assert sy_nd.nnz_factor < sy_nat.nnz_factor  # ND beats natural order


def test_etree_postorder():
    # arrow matrix: all columns point to the last
    n = 6
    rows = np.concatenate([np.arange(n), np.full(n - 1, n - 1),
                           np.arange(n - 1)])
    cols = np.concatenate([np.arange(n), np.arange(n - 1),
                           np.full(n - 1, n - 1)])
    A = SparseMatrix.from_coo(n, n, rows, cols, np.ones(len(rows)))
    par = etree(A)
    assert all(par[j] == n - 1 for j in range(n - 1)) and par[n - 1] == -1
    po = postorder(par)
    assert po[-1] == n - 1


# -- multifrontal factor + solve ----------------------------------------------

@pytest.mark.parametrize("dims", [(8, 8), (5, 7)])
def test_sparse_ldl_2d_laplacian(dims):
    A = sparse_laplacian_2d(*dims, scaled=False)
    n = A.height
    f = SparseLDLFactorization().initialize(A).factor()
    b = RNG.standard_normal((n, 3))
    x = np.asarray(f.solve(jnp.asarray(b)))
    res = np.abs(A.to_dense() @ x - b).max()
    assert res < 1e-10, res


def test_sparse_ldl_3d_reference_scenario():
    """The reference's acceptance scenario (SparseLDL.cpp): 3D Laplacian,
    multiple RHS, per-RHS residual."""
    A = sparse_laplacian_3d(6, 6, 6, scaled=False)
    n = A.height
    f = SparseLDLFactorization().initialize(A).factor()
    X = RNG.standard_normal((n, 5))
    B = A.to_dense() @ X
    Xs = np.asarray(f.solve(jnp.asarray(B)))
    for j in range(5):
        rel = (np.linalg.norm(Xs[:, j] - X[:, j])
               / np.linalg.norm(X[:, j]))
        assert rel < 1e-9, (j, rel)


def test_sparse_ldl_random_spd():
    A = _spd_sparse(80)
    f = SparseLDLFactorization().initialize(A).factor()
    b = RNG.standard_normal(80)
    x = np.asarray(f.solve(jnp.asarray(b)))
    np.testing.assert_allclose(A.to_dense() @ x, b, atol=1e-8)


def test_sparse_ldl_indefinite():
    """Quasi-definite (IPM-style) matrix — LDL without pivoting + inertia."""
    m, n = 12, 20
    Adense = RNG.standard_normal((m, n)) * (RNG.random((m, n)) < 0.3)
    K = np.block([[np.eye(n), Adense.T], [Adense, -np.eye(m)]])
    A = SparseMatrix.from_dense(K)
    f = SparseLDLFactorization().initialize(A).factor()
    pos, neg, zero = f.inertia()
    assert (int(pos), int(neg)) == (n, m)
    b = RNG.standard_normal(n + m)
    x = np.asarray(f.solve(jnp.asarray(b)))
    np.testing.assert_allclose(K @ x, b, atol=1e-8)


def test_change_nonzero_values_refactor():
    A = sparse_laplacian_2d(6, 6, scaled=False)
    f = SparseLDLFactorization().initialize(A).factor()
    newvals = np.asarray(A.vals) * 2.0 + RNG.standard_normal(A.nnz) * 0.01
    # keep symmetric: symmetrize via dense round trip
    D = A.change_nonzero_values(newvals).to_dense()
    D = (D + D.T) / 2 + 8 * np.eye(36)
    A2 = SparseMatrix.from_dense(D)
    # same pattern (laplacian pattern includes diagonal) → reuse symbolic
    assert A2.nnz == A.nnz
    f.change_nonzero_values(A2.vals)
    b = RNG.standard_normal(36)
    x = np.asarray(f.solve(jnp.asarray(b)))
    np.testing.assert_allclose(D @ x, b, atol=1e-9)


def test_regularized_ldl_with_refinement():
    A = sparse_laplacian_2d(8, 8, scaled=False)
    n = A.height
    reg = np.full(n, 1e-3)
    f = SparseLDLFactorization().initialize(A).factor(reg=reg)
    b = RNG.standard_normal(n)
    x = np.asarray(f.solve_with_iterative_refinement(jnp.asarray(b),
                                                     iters=10))
    np.testing.assert_allclose(A.to_dense() @ x, b, atol=1e-9)


def test_multiply_with_l():
    """A = P·L·D·Lᵀ·Pᵀ: composing multiply_with_l(adjoint) → D →
    multiply_with_l must reproduce A·v (in permuted order)."""
    A = sparse_laplacian_2d(5, 5, scaled=False)
    n = A.height
    f = SparseLDLFactorization().initialize(A).factor()
    v = RNG.standard_normal(n)
    perm = f.symb.perm
    vp = jnp.asarray(v[perm])
    lt_v = f.multiply_with_l(vp, adjoint=True)
    w = np.asarray(f.multiply_with_l(f.diagonal() * lt_v))
    expect = (A.to_dense() @ v)[perm]
    np.testing.assert_allclose(w, expect, atol=1e-9)


def test_helmholtz_indefinite_solve():
    A = sparse_helmholtz_2d(10, 10, shift=30.0)
    n = A.height
    f = SparseLDLFactorization().initialize(A).factor()
    b = RNG.standard_normal(n)
    x = np.asarray(f.solve(jnp.asarray(b)))
    np.testing.assert_allclose(A.to_dense() @ x, b, atol=1e-7)


def test_factor_gflops_accounting():
    A = sparse_laplacian_2d(10, 10, scaled=False)
    f = SparseLDLFactorization().initialize(A)
    assert f.factor_gflops() > 0
    assert f.factor_nnz() >= A.nnz // 2


def test_blocked_front_kernel_matches_rank1():
    """The blocked right-looking front kernel must agree with the
    rank-1 reference kernel on random padded fronts."""
    import jax.numpy as jnp
    from elemental_tpu.sparse_direct import numeric as N
    rng = np.random.default_rng(0)
    S = 70
    for ns in (1, 17, 33, 64, 70):
        Q = rng.standard_normal((S, S))
        F = Q @ Q.T + S * np.eye(S)       # SPD ⇒ no pivoting issues
        a = N._masked_partial_ldl(jnp.asarray(F), jnp.asarray(ns), ns,
                                  False)
        b = N._masked_partial_ldl_blocked(jnp.asarray(F), jnp.asarray(ns),
                                          ns, False, nb=16)
        # compare the lower triangle (panel L + Schur); upper is scratch
        al = np.tril(np.asarray(a))
        bl = np.tril(np.asarray(b))
        assert np.abs(al - bl).max() < 1e-10 * np.abs(al).max(), ns


def test_subtree_to_device_sharded_factor_matches_single_device(grid8):
    """factor(mesh=...) shards each level's fronts over the mesh
    (subtree→subteam); results must match the unsharded factorization."""
    from elemental_tpu.matrices import sparse_laplacian_3d
    from elemental_tpu.sparse_direct import SparseLDLFactorization
    import jax
    from jax.sharding import Mesh
    A = sparse_laplacian_3d(7, 7, 7, scaled=False)
    n = A.height
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal((n, 2))
    b = A.to_scipy() @ x_true

    mesh = Mesh(np.asarray(jax.devices("cpu")), ("tree",))
    f = SparseLDLFactorization(mesh=mesh, tree_axis="tree")
    f.initialize(A).factor()
    x = np.asarray(f.solve(jnp.asarray(b)))
    rel = np.abs(x - x_true).max() / np.abs(x_true).max()
    assert rel < 1e-8, rel

    f0 = SparseLDLFactorization()
    f0.initialize(A).factor()
    x0 = np.asarray(f0.solve(jnp.asarray(b)))
    assert np.abs(x - x0).max() < 1e-9 * np.abs(x0).max()


def test_spd_cholesky_fast_path_matches_ldl():
    """factor(spd=True): batched XLA chol+trsm+matmul per level must give
    the same factorization (and solves) as the LDL kernels."""
    from elemental_tpu.matrices import sparse_laplacian_3d
    from elemental_tpu.sparse_direct import SparseLDLFactorization
    A = sparse_laplacian_3d(8, 8, 8, scaled=False)
    n = A.height
    rng = np.random.default_rng(1)
    x_true = rng.standard_normal((n, 3))
    b = A.to_scipy() @ x_true
    f = SparseLDLFactorization(spd=True)
    f.initialize(A).factor()
    x = np.asarray(f.solve(jnp.asarray(b)))
    assert np.abs(x - x_true).max() < 1e-8 * np.abs(x_true).max()
    f0 = SparseLDLFactorization()
    f0.initialize(A).factor()
    assert np.abs(np.asarray(f.numeric.d)
                  - np.asarray(f0.numeric.d)).max() < 1e-10
