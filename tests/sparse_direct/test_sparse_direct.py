"""Multifrontal factor on the XLA extend-add path (scatter-add of every
child Schur complement into its parent front) against a dense LDLᵀ of the
same permuted matrix."""

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp

from elemental_tpu.matrices import sparse_laplacian_2d, sparse_laplacian_3d
from elemental_tpu.sparse import SparseMatrix
from elemental_tpu.sparse_direct import SparseLDLFactorization


def _indefinite(n, rng):
    """Symmetric quasi-definite matrix: [[H, Bᵀ], [B, -D]] with H, D SPD."""
    m = n // 3
    H = sparse_laplacian_2d(int(np.sqrt(n - m)), int(np.sqrt(n - m)),
                            scaled=False).to_scipy()
    k = H.shape[0]
    B = sp.random(m, k, density=0.05, random_state=3) + sp.eye(m, k)
    K = sp.bmat([[H, B.T], [B, -sp.eye(m) * 2.0]]).tocsr()
    return SparseMatrix.from_scipy(K)


@pytest.mark.parametrize("case,spd", [("lap2d", True), ("lap3d", True),
                                      ("lap3d", False), ("kkt", False)])
def test_factor_xla_extend_add_matches_dense_ldl(case, spd):
    rng = np.random.default_rng(5)
    if case == "lap2d":
        A = sparse_laplacian_2d(11, 13, scaled=False)
    elif case == "lap3d":
        A = sparse_laplacian_3d(6, 5, 7, scaled=False)
    else:
        A = _indefinite(120, rng)
    f = SparseLDLFactorization(spd=spd)
    f.initialize(A, cutoff=16)
    f.factor()
    # the pivots D of A[p][:, p] = L·D·Lᵀ are unique for a pivot-free LDL:
    # compare with the dense factor of the same permuted matrix
    p = np.asarray(f.symb.perm)
    Ap = A.to_dense()[np.ix_(p, p)]
    _, D, perm = sla.ldl(Ap, lower=True)
    assert np.array_equal(perm, np.arange(A.height))
    np.testing.assert_allclose(np.asarray(f.diagonal()), np.diag(D),
                               rtol=1e-10)
    b = rng.standard_normal(A.height)
    x = np.asarray(f.solve(b))
    np.testing.assert_allclose(x, np.linalg.solve(A.to_dense(), b),
                               rtol=1e-9, atol=1e-11)
