"""DIA stencil SpMV tests (the XLA DIA form ``plan_spmv`` dispatches
banded matrices to)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from elemental_tpu.matrices import sparse_laplacian_2d, sparse_laplacian_3d
from elemental_tpu.sparse import SparseMatrix, to_dia

RNG = np.random.default_rng(31)


def _banded(n, offs):
    rows, cols, vals = [], [], []
    for off in offs:
        lo, hi = max(0, -off), min(n, n - off)
        r = np.arange(lo, hi)
        rows.append(r)
        cols.append(r + off)
        vals.append(RNG.standard_normal(hi - lo))
    return SparseMatrix.from_coo(n, n, np.concatenate(rows),
                                 np.concatenate(cols), np.concatenate(vals))


def test_to_dia_roundtrip():
    A = sparse_laplacian_2d(6, 6, scaled=False)
    dia = to_dia(A)
    assert dia is not None and len(dia.offsets) == 5
    x = RNG.standard_normal(36)
    y = np.asarray(dia.device().matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-12)


def test_to_dia_rejects_unstructured():
    nnz = 500
    A = SparseMatrix.from_coo(100, 100, RNG.integers(0, 100, nnz),
                              RNG.integers(0, 100, nnz),
                              RNG.standard_normal(nnz))
    assert to_dia(A) is None  # too many distinct diagonals


@pytest.mark.parametrize("dims", [(12, 12), (8, 16)])
def test_stencil_plan_xla_math(dims):
    A = sparse_laplacian_2d(*dims, scaled=False)
    dia = to_dia(A)
    assert dia.offsets == (-dims[1], -1, 0, 1, dims[1])
    x = RNG.standard_normal(A.width)
    y = np.asarray(jax.jit(lambda d, v: d.matvec(v))(dia.device(),
                                                     jnp.asarray(x)))
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-10)


def test_stencil_plan_3d():
    A = sparse_laplacian_3d(5, 5, 5, scaled=False)
    dia = to_dia(A)
    assert len(dia.offsets) == 7
    X = RNG.standard_normal((125, 3))
    Y = np.asarray(dia.device().matmat(jnp.asarray(X)))
    np.testing.assert_allclose(Y, A.to_dense() @ X, rtol=1e-10)


def test_stencil_banded_random():
    """General banded matrix (not a PDE stencil)."""
    n = 200
    A = _banded(n, [-13, -1, 0, 2, 17])
    dia = to_dia(A)
    x = RNG.standard_normal(n)
    y = np.asarray(dia.device().matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-10)


def test_to_dia_rectangular_offsets():
    """Offsets beyond the square part (width > height) stay exact."""
    A = SparseMatrix.from_coo(4, 7, [0, 1, 2, 3, 3], [0, 5, 2, 6, 0],
                              [1.0, 2.0, 3.0, 4.0, 5.0])
    dia = to_dia(A)
    assert dia.offsets == (-3, 0, 3, 4)
    x = RNG.standard_normal(7)
    y = np.asarray(dia.device().matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-12)
