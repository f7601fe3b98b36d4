"""auto_plan.plan_spmv dispatch + correctness (reference analog:
tests/blas_like/Multiply.cpp cross-implementation agreement)."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax

from elemental_tpu.matrices import sparse_laplacian_2d, sparse_laplacian_3d
from elemental_tpu.sparse import SparseMatrix, plan_spmv


def _check(plan, A, rng, dtype=np.float32):
    x = rng.standard_normal(A.width).astype(dtype)
    xp = jax.numpy.asarray(plan.to_plan_space(x))
    y = np.asarray(jax.jit(lambda p, v: p.matvec(v))(plan, xp))
    y = plan.from_plan_space(y)
    expect = A.to_scipy().astype(np.float64) @ x.astype(np.float64)
    tol = 1e-5 if dtype == np.float32 else 1e-12
    assert np.abs(y - expect).max() <= tol * max(1.0, np.abs(expect).max())


def _scrambled_banded(rng, n=512, bw=6):
    offs = range(-bw, bw + 1)
    S = sp.diags([rng.standard_normal(n) for _ in offs], list(offs),
                 shape=(n, n), format="csr")
    S = S + S.T                       # symmetric banded
    p = rng.permutation(n)            # scramble
    return SparseMatrix.from_scipy(S[p][:, p].tocsr())


def test_laplacian_direct_stencil():
    A = sparse_laplacian_2d(24, 24, scaled=False)
    A = SparseMatrix.from_scipy(A.to_scipy().astype(np.float32))
    plan = plan_spmv(A)
    assert plan.kind == "stencil" and plan.dia is not None
    _check(plan, A, np.random.default_rng(0))


def test_scrambled_banded_recovers_via_rcm():
    rng = np.random.default_rng(1)
    A = _scrambled_banded(rng)
    A = SparseMatrix.from_scipy(A.to_scipy().astype(np.float32))
    plan = plan_spmv(A)
    assert plan.kind == "stencil_rcm"
    assert plan.perm is not None
    _check(plan, A, rng)


def test_unstructured_falls_back_to_csr():
    rng = np.random.default_rng(2)
    n, k = 256, 4
    rows = np.repeat(np.arange(n), k)
    cols = rng.integers(0, n, n * k)
    vals = rng.standard_normal(n * k).astype(np.float32)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    A = SparseMatrix.from_scipy(S)
    plan = plan_spmv(A)
    assert plan.kind == "csr" and plan.csr is not None
    _check(plan, A, rng)
    # without the RCM attempt the plan is the same CSR tier
    assert plan_spmv(A, try_rcm=False).kind == "csr"


def test_rectangular_uses_ell_or_stencil():
    rng = np.random.default_rng(3)
    S = sp.random(96, 128, density=0.05, format="csr",
                  random_state=4, dtype=np.float32)
    A = SparseMatrix.from_scipy(S)
    plan = plan_spmv(A)
    _check(plan, A, rng)


def test_stream_bytes_accounting():
    A = sparse_laplacian_2d(16, 16, scaled=False)
    A = SparseMatrix.from_scipy(A.to_scipy().astype(np.float32))
    plan = plan_spmv(A)
    # 5 diagonals + x + y, 4 bytes each, per row
    assert plan.stream_bytes == (5 + 2) * 256 * 4
    S = sp.random(256, 256, density=0.05, format="csr", random_state=6,
                  dtype=np.float32)
    B = SparseMatrix.from_scipy(S)
    csr = plan_spmv(B, try_rcm=False)
    assert csr.kind == "csr"
    # values + two int32 index streams per nonzero, plus x and y
    assert csr.stream_bytes == B.nnz * 12 + 2 * 256 * 4


def _case(name, rng):
    if name == "lap2d":
        return sparse_laplacian_2d(20, 17, scaled=False), "stencil"
    if name == "lap3d":
        return sparse_laplacian_3d(7, 6, 5, scaled=False), "stencil"
    if name == "rcm":
        return _scrambled_banded(rng, n=300, bw=4), "stencil_rcm"
    if name == "rect":
        S = sp.random(80, 120, density=0.04, format="csr", random_state=5)
        return SparseMatrix.from_scipy(S), None
    raise ValueError(name)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", ["lap2d", "lap3d", "rcm", "rect"])
def test_plan_matches_scipy(name, dtype):
    """Every tier plan_spmv can pick agrees with scipy in f32 and f64."""
    rng = np.random.default_rng(11)
    A, kind = _case(name, rng)
    plan = plan_spmv(A).device(dtype=dtype)
    if kind is not None:
        assert plan.kind == kind
    _check(plan, A, rng, dtype)
