"""Sparse tier tests (model: reference ``tests/blas_like/Multiply.cpp``
cross-implementation agreement + builder protocol from
``examples/interface/BP.py``)."""

import numpy as np
import pytest

import jax.numpy as jnp

from elemental_tpu.sparse import (BSRMatrix, Graph, SparseBuilder,
                                  SparseMatrix, DistSparseMatrix,
                                  DistMultiVec, multiply, spgemm,
                                  spgemm_plan, galerkin_plan, syrk_sparse)
from elemental_tpu.matrices import (sparse_laplacian_2d, sparse_laplacian_3d,
                                    sparse_helmholtz_2d)

RNG = np.random.default_rng(17)


def _random_sparse(m, n, density=0.1, dtype=np.float64):
    nnz = int(m * n * density)
    rows = RNG.integers(0, m, nnz)
    cols = RNG.integers(0, n, nnz)
    vals = RNG.standard_normal(nnz).astype(dtype)
    return SparseMatrix.from_coo(m, n, rows, cols, vals)


def test_builder_protocol():
    """QueueUpdate/ProcessQueues assembly (BP.py:20-40 pattern)."""
    b = SparseBuilder(4, 4)
    b.queue_update(0, 0, 2.0)
    b.queue_update(1, 2, 3.0)
    b.queue_update(0, 0, 1.0)  # duplicate → summed
    A = b.process_queues()
    d = A.to_dense()
    assert d[0, 0] == 3.0 and d[1, 2] == 3.0 and A.nnz == 2


def test_csr_roundtrips():
    A = _random_sparse(30, 20)
    dense = A.to_dense()
    B = SparseMatrix.from_dense(dense)
    np.testing.assert_array_equal(B.to_dense(), dense)
    np.testing.assert_array_equal(A.transpose().to_dense(), dense.T)
    sp = A.to_scipy()
    C = SparseMatrix.from_scipy(sp)
    np.testing.assert_array_equal(C.to_dense(), dense)


def test_spmv_ell_vs_csr_vs_dense():
    """Cross-implementation agreement (Multiply.cpp:35-43 trick)."""
    A = _random_sparse(50, 40)
    x = RNG.standard_normal(40)
    expect = A.to_dense() @ x
    y_ell = np.asarray(A.device_ell().matvec(jnp.asarray(x)))
    y_csr = np.asarray(A.device_csr().matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y_ell, expect, rtol=1e-12)
    np.testing.assert_allclose(y_csr, expect, rtol=1e-12)
    # graph SpMV agreement (pattern × ones)
    g = A.graph()
    y_graph = np.asarray(multiply("N", 1.0, g, jnp.asarray(x)))
    np.testing.assert_allclose(y_graph, (A.to_dense() != 0) @ x, rtol=1e-12)


def test_multiply_api():
    A = _random_sparse(25, 30)
    x = RNG.standard_normal(30)
    y = RNG.standard_normal(25)
    out = np.asarray(multiply("N", 2.0, A, jnp.asarray(x), -1.0,
                              jnp.asarray(y)))
    np.testing.assert_allclose(out, 2.0 * A.to_dense() @ x - y, rtol=1e-12)
    xt = RNG.standard_normal(25)
    out = np.asarray(multiply("T", 1.0, A, jnp.asarray(xt)))
    np.testing.assert_allclose(out, A.to_dense().T @ xt, rtol=1e-12)


def test_spmm():
    A = _random_sparse(40, 30)
    X = RNG.standard_normal((30, 7))
    out = np.asarray(A.device_ell().matmat(jnp.asarray(X)))
    np.testing.assert_allclose(out, A.to_dense() @ X, rtol=1e-12)


def test_bsr_matvec():
    A = _random_sparse(37, 37, 0.15)
    bsr = BSRMatrix.from_sparse(A, 8)
    x = RNG.standard_normal(37)
    np.testing.assert_allclose(np.asarray(bsr.device().matvec(jnp.asarray(x))),
                               A.to_dense() @ x, rtol=1e-10)
    np.testing.assert_allclose(bsr.to_dense(), A.to_dense(), rtol=1e-12)


def test_spgemm_vs_scipy():
    A = _random_sparse(30, 40, 0.1)
    B = _random_sparse(40, 25, 0.1)
    C = spgemm(A, B)
    expect = (A.to_scipy() @ B.to_scipy()).toarray()
    np.testing.assert_allclose(C.to_dense(), expect, rtol=1e-10, atol=1e-12)


def test_spgemm_plan_reuse():
    """Fixed structure, changing values — the IPM per-iteration path."""
    A = _random_sparse(20, 30, 0.15)
    B = _random_sparse(30, 20, 0.15)
    plan = spgemm_plan(A, B)
    for _ in range(3):
        new_vals = RNG.standard_normal(A.nnz)
        A2 = A.change_nonzero_values(new_vals)
        c_vals = np.asarray(plan.numeric(jnp.asarray(A2.vals),
                                         jnp.asarray(B.vals)))
        C = plan.c_struct.change_nonzero_values(c_vals)
        np.testing.assert_allclose(C.to_dense(),
                                   (A2.to_scipy() @ B.to_scipy()).toarray(),
                                   rtol=1e-10, atol=1e-12)


def test_galerkin_adat():
    """A·diag(d)·Aᵀ — the Galerkin configuration."""
    A = _random_sparse(25, 40, 0.12)
    d = np.abs(RNG.standard_normal(40)) + 0.1
    C = syrk_sparse(A, d)
    expect = A.to_dense() @ np.diag(d) @ A.to_dense().T
    np.testing.assert_allclose(C.to_dense(), expect, rtol=1e-10, atol=1e-12)
    # plan reuse with new d
    plan = galerkin_plan(A)
    d2 = np.abs(RNG.standard_normal(40)) + 0.1
    vals = np.asarray(plan.numeric(jnp.asarray(A.vals), jnp.asarray(d2)))
    C2 = plan.c_struct.change_nonzero_values(vals)
    np.testing.assert_allclose(C2.to_dense(),
                               A.to_dense() @ np.diag(d2) @ A.to_dense().T,
                               rtol=1e-10, atol=1e-12)


def test_laplacian_2d_structure():
    A = sparse_laplacian_2d(4, 4, scaled=False)
    d = A.to_dense()
    assert np.allclose(d, d.T)
    assert np.all(np.diag(d) == 4.0)
    w = np.linalg.eigvalsh(d)
    assert w.min() > 0  # positive definite with Dirichlet boundaries
    # analytic smallest eigenvalue: 4 - 2cos(pi/5) - 2cos(pi/5)
    expect = 4 - 4 * np.cos(np.pi / 5)
    np.testing.assert_allclose(w.min(), expect, rtol=1e-10)


def test_helmholtz_shift():
    A = sparse_laplacian_2d(5, 5)
    H = sparse_helmholtz_2d(5, 5, shift=7.0)
    np.testing.assert_allclose(H.to_dense(), A.to_dense() - 7.0 * np.eye(25),
                               rtol=1e-12)


def test_dist_spmv(grid8):
    """Distributed SpMV over the 8-device mesh vs dense oracle."""
    A = sparse_laplacian_2d(16, 16)
    dA = DistSparseMatrix.from_sparse(A, grid8)
    x = RNG.standard_normal(256)
    y = np.asarray(dA.matvec(jnp.asarray(x)))
    np.testing.assert_allclose(y, A.to_dense() @ x, rtol=1e-10)


def test_dist_spmm(grid8):
    A = sparse_laplacian_3d(6, 6, 6)
    dA = DistSparseMatrix.from_sparse(A, grid8)
    X = RNG.standard_normal((216, 4))
    y = np.asarray(dA.matmat(jnp.asarray(X)))
    np.testing.assert_allclose(y, A.to_dense() @ X, rtol=1e-10)


def test_dist_change_nonzero_values(grid8):
    A = sparse_laplacian_2d(8, 8)
    dA = DistSparseMatrix.from_sparse(A, grid8)
    newvals = RNG.standard_normal(A.nnz)
    dA2 = dA.change_nonzero_values(newvals)
    x = RNG.standard_normal(64)
    np.testing.assert_allclose(
        np.asarray(dA2.matvec(jnp.asarray(x))),
        A.change_nonzero_values(newvals).to_dense() @ x, rtol=1e-10)


def test_cg_on_sparse_laplacian(grid8):
    """SURVEY §7 minimum end-to-end slice: 2D Laplacian CSR, row-partitioned
    over the mesh, CG-solved with residual check."""
    from elemental_tpu.lapack import cg
    A = sparse_laplacian_2d(16, 16)
    dA = DistSparseMatrix.from_sparse(A, grid8)
    b = RNG.standard_normal(256)
    res = cg(lambda v: dA.matvec(v), jnp.asarray(b), tol=1e-10,
             max_iters=2000)
    x = np.asarray(res.x)
    assert np.linalg.norm(A.to_dense() @ x - b) / np.linalg.norm(b) < 1e-8


def test_graph_ops():
    g = Graph.from_edges(5, 5, [0, 1, 2, 0], [1, 2, 3, 4])
    assert g.num_edges == 4
    assert list(g.neighbors(0)) == [1, 4]
    sym = g.symmetrize()
    assert sym.num_edges == 8


def test_symmetric_scale_and_diag():
    A = _random_sparse(20, 20, 0.2)
    d = np.abs(RNG.standard_normal(20)) + 0.5
    scaled = A.symmetric_scale(d)
    np.testing.assert_allclose(scaled.to_dense(),
                               np.diag(d) @ A.to_dense() @ np.diag(d),
                               rtol=1e-12)
    A2 = A.update_diagonal(np.ones(20))
    np.testing.assert_allclose(A2.to_dense(), A.to_dense() + np.eye(20),
                               rtol=1e-12)


def test_dist_spmv_transpose(grid8):
    """Distributed transpose SpMV via the reversed halo exchange
    (reference Multiply(TRANSPOSE, DistSparseMatrix, ...))."""
    import scipy.sparse as sp
    R = sp.random(100, 75, density=0.08, format="csr", random_state=3)
    A = SparseMatrix.from_scipy(R)
    dA = DistSparseMatrix.from_sparse(A, grid8)
    x = RNG.standard_normal(100)
    np.testing.assert_allclose(np.asarray(dA.matvec_transpose(x)),
                               R.T @ x, rtol=1e-10, atol=1e-12)
    X = RNG.standard_normal((100, 3))
    np.testing.assert_allclose(np.asarray(dA.matmat_transpose(X)),
                               R.T @ X, rtol=1e-10, atol=1e-12)


def test_dist_multiply_orientations(grid8):
    from elemental_tpu.sparse.matmul import multiply
    A = sparse_laplacian_2d(10, 10)
    dA = DistSparseMatrix.from_sparse(A, grid8)
    x = RNG.standard_normal(100)
    np.testing.assert_allclose(np.asarray(multiply("T", 2.0, dA, x)),
                               2.0 * A.to_dense().T @ x, rtol=1e-10)


def test_dist_spmv_no_full_allgather(grid8):
    """The halo-compressed SpMV must NOT replicate x: the compiled HLO's
    collectives move only the footprint (p·H ≪ n); assert no all-gather of
    the full vector appears."""
    import jax
    A = sparse_laplacian_2d(16, 16)      # n = 256; halo H = 16 per shard
    dA = DistSparseMatrix.from_sparse(A, grid8)

    def run(lrows, lcols, lvals, sidx, x):
        import dataclasses as dc
        d = dc.replace(dA, lrows=lrows, lcols=lcols, lvals=lvals,
                       send_idx=sidx)
        return d.matvec(x)

    x = jnp.zeros(256)
    txt = jax.jit(run).lower(dA.lrows, dA.lcols, dA.lvals, dA.send_idx,
                             x).compile().as_text()
    # all-to-all of the halo plan is expected; a full-size all-gather
    # (producing a 256-element replicated operand) is the failure mode
    bad = [ln for ln in txt.splitlines()
           if "all-gather" in ln and "f64[256" in ln.replace(" ", "")]
    assert not bad, bad[:2]


def test_dist_spgemm_matches_single_chip(grid8):
    """Distributed SpGEMM == single-device spgemm on the 8-device mesh, rectangular + non-divisible shapes."""
    import scipy.sparse as sp
    from elemental_tpu.sparse.matmul import dist_spgemm, spgemm
    Ra = sp.random(83, 61, density=0.1, format="csr", random_state=5)
    Rb = sp.random(61, 47, density=0.12, format="csr", random_state=6)
    A = SparseMatrix.from_scipy(Ra)
    B = SparseMatrix.from_scipy(Rb)
    dA = DistSparseMatrix.from_sparse(A, grid8)
    dB = DistSparseMatrix.from_sparse(B, grid8)
    dC = dist_spgemm(dA, dB)
    C = spgemm(A, B)
    np.testing.assert_allclose(dC.host.to_dense(), C.to_dense(),
                               rtol=1e-10, atol=1e-12)
    # device values match too
    x = RNG.standard_normal(47)
    np.testing.assert_allclose(np.asarray(dC.matvec(x)),
                               C.to_dense() @ x, rtol=1e-9, atol=1e-10)


def test_dist_galerkin_matches_syrk(grid8):
    from elemental_tpu.sparse.matmul import dist_galerkin, syrk_sparse
    import scipy.sparse as sp
    Ra = sp.random(40, 64, density=0.15, format="csr", random_state=7)
    A = SparseMatrix.from_scipy(Ra)
    d = np.abs(RNG.standard_normal(64)) + 0.5
    dA = DistSparseMatrix.from_sparse(A, grid8)
    dC = dist_galerkin(dA, d)
    C = syrk_sparse(A, d)
    np.testing.assert_allclose(dC.host.to_dense(), C.to_dense(),
                               rtol=1e-10, atol=1e-12)


def test_dist_spgemm_no_full_gather(grid8):
    """The distributed SpGEMM numeric must ship only the entry-compressed
    halo: assert no all-gather materializing B's full value array."""
    import jax
    from elemental_tpu.sparse.matmul import dist_spgemm_plan
    import scipy.sparse as sp
    Ra = sp.random(96, 96, density=0.06, format="csr", random_state=8)
    A = SparseMatrix.from_scipy(Ra)
    dA = DistSparseMatrix.from_sparse(A, grid8)
    plan = dist_spgemm_plan(dA, dA)
    p = grid8.size
    al = dA.lvals.reshape(p, -1)
    txt = (jax.jit(lambda plan, a, b: plan.numeric(a, b))
           .lower(plan, al, al).compile().as_text())
    nnzb = dA.lvals.size
    bad = [ln for ln in txt.splitlines()
           if "all-gather" in ln and f"f64[{nnzb}" in ln.replace(" ", "")]
    assert not bad, bad[:2]


def test_distmap_translate_device(grid8):
    """DistMap.translate_device: sharded batched lookup == host translate
    (reference DistMap::Translate, decl.hpp:28-40)."""
    import jax
    import jax.numpy as jnp
    from elemental_tpu.sparse.distsparse import DistMap
    rng = np.random.default_rng(3)
    n = 103
    m = DistMap(rng.permutation(n))
    dm = m.device(grid8)
    idx = rng.integers(0, n, 57)
    out = np.asarray(jax.jit(lambda i: dm.translate_device(i))(
        jnp.asarray(idx)))
    np.testing.assert_array_equal(out, m.translate(idx))
    # inverse round trip
    np.testing.assert_array_equal(
        m.inverse().translate(m.translate(np.arange(n))), np.arange(n))
