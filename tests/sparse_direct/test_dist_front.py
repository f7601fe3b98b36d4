"""Distributed 2D-front factorization tests (sparse_direct/dist_front.py —
reference L2D [MC,MR] fronts, ``numeric.hpp:29-38`` /
``ProcessFront.hpp:29-60``)."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from elemental_tpu.matrices import sparse_laplacian_3d
from elemental_tpu.sparse_direct.dist_front import dist_partial_ldl
from elemental_tpu.sparse_direct.numeric import _masked_partial_ldl

RNG = np.random.default_rng(3)


def _mesh8():
    devs = np.array(jax.devices("cpu")[:8]).reshape(2, 4)
    return Mesh(devs, ("mc", "mr"))


@pytest.mark.parametrize("S,ns", [(384, 250), (256, 256), (192, 64)])
def test_dist_front_matches_single(S, ns):
    a = RNG.standard_normal((S, S))
    F = jnp.asarray(np.tril(a @ a.T + S * np.eye(S)))
    mesh = _mesh8()
    ref = np.asarray(_masked_partial_ldl(F, jnp.asarray(ns), ns, False))
    out = np.asarray(jax.jit(
        lambda F: dist_partial_ldl(F, ns, mesh, nb=64))(F))
    scale = np.abs(ref).max()
    assert np.abs(out - ref).max() < 1e-10 * scale


def test_dist_front_pivot_floor():
    S, ns = 256, 200
    a = RNG.standard_normal((S, S))
    F = jnp.asarray(np.tril(a @ a.T + S * np.eye(S)))
    pf = jnp.asarray(np.full(S, 1e-8))
    mesh = _mesh8()
    ref = np.asarray(_masked_partial_ldl(F, jnp.asarray(ns), ns, False,
                                         pf=pf))
    out = np.asarray(jax.jit(
        lambda F: dist_partial_ldl(F, ns, mesh, nb=64, pf=pf))(F))
    assert np.abs(out - ref).max() < 1e-10 * np.abs(ref).max()


def test_facade_dist_front_end_to_end(grid8):
    """Force the dist-front tier on the CPU mesh (env override) and check
    the full factor+solve."""
    from elemental_tpu.sparse import DistSparseMatrix
    from elemental_tpu.sparse_direct import DistSparseLDLFactorization
    A = sparse_laplacian_3d(10, 10, 10, scaled=False)
    os.environ["ELEMENTAL_DIST_FRONT_MIN"] = "96"
    try:
        f = DistSparseLDLFactorization(spd=True)
        f.initialize(DistSparseMatrix.from_sparse(A, grid8), cutoff=32)
        f.factor()
    finally:
        os.environ.pop("ELEMENTAL_DIST_FRONT_MIN", None)
    b = RNG.standard_normal(A.height)
    x = np.asarray(f.solve(b))
    r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
    assert r < f.residual_bound()


def test_facade_dist_front_off_by_default(grid8, monkeypatch):
    """Without ``ELEMENTAL_DIST_FRONT_MIN`` the mesh factor keeps every
    front on the batched path, with its flat pool replicated."""
    import elemental_tpu.sparse_direct.dist_front as df
    from elemental_tpu.sparse import DistSparseMatrix
    from elemental_tpu.sparse_direct import DistSparseLDLFactorization

    def never(*a, **k):
        raise AssertionError("dist_front engaged without the opt-in")

    monkeypatch.delenv("ELEMENTAL_DIST_FRONT_MIN", raising=False)
    monkeypatch.setattr(df, "dist_partial_ldl", never)
    A = sparse_laplacian_3d(10, 10, 10, scaled=False)
    f = DistSparseLDLFactorization(spd=True)
    f.initialize(DistSparseMatrix.from_sparse(A, grid8), cutoff=32)
    f.factor()
    assert f.numeric.pool.sharding.is_fully_replicated
    b = RNG.standard_normal(A.height)
    x = np.asarray(f.solve(b))
    r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
    assert r < f.residual_bound()
