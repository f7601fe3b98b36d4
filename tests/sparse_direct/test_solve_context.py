"""Solve-context (precomputed panel inverses) vs substitution parity.

The at-scale FGMRES preconditioner applies explicit per-level panel
inverses (``LDLFactorization.solve_context``) instead of batched
triangular solves.  These tests pin the semantics: in f64 on well-conditioned
panels the two paths agree to roundoff, for both the SPD and the
indefinite (KKT) factor kinds, through jit.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from elemental_tpu.matrices import sparse_laplacian_3d
from elemental_tpu.optimization.lp import _build_lp_kkt, sparse_ruiz
from elemental_tpu.sparse import SparseMatrix
from elemental_tpu.sparse_direct import SparseLDLFactorization
from elemental_tpu.sparse_direct.numeric import LDLFactorization


def test_ctx_matches_substitution_spd():
    lap = sparse_laplacian_3d(6, 6, 6, scaled=False)
    f = SparseLDLFactorization(spd=True)
    f.initialize(lap, cutoff=16)
    f.factor()
    b = np.random.default_rng(0).standard_normal(lap.height)
    num = f.numeric
    x0, x1 = jax.jit(
        lambda num, b: (num.solve(b), num.solve(b, num.solve_context()))
    )(num, jnp.asarray(b))
    A = lap.to_scipy()
    r0 = np.linalg.norm(A @ np.asarray(x0) - b) / np.linalg.norm(b)
    r1 = np.linalg.norm(A @ np.asarray(x1) - b) / np.linalg.norm(b)
    assert r0 < 1e-12 and r1 < 1e-12
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0),
                               rtol=1e-10, atol=1e-12)


def test_ctx_matches_substitution_kkt():
    rng = np.random.default_rng(1)
    a = np.abs(rng.standard_normal((24, 50))) + 0.1
    A, _, _ = sparse_ruiz(SparseMatrix.from_dense(a))
    kkt, _ = _build_lp_kkt(A, 1e-8, 1e-8, None)
    theta = jnp.asarray(np.abs(rng.standard_normal(50)) + 0.1)
    fact = jax.jit(lambda k, t: k.prepare(k.assemble([t])))(kkt, theta)
    rhs = jnp.asarray(rng.standard_normal(74))
    x0 = jax.jit(lambda f, r: f.solve(r))(fact, rhs)
    x1 = jax.jit(lambda f, r: f.solve(r, LDLFactorization(
        f.sys.symb, f.pool, f.d, False).solve_context()))(fact, rhs)
    rn = float(jnp.linalg.norm(rhs))
    for x in (x0, x1):
        kx = fact.sys.matvec(fact.vals, x)
        assert float(jnp.linalg.norm(rhs - kx)) / rn < 1e-11
    np.testing.assert_allclose(np.asarray(x1), np.asarray(x0),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("n_rhs", [1, 3])
def test_ctx_multi_rhs(n_rhs):
    lap = sparse_laplacian_3d(5, 5, 5, scaled=False)
    f = SparseLDLFactorization(spd=True)
    f.initialize(lap, cutoff=16)
    f.factor()
    b = np.random.default_rng(2).standard_normal((lap.height, n_rhs))
    num = f.numeric
    ctx = jax.jit(lambda n: n.solve_context())(num)
    x = jax.jit(lambda n, b, c: n.solve(b, c))(num, jnp.asarray(b), ctx)
    r = lap.to_scipy() @ np.asarray(x) - b
    assert np.linalg.norm(r) / np.linalg.norm(b) < 1e-12
