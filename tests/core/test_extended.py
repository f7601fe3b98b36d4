"""Extended-precision (double-word) tier tests (reference QD/BigFloat tier,
``src/core/imports/qd.cpp``; SURVEY §7 "fp64 via double-word
kernels").

The invariant under test: base-f32 DD arithmetic must deliver ≥ ~1.8× the
hardware mantissa (~1e-13 relative), i.e. emulated-f64-class results from
f32 words.  These tolerances would catch a compiler re-associating the
error-free transformations."""

import math

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from elemental_tpu import extended as X


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(0)


def test_two_sum_and_two_prod_are_error_free(rng):
    a = jnp.asarray(rng.standard_normal(512), jnp.float32)
    b = jnp.asarray(rng.standard_normal(512), jnp.float32) * 1e-4
    s, e = X.two_sum(a, b)
    exact = np.float64(a) + np.float64(b)
    assert np.abs((np.float64(s) + np.float64(e)) - exact).max() == 0.0
    p, f = X.two_prod(a, b)
    exact = np.float64(a) * np.float64(b)
    assert np.abs((np.float64(p) + np.float64(f)) - exact).max() == 0.0


def test_dd_field_ops_reach_double_word_precision(rng):
    a64 = rng.standard_normal(1000) * np.exp(rng.standard_normal(1000))
    b64 = rng.standard_normal(1000) * np.exp(rng.standard_normal(1000))
    A, B = X.DD.from_array(a64), X.DD.from_array(b64)
    ae, be = A.to_float64(), B.to_float64()
    assert np.abs((A + B).to_float64() - (ae + be)).max() < 5e-14 * np.abs(
        ae + be).max()
    rel = np.abs((A * B).to_float64() - ae * be) / np.abs(ae * be)
    assert rel.max() < 5e-14
    rel = np.abs((A / B).to_float64() - ae / be) / np.abs(ae / be)
    assert rel.max() < 5e-14
    s = X.dd_sqrt(X.DD.from_array(np.abs(a64)))
    rel = np.abs(s.to_float64() - np.sqrt(np.abs(ae))) / np.sqrt(np.abs(ae))
    assert rel.max() < 1e-13


def test_dd_dot_beats_f32_by_many_orders(rng):
    n = 4096
    x, y = rng.standard_normal(n), rng.standard_normal(n)
    xd, yd = X.DD.from_array(x), X.DD.from_array(y)
    d = X.dd_dot(xd, yd).to_float64()
    truth = math.fsum(a * b for a, b in zip(xd.to_float64(), yd.to_float64()))
    dd_err = abs(d - truth) / abs(truth)
    f32_err = abs(float(np.float32(x) @ np.float32(y)) - truth) / abs(truth)
    assert dd_err < 1e-12
    assert dd_err < 1e-5 * f32_err  # ≥5 orders of magnitude better


def test_dd_dot_survives_catastrophic_cancellation():
    # Σ x_i y_i with huge cancellation: classic compensated-dot stress
    x = np.array([1e8, 1.0, -1e8, 1e-4])
    y = np.array([1.0, 1.0, 1.0, 1.0])
    d = X.dd_dot(X.DD.from_array(x), X.DD.from_array(y)).to_float64()
    assert abs(d - (1.0 + 1e-4)) < 1e-10


def test_dd_gemm_and_matvec(rng):
    m, k, n = 24, 100, 16
    Am, Bm = rng.standard_normal((m, k)), rng.standard_normal((k, n))
    Add, Bdd = X.DD.from_array(Am), X.DD.from_array(Bm)
    C = X.dd_gemm(Add, Bdd)
    truth = Add.to_float64() @ Bdd.to_float64()
    assert np.abs(C.to_float64() - truth).max() < 1e-12 * np.abs(truth).max()
    xv = X.DD.from_array(rng.standard_normal(k))
    mv = X.dd_matvec(Add, xv)
    truth = Add.to_float64() @ xv.to_float64()
    assert np.abs(mv.to_float64() - truth).max() < 1e-12 * np.abs(truth).max()


def test_dd_is_a_pytree_under_jit(rng):
    x = X.DD.from_array(rng.standard_normal(128))
    y = X.DD.from_array(rng.standard_normal(128))
    f = jax.jit(lambda a, b: X.dd_add(X.dd_mul(a, b), a))
    out = f(x, y)
    truth = x.to_float64() * y.to_float64() + x.to_float64()
    assert np.abs(out.to_float64() - truth).max() < 1e-12 * np.abs(
        truth).max()


def test_refined_solve_dd_promotes_f32_factorization(rng):
    import scipy.linalg as sla
    n = 64
    Q = rng.standard_normal((n, n))
    A = (Q @ Q.T + n * np.eye(n)).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    L = np.linalg.cholesky(np.float64(A)).astype(np.float32)

    def solve(r):
        return jnp.asarray(sla.cho_solve(
            (np.float64(L), True), np.asarray(r, np.float64)
        ).astype(np.float32))

    xdd = X.refined_solve_dd(A, solve, b, iters=4)
    x_true = np.linalg.solve(np.float64(A), np.float64(b))
    err_dd = np.abs(xdd.to_float64() - x_true).max() / np.abs(x_true).max()
    err_f32 = np.abs(np.float64(np.asarray(solve(jnp.asarray(b))))
                     - x_true).max() / np.abs(x_true).max()
    assert err_dd < 1e-10
    assert err_dd < 1e-2 * err_f32


def test_dd_base_f64_reaches_quad_class(rng):
    # On the CPU backend with x64, DD over f64 words gives ~2^-104:
    # the reference's DoubleDouble.
    a = rng.standard_normal(100)
    b = rng.standard_normal(100)
    A = X.DD(jnp.asarray(a, jnp.float64), jnp.zeros(100, jnp.float64))
    B = X.DD(jnp.asarray(b, jnp.float64), jnp.zeros(100, jnp.float64))
    P = X.dd_mul(A, B)
    # hi+lo reproduces the exact product to ~1e-31 relative:
    # check |p_hi - fl(a*b)| == 0 and the lo word captures the fma error
    assert np.abs(np.asarray(P.hi) - a * b).max() == 0.0
    # the lo words are the rounding errors of the f64 products (nonzero
    # for most inputs) — spot-check against exact rational arithmetic
    from fractions import Fraction
    for i in range(10):
        exact = Fraction(float(a[i])) * Fraction(float(b[i]))
        got = Fraction(float(P.hi[i])) + Fraction(float(P.lo[i]))
        assert got == exact


def test_qd_quad_double_precision():
    """QD add/mul reach ~212-bit precision on f64 base (reference
    QuadDouble parity), verified against exact Fraction arithmetic."""
    from fractions import Fraction
    import jax.numpy as jnp
    from elemental_tpu.extended import QD, qd_add, qd_mul, qd_dot

    def to_frac(q):
        return sum(Fraction(float(np.asarray(c))) for c in q.words)

    rng = np.random.default_rng(1)
    for _ in range(10):
        a = qd_add(QD.from_array(rng.standard_normal()),
                   QD.from_array(rng.standard_normal() * 2.0**-60))
        b = qd_add(QD.from_array(rng.standard_normal()),
                   QD.from_array(rng.standard_normal() * 2.0**-60))
        s = qd_add(a, b)
        m = qd_mul(a, b)
        assert abs(to_frac(s) - (to_frac(a) + to_frac(b))) \
            <= Fraction(1, 2**180) * abs(to_frac(s))
        assert abs(to_frac(m) - to_frac(a) * to_frac(b)) \
            <= Fraction(1, 2**180) * abs(to_frac(m))
    # compensated dot survives catastrophic f64 cancellation
    d = qd_dot(jnp.asarray([1.0, 1e-30, -1.0, 1e-30]), jnp.ones(4))
    assert abs(float(to_frac(d)) - 2e-30) < 1e-45
