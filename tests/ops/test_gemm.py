"""Gemm tests (model: reference ``tests/blas_like/Gemm.cpp`` /
``Gemm_Suite.cpp``): associativity check when no reference implementation is
available (``Gemm_Suite.cpp:1-15`` TestAssociativity), plus agreement between
the GSPMD path and every explicit SUMMA variant."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from elemental_tpu.core import MC, MR, distribute
from elemental_tpu.ops import gemm
from elemental_tpu.ops import summa


RNG = np.random.default_rng(7)


def _rand(m, n, dtype=np.float32):
    a = RNG.standard_normal((m, n))
    if np.issubdtype(dtype, np.complexfloating):
        a = a + 1j * RNG.standard_normal((m, n))
    return a.astype(dtype)


@pytest.mark.parametrize("alg", ["xla", "stationary_c", "stationary_a",
                                 "stationary_b", "pipelined"])
def test_summa_variants_match(grid8, alg):
    m, k, n = 48, 32, 64
    a, b = _rand(m, k), _rand(k, n)
    A = distribute(a, MC, MR, grid8)
    B = distribute(b, MC, MR, grid8)
    C = gemm("N", "N", 1.0, A, B, alg=alg)
    np.testing.assert_allclose(C.to_numpy(), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("alg", ["stationary_c", "stationary_b",
                                 "pipelined"])
def test_summa_nondivisible_shapes(grid8, alg):
    """Padding path: shapes not divisible by the mesh."""
    m, k, n = 37, 23, 51
    a, b = _rand(m, k), _rand(k, n)
    A = distribute(a, MC, MR, grid8)
    B = distribute(b, MC, MR, grid8)
    C = gemm("N", "N", 1.0, A, B, alg=alg)
    np.testing.assert_allclose(C.to_numpy(), a @ b, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("oA,oB", [("N", "N"), ("N", "T"), ("T", "N"),
                                   ("T", "T"), ("C", "C")])
def test_gemm_orientations(grid8, oA, oB):
    m, k, n = 24, 16, 32
    dt = np.complex64 if "C" in (oA, oB) else np.float32
    a = _rand(m, k, dt) if oA == "N" else _rand(k, m, dt)
    b = _rand(k, n, dt) if oB == "N" else _rand(n, k, dt)

    def op(x, o):
        return {"N": x, "T": x.T, "C": x.conj().T}[o]

    A = distribute(a, MC, MR, grid8)
    B = distribute(b, MC, MR, grid8)
    C = gemm(oA, oB, 2.0, A, B)
    np.testing.assert_allclose(C.to_numpy(), 2.0 * op(a, oA) @ op(b, oB),
                               rtol=1e-4, atol=1e-4)


def test_gemm_beta_accumulate(grid8):
    m, k, n = 16, 16, 16
    a, b, c = _rand(m, k), _rand(k, n), _rand(m, n)
    A, B, C = (distribute(x, MC, MR, grid8) for x in (a, b, c))
    out = gemm("N", "N", 1.5, A, B, beta=-0.5, C=C)
    np.testing.assert_allclose(out.to_numpy(), 1.5 * a @ b - 0.5 * c,
                               rtol=1e-4, atol=1e-4)


def test_gemm_associativity(grid8):
    """(AB)x == A(Bx) — the reference's correctness trick when no independent
    implementation exists (``Gemm_Suite.cpp`` TestAssociativity)."""
    m, k, n = 40, 24, 40
    a, b = _rand(m, k, np.float64), _rand(k, n, np.float64)
    x = RNG.standard_normal((n, 1))
    A = distribute(a, MC, MR, grid8)
    B = distribute(b, MC, MR, grid8)
    AB = gemm("N", "N", 1.0, A, B, alg="stationary_c")
    lhs = AB.to_numpy() @ x
    rhs = a @ (b @ x)
    np.testing.assert_allclose(lhs, rhs, rtol=1e-10)


def test_gemm_under_jit(grid8):
    a, b = _rand(32, 32), _rand(32, 32)
    A = distribute(a, MC, MR, grid8)
    B = distribute(b, MC, MR, grid8)

    @jax.jit
    def f(A, B):
        return gemm("N", "N", 1.0, A, B, alg="stationary_c")

    C = f(A, B)
    np.testing.assert_allclose(C.to_numpy(), a @ b, rtol=1e-4, atol=1e-4)


def test_algorithm_heuristic(grid8):
    assert summa.choose_algorithm(1024, 1024, 64, grid8) == "stationary_c"
    assert summa.choose_algorithm(1024, 8, 1024, grid8) == "stationary_a"


def test_choose_algorithm_covers_all_variants(grid8):
    from elemental_tpu.ops.summa import choose_algorithm
    # C dominant, small: stationary_c; C dominant, huge A-strip: pipelined
    assert choose_algorithm(512, 512, 64, grid8) == "stationary_c"
    assert choose_algorithm(1 << 15, 1 << 15, 1 << 14, grid8) == "pipelined"
    # A dominant / B dominant keep the big operand in place
    assert choose_algorithm(64, 512, 4096, grid8) == "stationary_b"
    assert choose_algorithm(512, 64, 4096, grid8) == "stationary_a"


@pytest.mark.parametrize("alg", ["stationary_a", "stationary_b"])
def test_summa_no_full_operand_allgather(grid8, alg):
    """The big-operand panel schemes must never replicate an operand over
    BOTH mesh axes (gathering the non-stationary operand to full size on
    every rank costs O(k·n) memory).  Assert no all-gather in
    the compiled HLO produces a full-m×k or full-k×n array."""
    m, k, n = 64, 128, 96
    a = _rand(m, k)
    b = _rand(k, n)
    mesh = grid8.mesh
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh = NamedSharding(mesh, P("mc", "mr"))
    aj = jax.device_put(jnp.asarray(a), sh)
    bj = jax.device_put(jnp.asarray(b), sh)

    def f(aj, bj):
        return summa.gemm_summa(aj, bj, grid8, alg=alg)

    txt = jax.jit(f).lower(aj, bj).compile().as_text()
    import re
    full = {(m, k), (k, n)}          # per-shard result = global size ⇒ bad
    for line in txt.splitlines():
        if "all-gather" not in line:
            continue
        for r, c in re.findall(r"f32\[(\d+),(\d+)\]", line):
            assert (int(r), int(c)) not in full, line
    # and numerics still match
    c_out = np.asarray(f(aj, bj))
    np.testing.assert_allclose(c_out, a @ b, rtol=1e-4, atol=1e-4)
