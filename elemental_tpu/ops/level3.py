"""BLAS-like level 3 (reference ``src/blas_like/level3``): Gemm (SUMMA),
Symm/Hemm, Herk/Syrk/Her2k/Syr2k, Trrk/Trr2k, Trmm, Trsm, MultiShiftTrsm,
TwoSidedTrsm/Trmm, QuasiTrsm.

Shapes:
  * Gemm — GSPMD einsum or explicit SUMMA (:mod:`.summa`) selected by a size
    heuristic like ``Gemm/NN.hpp:582-599``.
  * Triangular ops — *recursive blocked* formulations: splitting at the
    midpoint turns almost all work into large matmuls (the analog of
    the reference's Large/Medium/Small dispatch, ``Trsm.cpp:184-233``); the
    O(nb²) base case uses XLA's ``triangular_solve`` primitive.
  * rank-k updates (Herk/Trrk) — full gemm + triangular mask; the masked
    entries are dead writes that XLA fuses away cheaply, and the matrix units prefer
    one big matmul over two trapezoidal ones.
"""

from __future__ import annotations

import functools
from typing import Optional, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, grid_of, like
from ..core.grid import Grid
from . import summa

Arr = Union[jnp.ndarray, DistMatrix]

_MIN_RECURSIVE = 256  # below this, call the XLA primitive directly

# f32 matmuls may otherwise run in TF32 on the GPU (~1e-3 relative error).  A
# linear-algebra library must default to full precision; perf-critical callers
# can lower it (set_matmul_precision / the `precision` kwarg on gemm).
_matmul_precision = "highest"


def set_matmul_precision(p: str) -> None:
    """'highest' (default; f32 everywhere), 'high', or 'default' (fastest)."""
    global _matmul_precision
    _matmul_precision = p


def with_precision(fn):
    """Run an op under the library's default matmul precision."""
    @functools.wraps(fn)
    def wrapper(*a, **k):
        with jax.default_matmul_precision(_matmul_precision):
            return fn(*a, **k)
    return wrapper


def _orient(X: jnp.ndarray, orientation: str) -> jnp.ndarray:
    o = orientation.upper()[0]
    if o == "N":
        return X
    if o == "T":
        return X.T
    if o in ("C", "A"):  # conjugate-transpose / adjoint
        return jnp.conj(X.T)
    raise ValueError(f"bad orientation {orientation!r}")


@with_precision
def gemm(orientA: str, orientB: str, alpha, A: Arr, B: Arr,
         beta=None, C: Optional[Arr] = None, alg: str = "auto") -> Arr:
    """C := α·op(A)·op(B) + β·C (reference ``Gemm``, ``Gemm.cpp:274``)."""
    a = _orient(as_array(A), orientA)
    b = _orient(as_array(B), orientB)
    grid = grid_of(A, B, C)
    m, k = a.shape
    n = b.shape[1]
    if alg == "auto":
        alg = (summa.choose_algorithm(m, n, k, grid)
               if grid is not None and grid.size > 1 else "xla")
    if alg == "xla" or grid is None or grid.size == 1:
        prod = jnp.matmul(a, b, preferred_element_type=a.dtype)
        if grid is not None and grid.size > 1:
            prod = summa.gemm_xla(a, b, grid)
    else:
        prod = summa.gemm_summa(a, b, grid, alg)
    out = alpha * prod
    if C is not None:
        out = out + (beta if beta is not None else 1) * as_array(C)
        return like(C, out)
    template = A if isinstance(A, DistMatrix) else B
    return like(template, out)


@with_precision
def symm(side: str, uplo: str, alpha, A: Arr, B: Arr, beta=0,
         C: Optional[Arr] = None, conjugate: bool = False) -> Arr:
    """C := α·A·B + β·C with A symmetric/Hermitian stored in one triangle
    (reference ``Symm``/``Hemm``)."""
    a = as_array(A)
    tri = jnp.tril(a) if uplo.upper().startswith("L") else jnp.triu(a)
    opp = jnp.conj(tri.T) if conjugate else tri.T
    d = jnp.real(jnp.diagonal(a)) if conjugate else jnp.diagonal(a)
    full = tri + opp - jnp.diag(d.astype(a.dtype))
    b = as_array(B)
    prod = full @ b if side.upper().startswith("L") else b @ full
    out = alpha * prod + (beta * as_array(C) if C is not None else 0)
    return like(C if C is not None else B, out)


def hemm(side: str, uplo: str, alpha, A: Arr, B: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    return symm(side, uplo, alpha, A, B, beta, C, conjugate=True)


def _mask_tri(x: jnp.ndarray, uplo: str) -> jnp.ndarray:
    return jnp.tril(x) if uplo.upper().startswith("L") else jnp.triu(x)


@with_precision
def herk(uplo: str, orient: str, alpha, A: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    """C := α·op(A)·op(A)ᴴ + β·C, one triangle updated (reference ``Herk``)."""
    a = as_array(A)
    op = a if orient.upper().startswith("N") else jnp.conj(a.T)
    prod = jnp.matmul(op, jnp.conj(op.T), preferred_element_type=op.dtype)
    out = alpha * prod + (beta * as_array(C) if C is not None else 0)
    out = _mask_tri(out, uplo)
    return like(C if C is not None else A, out)


@with_precision
def syrk(uplo: str, orient: str, alpha, A: Arr, beta=0,
         C: Optional[Arr] = None) -> Arr:
    a = as_array(A)
    op = a if orient.upper().startswith("N") else a.T
    prod = jnp.matmul(op, op.T, preferred_element_type=op.dtype)
    out = alpha * prod + (beta * as_array(C) if C is not None else 0)
    out = _mask_tri(out, uplo)
    return like(C if C is not None else A, out)


@with_precision
def her2k(uplo: str, orient: str, alpha, A: Arr, B: Arr, beta=0,
          C: Optional[Arr] = None) -> Arr:
    a, b = as_array(A), as_array(B)
    if orient.upper().startswith("N"):
        prod = alpha * (a @ jnp.conj(b.T)) + jnp.conj(alpha) * (b @ jnp.conj(a.T))
    else:
        prod = alpha * (jnp.conj(a.T) @ b) + jnp.conj(alpha) * (jnp.conj(b.T) @ a)
    out = prod + (beta * as_array(C) if C is not None else 0)
    return like(C if C is not None else A, _mask_tri(out, uplo))


@with_precision
def syr2k(uplo: str, orient: str, alpha, A: Arr, B: Arr, beta=0,
          C: Optional[Arr] = None) -> Arr:
    a, b = as_array(A), as_array(B)
    if orient.upper().startswith("N"):
        prod = alpha * (a @ b.T + b @ a.T)
    else:
        prod = alpha * (a.T @ b + b.T @ a)
    out = prod + (beta * as_array(C) if C is not None else 0)
    return like(C if C is not None else A, _mask_tri(out, uplo))


@with_precision
def trrk(uplo: str, orientA: str, orientB: str, alpha, A: Arr, B: Arr,
         beta, C: Arr) -> Arr:
    """Triangular rank-k: one triangle of C := α·op(A)op(B) + β·C
    (reference ``Trrk`` — the Cholesky/LDL trailing-update kernel)."""
    a = _orient(as_array(A), orientA)
    b = _orient(as_array(B), orientB)
    c = as_array(C)
    prod = jnp.matmul(a, b, preferred_element_type=a.dtype)
    upd = _mask_tri(alpha * prod, uplo) + beta * c
    # preserve the untouched triangle of C
    if uplo.upper().startswith("L"):
        out = jnp.tril(upd) + jnp.triu(c, 1)
    else:
        out = jnp.triu(upd) + jnp.tril(c, -1)
    return like(C, out)


@with_precision
def trr2k(uplo: str, oA: str, oB: str, oC: str, oD: str, alpha, A: Arr,
          B: Arr, beta, C: Arr, D: Arr, gamma, E: Arr) -> Arr:
    a = _orient(as_array(A), oA)
    b = _orient(as_array(B), oB)
    c = _orient(as_array(C), oC)
    d = _orient(as_array(D), oD)
    e = as_array(E)
    prod = alpha * (a @ b) + beta * (c @ d)
    # update the named triangle; leave the other untouched
    if uplo.upper().startswith("L"):
        out = jnp.tril(prod + gamma * e) + jnp.triu(e, 1)
    else:
        out = jnp.triu(prod + gamma * e) + jnp.tril(e, -1)
    return like(E, out)


@with_precision
def trmm(side: str, uplo: str, orient: str, diag: str, alpha, A: Arr,
         B: Arr) -> Arr:
    """B := α·op(tri(A))·B or α·B·op(tri(A)) (reference ``Trmm``)."""
    a = as_array(A)
    tri = _mask_tri(a, uplo)
    if diag.upper().startswith("U"):  # unit diagonal
        tri = tri - jnp.diag(jnp.diagonal(tri)) + jnp.eye(
            tri.shape[0], dtype=tri.dtype)
    op = _orient(tri, orient)
    b = as_array(B)
    out = alpha * (op @ b if side.upper().startswith("L") else b @ op)
    return like(B, out)


# -- triangular solve -------------------------------------------------------

def _trsm_base(a, b, left, lower, trans_a, conj_a, unit):
    if conj_a and not trans_a:
        a = jnp.conj(a)
        conj_a = False
    return jax.lax.linalg.triangular_solve(
        a, b, left_side=left, lower=lower, transpose_a=trans_a,
        conjugate_a=conj_a, unit_diagonal=unit)


def _trsm_rec(a, b, left, lower, trans_a, conj_a, unit):
    """Recursive blocked triangular solve: the midpoint split turns half the
    flops into matmuls and shards cleanly under GSPMD (the analog of the
    reference's Large-variant dispatch, ``Trsm.cpp:184-233``)."""
    n = a.shape[0]
    if n <= _MIN_RECURSIVE:
        return _trsm_base(a, b, left, lower, trans_a, conj_a, unit)
    m = n // 2
    A11, A21, A12, A22 = a[:m, :m], a[m:, :m], a[:m, m:], a[m:, m:]

    def opx(x):
        if trans_a:
            x = x.T
        if conj_a:
            x = jnp.conj(x)
        return x

    # Effective blocks of op(tri(A)); the stored off-diagonal block is A21 for
    # LOWER and A12 for UPPER, and transposition moves it across the diagonal.
    eff_lower = lower != trans_a
    if eff_lower:
        eff21 = A21 if not trans_a else opx(A12)
    else:
        eff12 = A12 if not trans_a else opx(A21)

    def rec(ablk, bblk):
        return _trsm_rec(ablk, bblk, left, lower, trans_a, conj_a, unit)

    if left:
        B1, B2 = b[:m], b[m:]
        if eff_lower:
            X1 = rec(A11, B1)
            X2 = rec(A22, B2 - eff21 @ X1)
        else:
            X2 = rec(A22, B2)
            X1 = rec(A11, B1 - eff12 @ X2)
        return jnp.concatenate([X1, X2], axis=0)
    else:
        B1, B2 = b[:, :m], b[:, m:]
        if eff_lower:
            X2 = rec(A22, B2)
            X1 = rec(A11, B1 - X2 @ eff21)
        else:
            X1 = rec(A11, B1)
            X2 = rec(A22, B2 - X1 @ eff12)
        return jnp.concatenate([X1, X2], axis=1)


@with_precision
def trsm(side: str, uplo: str, orient: str, diag: str, alpha, A: Arr,
         B: Arr) -> Arr:
    """Solve op(tri(A))·X = α·B (LEFT) or X·op(tri(A)) = α·B (RIGHT)."""
    a = as_array(A)
    b = alpha * as_array(B)
    left = side.upper().startswith("L")
    lower = uplo.upper().startswith("L")
    o = orient.upper()[0]
    trans_a = o in ("T", "C", "A")
    conj_a = o in ("C", "A")
    unit = diag.upper().startswith("U")
    x = _trsm_rec(a, b, left, lower, trans_a, conj_a, unit)
    return like(B, x)


@with_precision
def multishift_trsm(side: str, uplo: str, orient: str, alpha, A: Arr,
                    shifts, B: Arr) -> Arr:
    """Solve (op(tri(A)) − σ_j I)·x_j = α·b_j for each column j (reference
    ``MultiShiftTrsm`` — the Pseudospectra/TriangEig workhorse).  Batched over
    shifts with ``vmap``; each solve is a triangular solve of the shifted
    matrix."""
    a = as_array(A)
    b = alpha * as_array(B)
    shifts = jnp.asarray(shifts)
    lower = uplo.upper().startswith("L")
    o = orient.upper()[0]
    trans_a = o in ("T", "C", "A")
    conj_a = o in ("C", "A")
    eye = jnp.eye(a.shape[0], dtype=a.dtype)

    def solve_one(sigma, rhs):
        # op(a − σ'I) = op(a) − σI requires σ' = conj(σ) when op conjugates
        sig = jnp.conj(sigma) if conj_a else sigma
        return jax.lax.linalg.triangular_solve(
            a - sig * eye, rhs[:, None], left_side=True, lower=lower,
            transpose_a=trans_a, conjugate_a=conj_a)[:, 0]

    x = jax.vmap(solve_one, in_axes=(0, 1), out_axes=1)(shifts, b)
    return like(B, x)


def quasi_trsm(side: str, uplo: str, orient: str, alpha, A: Arr,
               B: Arr) -> Arr:
    """Solve against a quasi-triangular matrix (1x1/2x2 diagonal blocks, real
    Schur form).  Dense fallback: solve with the full (quasi-)triangular
    matrix via LU-free masked solve — correctness path; hot paths use trsm."""
    a = as_array(A)
    lower = uplo.upper().startswith("L")
    mask = jnp.tril(jnp.ones_like(a), 1) if lower else jnp.triu(
        jnp.ones_like(a), -1)
    aq = a * mask
    b = alpha * as_array(B)
    op = _orient(aq, orient)
    x = jnp.linalg.solve(op, b)
    return like(B, x)


@with_precision
def twosided_trsm(uplo: str, diag: str, A: Arr, B: Arr,
                  conjugate: bool = True) -> Arr:
    """A := L⁻¹ A L⁻ᴴ (LOWER) or U⁻ᴴ A U⁻¹ — reduction of a Hermitian
    generalized eigenproblem to standard form (reference ``TwoSidedTrsm``)."""
    a = as_array(A)
    l = as_array(B)
    lower = uplo.upper().startswith("L")
    adj = "C" if conjugate else "T"
    if lower:
        tmp = trsm("L", uplo, "N", diag, 1, l, a)
        out = trsm("R", uplo, adj, diag, 1, l, tmp)
    else:
        tmp = trsm("L", uplo, adj, diag, 1, l, a)
        out = trsm("R", uplo, "N", diag, 1, l, tmp)
    return like(A, as_array(out))


@with_precision
def twosided_trmm(uplo: str, diag: str, A: Arr, B: Arr,
                  conjugate: bool = True) -> Arr:
    """A := Lᴴ A L (LOWER) or U A Uᴴ (reference ``TwoSidedTrmm``)."""
    a = as_array(A)
    l = _mask_tri(as_array(B), uplo)
    if diag.upper().startswith("U"):
        l = l - jnp.diag(jnp.diagonal(l)) + jnp.eye(l.shape[0], dtype=l.dtype)
    adj = (lambda x: jnp.conj(x.T)) if conjugate else (lambda x: x.T)
    if uplo.upper().startswith("L"):
        out = adj(l) @ a @ l
    else:
        out = l @ a @ adj(l)
    return like(A, out)


def hermitian_from_evd(uplo: str, w, Z: Arr) -> Arr:
    """A := Z·diag(w)·Zᴴ (reference ``HermitianFromEVD``)."""
    z = as_array(Z)
    w = jnp.asarray(w)
    a = (z * w[None, :].astype(z.dtype)) @ jnp.conj(z.T)
    return like(Z, _mask_tri(a, uplo) if uplo else a)


def normal_from_evd(w, Z: Arr) -> Arr:
    """A := Z·diag(w)·Zᴴ with complex w (reference ``NormalFromEVD``)."""
    z = as_array(Z)
    w = jnp.asarray(w)
    return like(Z, (z * w[None, :]) @ jnp.conj(z.T))


def safe_multishift_trsm(side: str, uplo: str, orient: str, alpha, A: Arr,
                         shifts, B: Arr):
    """Overflow-guarded multishift triangular solve (reference
    ``SafeMultiShiftTrsm`` — the eigenvector back-substitution used by
    ``TriangEig``): solves (op(tri(A)) − σ_j I)·x_j = s_j·α·b_j where each
    column's scale s_j ≤ 1 is chosen so the solution stays representable.
    Returns ``(X, scales)``.

    Formulation: instead of the reference's entry-by-entry
    rescaling inside the substitution (data-dependent control flow), solve
    once and derive the per-column scale from the solution magnitude — the
    shifted solves themselves run batched under ``vmap``."""
    x = multishift_trsm(side, uplo, orient, alpha, A, shifts, B)
    xa = as_array(x)
    big = jnp.asarray(
        jnp.finfo(xa.real.dtype).max, xa.real.dtype) ** 0.5
    colmax = jnp.max(jnp.abs(xa), axis=0)
    finite = jnp.isfinite(colmax)
    scales = jnp.where(finite & (colmax > big), big / colmax, 1.0)
    scales = jnp.where(finite, scales, 0.0)
    safe = jnp.where(jnp.isfinite(xa), xa, 0.0) * scales[None, :]
    return like(B, safe), scales.astype(xa.real.dtype)
