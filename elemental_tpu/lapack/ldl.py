"""Dense LDL factorizations (reference ``src/lapack_like/factor/LDL/dense/``
unpivoted + Bunch-Kaufman, and ``factor/RegularizedLDL/`` — the IPM KKT
workhorse with dynamic regularization + iterative refinement).

Design: recursive blocked LDLᵀ/LDLᴴ (unit-lower L, diagonal D) — the same
midpoint recursion as Cholesky so the trailing update is one sharded
matmul; the base case is a masked ``fori_loop``.  Pivoting is avoided the way
the reference's IPM does: *dynamic regularization* keeps the factorization
stable for quasi-definite KKT systems (reference ``RegularizedLDL`` +
``SolveAfter`` with refinement).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like
from ..ops.level3 import trsm, with_precision

Arr = Union[jnp.ndarray, DistMatrix]

_BASE = 128


class LDL(NamedTuple):
    lower: jnp.ndarray  # unit-lower L (unit diagonal stored)
    diag: jnp.ndarray   # D as a vector


def _ldl_base(a: jnp.ndarray, conjugate: bool) -> jnp.ndarray:
    """Unblocked right-looking LDL; returns packed L\\D (L strictly-lower +
    D on the diagonal)."""
    n = a.shape[0]

    def body(k, a):
        d = a[k, k]
        col = a[:, k] / d
        lcol = jnp.where(jnp.arange(n) > k, col, 0.0)
        lrow = jnp.conj(lcol) if conjugate else lcol
        a = a - jnp.outer(lcol, lrow) * d
        a = a.at[:, k].set(jnp.where(jnp.arange(n) > k, col, a[:, k]))
        a = a.at[k, k].set(d)
        return a

    return jax.lax.fori_loop(0, n, body, a)


def _ldl_rec(a: jnp.ndarray, conjugate: bool) -> jnp.ndarray:
    n = a.shape[0]
    if n <= _BASE:
        return _ldl_base(a, conjugate)
    m = n // 2
    A11, A21, A22 = a[:m, :m], a[m:, :m], a[m:, m:]
    F11 = _ldl_rec(A11, conjugate)
    d1 = jnp.diagonal(F11)
    # L21 = A21 · L11⁻ᴴ · D1⁻¹
    adj = "C" if conjugate else "T"
    L21 = as_array(trsm("R", "L", adj, "U", 1, F11, A21)) / d1[None, :]
    L21d = L21 * d1[None, :]
    rhs = jnp.conj(L21.T) if conjugate else L21.T
    A22u = A22 - jnp.matmul(L21d, rhs, preferred_element_type=a.dtype)
    F22 = _ldl_rec(A22u, conjugate)
    top = jnp.concatenate([F11, jnp.zeros((m, n - m), a.dtype)], axis=1)
    bot = jnp.concatenate([L21, F22], axis=1)
    return jnp.concatenate([top, bot], axis=0)


@with_precision
def ldl(A: Arr, conjugate: bool = True) -> LDL:
    """Unpivoted LDLᴴ (conjugate=True) or LDLᵀ: A = L·D·Lᴴ with unit-lower L
    (reference dense ``LDL``, suitable for HPD/quasi-definite operands)."""
    packed = _ldl_rec(as_array(A), conjugate)
    d = jnp.diagonal(packed)
    n = packed.shape[0]
    lower = jnp.tril(packed, -1) + jnp.eye(n, dtype=packed.dtype)
    return LDL(lower, d)


@with_precision
def regularized_ldl(A: Arr, reg: jnp.ndarray,
                    conjugate: bool = False) -> LDL:
    """LDL of A + diag(reg) (reference ``RegularizedLDL``): the caller supplies
    signed per-row regularization (+δ² for primal rows, −γ² for dual rows in
    the IPM KKT system), making the quasi-definite factorization pivot-free."""
    a = as_array(A)
    a = a + jnp.diag(jnp.asarray(reg).astype(a.dtype))
    return ldl(a, conjugate)


def solve_after(fact: LDL, B: Arr, conjugate: bool = True) -> Arr:
    """X = A⁻¹B from an LDL factorization: L, D, then Lᴴ solves."""
    b = as_array(B)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    y = as_array(trsm("L", "L", "N", "U", 1, fact.lower, b))
    y = y / fact.diag[:, None]
    adj = "C" if conjugate else "T"
    x = as_array(trsm("L", "L", adj, "U", 1, fact.lower, y))
    if squeeze:
        x = x[:, 0]
    return like(B, x)


def solve_after_refined(A: Arr, fact: LDL, B: Arr, conjugate: bool = False,
                        max_refine_iters: int = 8,
                        relative_tol: float = None) -> Arr:
    """Solve with iterative refinement against the *unregularized* A
    (reference ``reg_ldl::SolveAfter``, ``DistSparseLDLFactorization.cpp:264``):
    x ← x + A⁻̃¹(b − A·x) until the residual stalls."""
    a = as_array(A)
    b = as_array(B)
    squeeze = b.ndim == 1
    bb = b[:, None] if squeeze else b
    x = as_array(solve_after(fact, bb, conjugate))

    def body(i, x):
        r = bb - a @ x
        dx = as_array(solve_after(fact, r, conjugate))
        return x + dx

    x = jax.lax.fori_loop(0, max_refine_iters, body, x)
    if squeeze:
        x = x[:, 0]
    return like(B, x)


def inertia(fact: LDL):
    """(num positive, num negative, num zero) eigen-signs from D (reference
    ``props/Inertia`` via LDL)."""
    d = jnp.real(fact.diag)
    return (jnp.sum(d > 0), jnp.sum(d < 0), jnp.sum(d == 0))


# --------------------------------------------------------------------------
# Bunch-Kaufman pivoted LDL (reference ``factor/LDL/dense`` pivoted variant)
# --------------------------------------------------------------------------

class LDLPivoted(NamedTuple):
    lower: jnp.ndarray   # unit-lower L (in pivoted order)
    diag: jnp.ndarray    # main diagonal of block-diagonal D
    subdiag: jnp.ndarray  # subdiagonal of D (nonzero at 2x2 pivots)
    perm: jnp.ndarray    # row permutation: P·A·Pᵀ = L·D·Lᵀ, P = I[perm]


_BK_ALPHA = (1.0 + 17.0 ** 0.5) / 8.0


@with_precision
def ldl_pivoted(A: Arr, conjugate: bool = False) -> LDLPivoted:
    """Bunch-Kaufman partially-pivoted LDLᵀ/LDLᴴ with 1×1 and 2×2 pivots
    (reference dense pivoted ``LDL``; LAPACK ``sytf2`` decision rule) —
    stable for general symmetric indefinite matrices where the unpivoted
    path breaks down.

    Jit-safe masked formulation: one ``fori_loop`` step per column with a
    carried ``skip`` flag for the second column of a 2×2 pivot; symmetric
    swaps are applied as full index-permutation gathers (control-flow-heavy
    pivoting is inherently hostile to matmul units — this is the correctness
    tier; the IPM hot path stays on the pivot-free RegularizedLDL)."""
    a0 = as_array(A)
    n = a0.shape[0]
    dt = a0.dtype
    if n <= 1:
        return LDLPivoted(jnp.eye(n, dtype=dt), jnp.diagonal(a0),
                          jnp.zeros((0,), dt), jnp.arange(n))
    idx = jnp.arange(n)
    alpha = _BK_ALPHA

    def swap(a, perm, i, j):
        """Symmetric swap of rows/cols i and j (i, j traced)."""
        sel = idx.at[i].set(j).at[j].set(i)
        return a[sel][:, sel], perm[sel]

    def body(k, carry):
        a, e, perm, skip = carry

        def do_col(args):
            a, e, perm = args
            below = idx > k
            colk = jnp.where(below, a[:, k], 0.0)
            absc = jnp.abs(colk)
            lam = jnp.max(absc)
            r = jnp.argmax(absc)
            akk = jnp.abs(a[k, k])

            one_noswap = akk >= alpha * lam
            # column r statistics (trailing block, excluding r itself)
            colr = jnp.where((idx >= k) & (idx != r),
                             jnp.where(idx < r, a[r, :], a[:, r]), 0.0)
            sigma = jnp.max(jnp.abs(colr))
            one_noswap = one_noswap | (akk * sigma >= alpha * lam * lam)
            one_swap = jnp.abs(a[r, r]) >= alpha * sigma

            def pivot1(a, perm, do_swap):
                asw, psw = swap(a, perm, k, jnp.where(do_swap, r, k))
                d = asw[k, k]
                safe = jnp.where(d == 0, jnp.ones((), dt), d)
                col = jnp.where(idx > k, asw[:, k] / safe, 0.0)
                row = jnp.conj(col) if conjugate else col
                anew = asw - jnp.outer(col, row) * d
                anew = anew.at[:, k].set(
                    jnp.where(idx > k, col, asw[:, k]))
                anew = anew.at[k, k].set(d)
                return anew, psw, jnp.zeros((), dt), False

            def pivot2(a, perm):
                # 2x2 pivot: swap k+1 <-> r, eliminate columns k, k+1
                asw, psw = swap(a, perm, k + 1, r)
                E00, E11 = asw[k, k], asw[k + 1, k + 1]
                E10 = asw[k + 1, k]
                det = E00 * E11 - E10 * (jnp.conj(E10) if conjugate
                                         else E10)
                safe = jnp.where(det == 0, jnp.ones((), dt), det)
                below2 = idx > k + 1
                w0 = jnp.where(below2, asw[:, k], 0.0)
                w1 = jnp.where(below2, asw[:, k + 1], 0.0)
                # [l0 l1] = [w0 w1]·E⁻¹ with Hermitian E = [[E00, E10ᴴ],
                # [E10, E11]]: E⁻¹ = (1/det)[[E11, −E10ᴴ],[−E10, E00]]
                l0 = (w0 * E11 - w1 * E10) / safe
                l1 = (w1 * E00 - w0 * (jnp.conj(E10) if conjugate
                                       else E10)) / safe
                r0 = jnp.conj(w0) if conjugate else w0
                r1 = jnp.conj(w1) if conjugate else w1
                anew = asw - jnp.outer(l0, r0) - jnp.outer(l1, r1)
                anew = anew.at[:, k].set(
                    jnp.where(below2, l0, asw[:, k]))
                anew = anew.at[:, k + 1].set(
                    jnp.where(below2, l1, asw[:, k + 1]))
                anew = anew.at[k, k].set(E00)
                anew = anew.at[k + 1, k + 1].set(E11)
                anew = anew.at[k + 1, k].set(E10)
                return anew, psw, E10, True

            use1 = one_noswap | one_swap | (k >= n - 1)
            a1, p1, e1, s1 = pivot1(a, perm,
                                    (~one_noswap) & one_swap & (k < n - 1))
            a2, p2, e2, s2 = pivot2(a, perm) if n > 1 else (a, perm,
                                                            jnp.zeros((), dt),
                                                            False)
            anew = jnp.where(use1, a1, a2)
            pnew = jnp.where(use1, p1, p2)
            ek = jnp.where(use1, e1, e2)
            sk = jnp.where(use1, s1, s2)
            e = e.at[jnp.minimum(k, n - 2)].set(
                jnp.where(use1, e[jnp.minimum(k, n - 2)], ek))
            return a, anew, e, pnew, sk

        a_keep, anew, enew, pnew, sk = do_col((a, e, perm))
        # skip: this column was the second half of a 2x2 pivot
        a = jnp.where(skip, a_keep, anew)
        e = jnp.where(skip, e, enew)
        perm = jnp.where(skip, perm, pnew)
        skip = jnp.where(skip, False, sk)
        return (a, e, perm, skip)

    e0 = jnp.zeros(max(n - 1, 1), dt)
    a, e, perm, _ = jax.lax.fori_loop(
        0, n, body, (a0, e0, jnp.arange(n), jnp.zeros((), bool)))
    d = jnp.diagonal(a)
    lower = jnp.tril(a, -1) + jnp.eye(n, dtype=dt)
    # zero the L entry under each 2x2 pivot head (it stores E10, not L)
    mask2 = jnp.concatenate([e != 0, jnp.zeros((1,), bool)]) if n > 1 \
        else jnp.zeros((n,), bool)
    sub = jnp.where(mask2[:-1], 0.0, jnp.diagonal(lower, -1)) if n > 1 \
        else jnp.zeros((0,), dt)
    lower = lower - jnp.diag(jnp.diagonal(lower, -1), -1) \
        + jnp.diag(sub, -1) if n > 1 else lower
    return LDLPivoted(lower, d, e, perm)


def solve_after_pivoted(fact: LDLPivoted, B: Arr,
                        conjugate: bool = False) -> Arr:
    """X = A⁻¹B from a Bunch-Kaufman factorization: permute, L solve,
    block-diagonal solve (1×1/2×2), Lᴴ solve, unpermute."""
    b = as_array(B).astype(fact.lower.dtype)
    squeeze = b.ndim == 1
    if squeeze:
        b = b[:, None]
    n = b.shape[0]
    pb = b[fact.perm]
    y = as_array(trsm("L", "L", "N", "U", 1, fact.lower, pb))
    # block-diagonal solve: solve the tridiagonal-with-2x2-blocks D
    d, e = fact.diag, fact.subdiag
    if n > 1:
        eh = jnp.conj(e) if conjugate else e
        head = e != 0                       # k is the head of a 2x2 block
        det = d[:-1] * d[1:] - e * eh
        det = jnp.where(head, det, jnp.ones_like(det))
        y0 = y[:-1]
        y1 = y[1:]
        z0 = (d[1:, None] * y0 - eh[:, None] * y1) / det[:, None]
        z1 = (d[:-1, None] * y1 - e[:, None] * y0) / det[:, None]
        z = y / d[:, None]
        z = z.at[:-1].set(jnp.where(head[:, None], z0, z[:-1]))
        tail = jnp.concatenate([jnp.zeros((1,), bool), head])
        z = z.at[1:].set(jnp.where(head[:, None], z1, z[1:]))
    else:
        z = y / d[:, None]
    adj = "C" if conjugate else "T"
    x = as_array(trsm("L", "L", adj, "U", 1, fact.lower, z))
    inv = jnp.argsort(fact.perm)
    x = x[inv]
    if squeeze:
        x = x[:, 0]
    return like(B, x)
