"""Condensed forms (reference ``src/lapack_like/condense``: HermitianTridiag,
Bidiag, Hessenberg + ApplyQ).

Note: the reference's blocked two-sided reductions are
communication-heavy panel algorithms (``HermitianTridiag.cpp:86-94`` square-grid
variant).  Here each reduction is a ``fori_loop`` of masked Householder
similarity updates — static shapes, rank-2 updates as outer products XLA
fuses; a blocked (latency-optimal) variant is a later optimisation since the
eigensolver hot path (``hermitian_eig``) uses XLA's fused ``eigh``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array

Arr = Union[jnp.ndarray, DistMatrix]


class Tridiag(NamedTuple):
    d: jnp.ndarray        # main diagonal (real)
    e: jnp.ndarray        # sub-diagonal (real)
    q: jnp.ndarray        # accumulated unitary (A = Q T Qᴴ)


def hermitian_tridiag(uplo: str, A: Arr, want_q: bool = True,
                      blocksize: int = 32) -> Tridiag:
    """Reduce Hermitian A to real symmetric tridiagonal T = Qᴴ A Q
    (reference ``HermitianTridiag``).  Dispatches to the blocked panel
    variant (``HermitianTridiag.cpp:86-94`` analog: latrd panels + rank-2nb
    matmul trailing updates) for n ≥ 192; small problems use the rank-2
    ``fori_loop``."""
    a0 = as_array(A)
    if a0.shape[0] >= 192:
        return _hermitian_tridiag_blocked(uplo, a0, nb=blocksize)
    a = a0
    if not uplo.upper().startswith("L"):
        a = jnp.conj(a.T)
    n = a.shape[0]
    q0 = jnp.eye(n, dtype=a.dtype)

    def body(k, state):
        a, q = state
        rows = jnp.arange(n)
        x = jnp.where(rows > k, a[:, k], 0.0)
        normx = jnp.linalg.norm(x)
        pivot = x[k + 1]
        # phase that makes the new subdiagonal entry real negative-free
        absp = jnp.abs(pivot)
        phase = jnp.where(absp == 0, jnp.ones((), a.dtype), pivot / absp)
        v = x.at[k + 1].add(phase * normx)
        vnorm2 = jnp.sum(jnp.abs(v) ** 2)
        tau = jnp.where(vnorm2 == 0, 0.0, 2.0 / vnorm2).astype(a.dtype)
        # similarity: a ← (I − τ v vᴴ) a (I − τ v vᴴ)
        w = tau * (a @ v)
        # correction for two-sided: w ← w − (τ/2)(vᴴ w) v
        w = w - (tau / 2) * jnp.vdot(v, w) * v
        a = a - jnp.outer(v, jnp.conj(w)) - jnp.outer(w, jnp.conj(v))
        q = q - tau * jnp.outer(q @ v, jnp.conj(v))
        return (a, q)

    if n > 2:
        a, q = jax.lax.fori_loop(0, n - 2, body, (a, q0))
    else:
        q = q0
    d = jnp.real(jnp.diagonal(a))
    sub = jnp.diagonal(a, -1)
    if jnp.issubdtype(a.dtype, jnp.complexfloating):
        # absorb subdiagonal phases into a diagonal unitary: T ← Dᴴ T D with
        # D_{j+1} = φ_j D_j so the tridiagonal becomes real (LAPACK zhetrd
        # convention); fold D into Q.
        absd = jnp.abs(sub)
        phases = jnp.where(absd == 0, jnp.ones_like(sub), sub / absd)
        dscale = jnp.concatenate([jnp.ones((1,), a.dtype),
                                  jnp.cumprod(phases)])
        q = q * dscale[None, :]
        e = absd
    else:
        e = jnp.real(sub)
    return Tridiag(d, e, q)


def _highest_precision(fn):
    """Blocked condensations pin matmul precision to 'highest': a default
    f32 matmul may run in TF32 or bf16, and the accumulated two-sided panel
    updates then lose most of their digits (the panels, not the matmuls,
    dominate the time)."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kw):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kw)
    return wrapped


@_highest_precision
def _hermitian_tridiag_blocked(uplo: str, a: jnp.ndarray,
                               nb: int = 32) -> Tridiag:
    """Blocked Householder tridiagonalization (reference
    ``HermitianTridiag.cpp:86-94`` panel algorithm, LAPACK ``latrd`` shape):
    per nb-column panel, each column's reflector is computed against the
    implicitly-updated matrix A − V·Wᴴ − W·Vᴴ (small elementwise
    corrections); the trailing similarity update is then applied as ONE rank-2nb
    matmul pair, and Q is formed at the end by compact-WY block
    reflector application (two matmuls per panel) — matmuls do the
    O(n³) work the rank-1 loop spent in n² outer products."""
    if not uplo.upper().startswith("L"):
        a = jnp.conj(a.T)
    n = a.shape[0]
    dtype = a.dtype
    npan = max(1, -(-max(n - 2, 0) // nb))
    rows = jnp.arange(n)

    def panel(p, carry):
        a, Vall, taus = carry
        j0 = p * nb
        V = jnp.zeros((n, nb), dtype)
        W = jnp.zeros((n, nb), dtype)

        def col(j, st):
            a, V, W, Vall, taus = st
            k = j0 + j
            elim = k < n - 2
            # implicit column k of A − VWᴴ − WVᴴ (panel-local correction)
            colk = (a[:, k] - V @ jnp.conj(W[k, :]) - W @ jnp.conj(V[k, :]))
            x = jnp.where((rows > k) & elim, colk, 0.0)
            normx = jnp.linalg.norm(x)
            pivot = x[k + 1] if n > 1 else x[0]
            absp = jnp.abs(pivot)
            phase = jnp.where(absp == 0, jnp.ones((), dtype), pivot / absp)
            v = x.at[jnp.minimum(k + 1, n - 1)].add(
                jnp.where(elim, phase * normx, 0.0))
            vnorm2 = jnp.sum(jnp.abs(v) ** 2)
            tau = jnp.where((vnorm2 == 0) | ~elim, 0.0,
                            2.0 / jnp.where(vnorm2 == 0, 1.0, vnorm2)
                            ).astype(dtype)
            # w = τ·(A − VWᴴ − WVᴴ)·v, then the two-sided correction
            w = tau * (a @ v - V @ (jnp.conj(W.T) @ v)
                       - W @ (jnp.conj(V.T) @ v))
            w = w - (tau / 2) * jnp.vdot(v, w) * v
            V = V.at[:, j].set(v)
            W = W.at[:, j].set(w)
            Vall = Vall.at[:, k].set(v)
            taus = taus.at[k].set(tau)
            return (a, V, W, Vall, taus)

        a, V, W, Vall, taus = jax.lax.fori_loop(
            0, nb, col, (a, V, W, Vall, taus))
        # trailing rank-2nb similarity update as two matmuls
        a = a - V @ jnp.conj(W.T) - W @ jnp.conj(V.T)
        return (a, Vall, taus)

    Vall0 = jnp.zeros((n, npan * nb), dtype)
    taus0 = jnp.zeros((npan * nb,), dtype)
    a, Vall, taus = jax.lax.fori_loop(0, npan, panel, (a, Vall0, taus0))

    # form Q by compact-WY per panel: Q ← Q − (Q·V)·T·Vᴴ, T from
    # T⁻¹ = diag(1/τ) + strict_upper(VᴴV) (τ=0 columns are exact no-ops)
    q = jnp.eye(n, dtype=dtype)

    def apply_panel(p, q):
        V = jax.lax.dynamic_slice_in_dim(Vall, p * nb, nb, 1)
        t = jax.lax.dynamic_slice_in_dim(taus, p * nb, nb, 0)
        M = jnp.conj(V.T) @ V
        inv_t = jnp.where(t == 0, 1.0, 1.0 / jnp.where(t == 0, 1.0, t))
        Tinv = jnp.triu(M, 1) + jnp.diag(inv_t)
        T = jax.lax.linalg.triangular_solve(
            Tinv, jnp.eye(nb, dtype=dtype), left_side=True, lower=False)
        return q - (q @ V) @ T @ jnp.conj(V.T)

    q = jax.lax.fori_loop(0, npan, apply_panel, q)

    d = jnp.real(jnp.diagonal(a))
    sub = jnp.diagonal(a, -1)
    if jnp.issubdtype(dtype, jnp.complexfloating):
        absd = jnp.abs(sub)
        phases = jnp.where(absd == 0, jnp.ones_like(sub), sub / absd)
        dscale = jnp.concatenate([jnp.ones((1,), dtype),
                                  jnp.cumprod(phases)])
        q = q * dscale[None, :]
        e = absd
    else:
        e = jnp.real(sub)
    return Tridiag(d, e, q)


class Bidiag(NamedTuple):
    d: jnp.ndarray
    e: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray


@_highest_precision
def _bidiag_blocked(a: jnp.ndarray, nb: int = 32) -> Bidiag:
    """Blocked upper bidiagonalization (reference ``Bidiag/`` panel
    algorithm; LAPACK ``gebrd``/``labrd`` shape, built on the same
    implicit-panel-column machinery as :func:`_hessenberg_blocked`):

    per nb-panel each column/row of the implicit Ã = Uᴴ·A·V is
    reconstructed from the reflector panels (sequential O((m+n)·nb) vector
    ops + two fresh matvecs per column), and the two-sided trailing update
    is applied to A as matmuls via compact-WY on both sides:
        A ← A − Uq·Tqᴴ·(Uqᴴ·A) − (A·Vp)·Tp·Vpᴴ + Uq·Tqᴴ·(Uqᴴ·A·Vp)·Tp·Vpᴴ.
    """
    m, n = a.shape
    dtype = a.dtype
    npan = -(-n // nb)
    rm = jnp.arange(m)
    rn = jnp.arange(n)
    Uall0 = jnp.zeros((m, npan * nb), dtype)
    Vall0 = jnp.zeros((n, npan * nb), dtype)
    tq_all0 = jnp.zeros((npan * nb,), dtype)
    tp_all0 = jnp.zeros((npan * nb,), dtype)

    def seq_apply(P, taus, w, upto, conj_tau):
        """w ← (Π_{j<upto} (I − τ_j p_j p_jᴴ))ᴴ-or-not · w, forward order."""
        def body(j, w):
            act = j < upto
            pj = jnp.where(act, P[:, j], 0.0)
            tj = jnp.where(act, jnp.conj(taus[j]) if conj_tau else taus[j],
                           0.0)
            return w - tj * pj * (jnp.conj(pj) @ w)
        return jax.lax.fori_loop(0, nb, body, w)

    def seq_apply_rev(P, taus, w, upto):
        """w ← Π (I−τpp̂) · w applied right-to-left, tracking coefficients
        c with w_out = w_in − P·c (for the A·(V·e_k) = a_k − (A·P)·c trick)."""
        def body(t, wc):
            w, c = wc
            j = upto - 1 - t
            act = j >= 0
            pj = jnp.where(act, P[:, jnp.maximum(j, 0)], 0.0)
            tj = jnp.where(act, taus[jnp.maximum(j, 0)], 0.0)
            alpha = tj * (jnp.conj(pj) @ w)
            w = w - alpha * pj
            c = c.at[jnp.maximum(j, 0)].add(jnp.where(act, alpha, 0.0))
            return w, c
        nbv = P.shape[1]
        return jax.lax.fori_loop(0, nbv, body,
                                 (w, jnp.zeros(nbv, dtype)))

    def reflector(x, piv_idx, elim, size_dtype):
        normx = jnp.linalg.norm(x)
        pivot = x[piv_idx]
        absp = jnp.abs(pivot)
        phase = jnp.where(absp == 0, jnp.ones((), dtype), pivot / absp)
        v = x.at[piv_idx].add(jnp.where(elim, phase * normx, 0.0))
        vn = jnp.sum(jnp.abs(v) ** 2)
        tau = jnp.where((vn == 0) | ~elim, 0.0,
                        2.0 / jnp.where(vn == 0, 1.0, vn)).astype(dtype)
        return jnp.where(elim, v, 0.0), tau

    def panel(p, carry):
        a, Uall, Vall, tq_all, tp_all = carry
        j0 = p * nb
        Uq = jnp.zeros((m, nb), dtype)
        Vp = jnp.zeros((n, nb), dtype)
        Ya = jnp.zeros((m, nb), dtype)          # A·Vp columns
        tq = jnp.zeros((nb,), dtype)
        tp = jnp.zeros((nb,), dtype)

        def col(jj, st):
            a, Uq, Vp, Ya, tq, tp = st
            k = j0 + jj
            # -- column k of Ã = Uᴴ·A·V ---------------------------------
            ek = jnp.zeros(n, dtype).at[jnp.minimum(k, n - 1)].set(1.0)
            _, c = seq_apply_rev(Vp, tp, ek, jj)        # V·e_k = e_k − Vp·c
            t = a[:, jnp.minimum(k, n - 1)] - Ya @ c    # A·(V·e_k)
            colk = seq_apply(Uq, tq, t, jj, conj_tau=True)   # Uᴴ·t
            # left reflector: eliminate rows > k (pivot at k)
            x = jnp.where((rm >= k) & (k < n), colk, 0.0)
            u_k, tauq = reflector(x, jnp.minimum(k, m - 1), k < n, m)
            Uq = Uq.at[:, jj].set(u_k)
            tq = tq.at[jj].set(tauq)
            # -- row k of H_ukᴴ·Ã (right reflector source) --------------
            uek = jnp.zeros(m, dtype).at[jnp.minimum(k, m - 1)].set(1.0)
            ue, _ = seq_apply_rev(Uq, tq, uek, jj + 1)  # U·e_k (incl u_k)
            s = jnp.conj(a.T) @ ue                       # Aᴴ·(U e_k)
            rowk = seq_apply(Vp, tp, s, jj, conj_tau=True)
            rowk = jnp.conj(rowk)
            elim_r = k < n - 2
            xr = jnp.where(rn > k, jnp.conj(rowk), 0.0)
            v_k, taup = reflector(xr, jnp.minimum(k + 1, n - 1), elim_r, n)
            Vp = Vp.at[:, jj].set(v_k)
            tp = tp.at[jj].set(taup)
            Ya = Ya.at[:, jj].set(a @ v_k)
            return (a, Uq, Vp, Ya, tq, tp)

        a, Uq, Vp, Ya, tq, tp = jax.lax.fori_loop(
            0, nb, col, (a, Uq, Vp, Ya, tq, tp))
        # two-sided compact-WY trailing update (matmuls)
        Tq = _wy_t(Uq, tq, nb)
        Tp = _wy_t(Vp, tp, nb)
        UhA = jnp.conj(Uq.T) @ a
        a = a - Uq @ (jnp.conj(Tq.T) @ UhA)              # left
        AV = Ya - Uq @ (jnp.conj(Tq.T) @ (jnp.conj(Uq.T) @ Ya))
        a = a - AV @ (Tp @ jnp.conj(Vp.T))               # right
        Uall = jax.lax.dynamic_update_slice(Uall, Uq, (0, j0))
        Vall = jax.lax.dynamic_update_slice(Vall, Vp, (0, j0))
        tq_all = jax.lax.dynamic_update_slice(tq_all, tq, (j0,))
        tp_all = jax.lax.dynamic_update_slice(tp_all, tp, (j0,))
        return (a, Uall, Vall, tq_all, tp_all)

    a, Uall, Vall, tq_all, tp_all = jax.lax.fori_loop(
        0, npan, panel, (a, Uall0, Vall0, tq_all0, tp_all0))

    u = jnp.eye(m, dtype=dtype)
    v = jnp.eye(n, dtype=dtype)

    def apply_panels(p, uv):
        u, v = uv
        Uq = jax.lax.dynamic_slice_in_dim(Uall, p * nb, nb, 1)
        Vp = jax.lax.dynamic_slice_in_dim(Vall, p * nb, nb, 1)
        tqp = jax.lax.dynamic_slice_in_dim(tq_all, p * nb, nb, 0)
        tpp = jax.lax.dynamic_slice_in_dim(tp_all, p * nb, nb, 0)
        u = u - (u @ Uq) @ _wy_t(Uq, tqp, nb) @ jnp.conj(Uq.T)
        v = v - (v @ Vp) @ _wy_t(Vp, tpp, nb) @ jnp.conj(Vp.T)
        return u, v

    u, v = jax.lax.fori_loop(0, npan, apply_panels, (u, v))
    # (blocked path is dispatched for REAL dtypes only; complex uses the
    # rank-1 variant below, which phase-folds)
    d = jnp.diagonal(a)[:n]
    e = jnp.diagonal(a, 1)[:max(n - 1, 0)]
    return Bidiag(jnp.real(d), jnp.real(e), u, v)


def bidiag(A: Arr, blocksize: int = 32) -> Bidiag:
    """Reduce A (m≥n) to upper bidiagonal B = Uᴴ A V (reference ``Bidiag``).
    ``blocksize>0`` with real n ≥ 192 dispatches the blocked panel variant
    (``blocksize=0`` forces the rank-1 loop — benchmarking hook)."""
    a0 = as_array(A)
    if a0.shape[1] >= 192 and blocksize > 0 \
            and not jnp.issubdtype(a0.dtype, jnp.complexfloating):
        return _bidiag_blocked(a0, nb=blocksize)
    a = a0
    m, n = a.shape
    u = jnp.eye(m, dtype=a.dtype)
    v = jnp.eye(n, dtype=a.dtype)

    def left_reflect(a, u, k):
        x = jnp.where(jnp.arange(m) >= k, a[:, k], 0.0)
        normx = jnp.linalg.norm(x)
        pivot = x[k]
        absp = jnp.abs(pivot)
        phase = jnp.where(absp == 0, jnp.ones((), a.dtype), pivot / absp)
        w = x.at[k].add(phase * normx)
        wn = jnp.sum(jnp.abs(w) ** 2)
        tau = jnp.where(wn == 0, 0.0, 2.0 / wn).astype(a.dtype)
        a = a - tau * jnp.outer(w, jnp.conj(w) @ a)
        u = u - tau * jnp.outer(u @ w, jnp.conj(w))
        return a, u

    def right_reflect(a, v, k):
        x = jnp.where(jnp.arange(n) > k, jnp.conj(a[k, :]), 0.0)
        normx = jnp.linalg.norm(x)
        pivot = x[k + 1]
        absp = jnp.abs(pivot)
        phase = jnp.where(absp == 0, jnp.ones((), a.dtype), pivot / absp)
        w = x.at[k + 1].add(phase * normx)
        wn = jnp.sum(jnp.abs(w) ** 2)
        tau = jnp.where(wn == 0, 0.0, 2.0 / wn).astype(a.dtype)
        a = a - tau * jnp.outer(a @ jnp.conj(w), w)
        v = v - tau * jnp.outer(v @ jnp.conj(w), w)
        return a, v

    def body(k, state):
        a, u, v = state
        a, u = left_reflect(a, u, k)
        a, v = jax.lax.cond(k < n - 2,
                            lambda ops: right_reflect(ops[0], ops[1], k),
                            lambda ops: (ops[0], ops[1]),
                            (a, v))
        return (a, u, v)

    a, u, v = jax.lax.fori_loop(0, n, body, (a, u, v))
    d = jnp.real(jnp.diagonal(a))
    e = jnp.real(jnp.diagonal(a, 1))
    return Bidiag(d, e, u, v)


class Hess(NamedTuple):
    h: jnp.ndarray
    q: jnp.ndarray


def _wy_t(V: jnp.ndarray, taus: jnp.ndarray, nb: int) -> jnp.ndarray:
    """Compact-WY T for H = H₀·H₁⋯ = I − V·T·Vᴴ:
    T⁻¹ = diag(1/τ) + strict_upper(VᴴV) (τ=0 columns are exact no-ops)."""
    M = jnp.conj(V.T) @ V
    inv_t = jnp.where(taus == 0, 1.0,
                      1.0 / jnp.where(taus == 0, 1.0, taus))
    Tinv = jnp.triu(M, 1) + jnp.diag(inv_t)
    return jax.lax.linalg.triangular_solve(
        Tinv, jnp.eye(nb, dtype=V.dtype), left_side=True, lower=False)


@_highest_precision
def _hessenberg_blocked(a: jnp.ndarray, nb: int = 32) -> Hess:
    """Blocked Hessenberg reduction (reference ``Hessenberg/LUnb.hpp`` +
    panel variant; LAPACK ``gehrd``/``lahr2`` shape, sharing the latrd-style
    machinery of :func:`_hermitian_tridiag_blocked`):

    per nb-panel the reflectors are formed against the IMPLICIT
    Ã = Hᴴ·A·H (each panel column reconstructed with O(n·nb) vector ops
    from the caches V and Y = A·V — one fresh matvec per column), then the
    two-sided update is applied to all of A as FOUR matmuls via the
    compact-WY form H = I − V·T·Vᴴ:
        A ← A − V·Tᴴ·(Vᴴ·A) − Y·T·Vᴴ + V·Tᴴ·(Vᴴ·Y)·T·Vᴴ.
    """
    n = a.shape[0]
    dtype = a.dtype
    q = jnp.eye(n, dtype=dtype)
    if n <= 2:
        return Hess(a, q)
    npan = -(-(n - 2) // nb)
    rows = jnp.arange(n)
    Vall0 = jnp.zeros((n, npan * nb), dtype)
    taus_all0 = jnp.zeros((npan * nb,), dtype)

    def panel(p, carry):
        a, Vall, taus_all = carry
        j0 = p * nb
        V = jnp.zeros((n, nb), dtype)
        Y = jnp.zeros((n, nb), dtype)       # Y = A·V
        taus = jnp.zeros((nb,), dtype)

        def col(jj, st):
            a, V, Y, taus = st
            k = j0 + jj
            elim = k < n - 2
            jidx = jnp.arange(nb)

            # u = H·e_k with the panel-so-far reflectors (apply right-to-
            # left: H_{k-1} first); track c with u = e_k − V·c
            def ap_right(t, uc):
                u, c = uc
                j = jj - 1 - t                       # k-1-j0 … 0
                act = j >= 0
                vj = jnp.where(act, V[:, jnp.maximum(j, 0)], 0.0)
                tj = jnp.where(act, taus[jnp.maximum(j, 0)], 0.0)
                alpha = tj * (jnp.conj(vj) @ u)
                u = u - alpha * vj
                c = c.at[jnp.maximum(j, 0)].add(
                    jnp.where(act, alpha, 0.0))
                return u, c

            e_k = jnp.zeros(n, dtype).at[k].set(1.0)
            u, c = jax.lax.fori_loop(0, nb, ap_right,
                                     (e_k, jnp.zeros(nb, dtype)))
            # t = A·u = a[:,k] − Y·c (A unchanged within the panel)
            t = a[:, k] - Y @ c

            # w = Hᴴ·t (apply H_{j0}ᴴ first)
            def ap_left(j, w):
                act = j < jj
                vj = jnp.where(act, V[:, j], 0.0)
                tj = jnp.where(act, jnp.conj(taus[j]), 0.0)
                return w - tj * vj * (jnp.conj(vj) @ w)

            w = jax.lax.fori_loop(0, nb, ap_left, t)

            # reflector eliminating rows > k+1 of the implicit column
            x = jnp.where(rows > k, w, 0.0)
            normx = jnp.linalg.norm(x)
            pivot = x[jnp.minimum(k + 1, n - 1)]
            absp = jnp.abs(pivot)
            phase = jnp.where(absp == 0, jnp.ones((), dtype), pivot / absp)
            v = x.at[jnp.minimum(k + 1, n - 1)].add(
                jnp.where(elim, phase * normx, 0.0))
            vn = jnp.sum(jnp.abs(v) ** 2)
            tau = jnp.where((vn == 0) | ~elim, 0.0,
                            2.0 / jnp.where(vn == 0, 1.0, vn)).astype(dtype)
            v = jnp.where(elim, v, 0.0)
            V = V.at[:, jj].set(v)
            Y = Y.at[:, jj].set(a @ v)          # the one fresh matvec
            taus = taus.at[jj].set(tau)
            return (a, V, Y, taus)

        a, V, Y, taus = jax.lax.fori_loop(0, nb, col, (a, V, Y, taus))
        # two-sided compact-WY trailing update, all matmuls
        T = _wy_t(V, taus, nb)
        VhA = jnp.conj(V.T) @ a
        a = a - V @ (jnp.conj(T.T) @ VhA)        # left:  Hᴴ·A
        AV = Y - V @ (jnp.conj(T.T) @ (jnp.conj(V.T) @ Y))  # Hᴴ·A·V
        a = a - AV @ (T @ jnp.conj(V.T))         # right: (Hᴴ·A)·H
        Vall = jax.lax.dynamic_update_slice(Vall, V, (0, j0))
        taus_all = jax.lax.dynamic_update_slice(taus_all, taus, (j0,))
        return (a, Vall, taus_all)

    a, Vall, taus_all = jax.lax.fori_loop(0, npan, panel,
                                          (a, Vall0, taus_all0))

    def apply_panel(p, q):
        V = jax.lax.dynamic_slice_in_dim(Vall, p * nb, nb, 1)
        t = jax.lax.dynamic_slice_in_dim(taus_all, p * nb, nb, 0)
        T = _wy_t(V, t, nb)
        return q - (q @ V) @ T @ jnp.conj(V.T)

    q = jax.lax.fori_loop(0, npan, apply_panel, q)
    # mask the reduction roundoff below the subdiagonal
    a = jnp.where(rows[:, None] > rows[None, :] + 1, 0.0, a)
    return Hess(a, q)


def hessenberg(uplo: str, A: Arr, blocksize: int = 32) -> Hess:
    """Reduce A to upper Hessenberg H = Qᴴ A Q (reference ``Hessenberg``).

    XLA fuses the rank-1 loop's outer products into few kernels, so the
    loop serves small n and the blocked panel variant n ≥ 3072; the
    crossover has not been measured on the GPU (``blocksize=0`` forces the
    rank-1 loop)."""
    a0 = as_array(A)
    if a0.shape[0] >= 3072 and blocksize > 0:
        return _hessenberg_blocked(a0, nb=blocksize)
    a = a0
    n = a.shape[0]
    q = jnp.eye(n, dtype=a.dtype)

    def body(k, state):
        a, q = state
        x = jnp.where(jnp.arange(n) > k, a[:, k], 0.0)
        normx = jnp.linalg.norm(x)
        pivot = x[k + 1]
        absp = jnp.abs(pivot)
        phase = jnp.where(absp == 0, jnp.ones((), a.dtype), pivot / absp)
        v = x.at[k + 1].add(phase * normx)
        vn = jnp.sum(jnp.abs(v) ** 2)
        tau = jnp.where(vn == 0, 0.0, 2.0 / vn).astype(a.dtype)
        a = a - tau * jnp.outer(v, jnp.conj(v) @ a)        # left
        a = a - tau * jnp.outer(a @ v, jnp.conj(v))        # right
        q = q - tau * jnp.outer(q @ v, jnp.conj(v))
        return (a, q)

    if n > 2:
        a, q = jax.lax.fori_loop(0, n - 2, body, (a, q))
    return Hess(a, q)
