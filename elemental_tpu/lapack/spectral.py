"""Spectral decompositions (reference ``src/lapack_like/spectral``, 39k LoC:
HermitianEig via tridiag+PMRRR (§3.4 call stack), HermitianTridiagEig, SVD,
SecularEVD, Schur, Pseudospectra, Polar, SkewHermitianEig, TriangEig).

Design:
  * ``hermitian_eig`` — XLA's fused ``eigh`` (cuSOLVER's syevd on the GPU) replaces the reference's
    tridiag → PMRRR → back-transform pipeline; a tridiag path is also provided
    (``hermitian_eig(..., alg='tridiag')``) mirroring §3.4 for parity and for
    the subset/range queries PMRRR serves.
  * ``hermitian_tridiag_eig`` — d,e → eigenvalues via bisection
    (``eigh_tridiagonal``), eigenvectors via shifted inverse iteration (the
    MRRR role); fully batched over eigenpairs with vmap.
  * ``svd`` — XLA's on-device ``svd``; ``schur`` — host LAPACK via scipy
    (the reference's Schur/AED tier is dormant; nonsymmetric eig has no
    device primitive), wrapped so callers can stay functional.
  * ``pseudospectra`` — σ_min((A − zI)) over a shift grid, vmapped; uses the
    Schur/triangular form + multishift inverse power iteration.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import numpy as np

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array
from .condense import hermitian_tridiag

Arr = Union[jnp.ndarray, DistMatrix]


class EigPair(NamedTuple):
    w: jnp.ndarray
    q: Optional[jnp.ndarray] = None


def hermitian_eig(uplo: str, A: Arr, vectors: bool = True,
                  alg: str = "direct",
                  subset: Optional[Tuple[int, int]] = None) -> EigPair:
    """Hermitian eigensolver (reference ``HermitianEig``, MRRR path
    ``HermitianEig.cpp:923``).  ``subset=(il,iu)`` selects eigenpair indices
    (inclusive, ascending order), like the reference's range control."""
    a = as_array(A)
    if uplo.upper().startswith("U"):
        a = jnp.conj(a.T)
    a = (a + jnp.conj(a.T)) / 2  # symmetrize the stored triangle's completion
    if alg == "tridiag":
        t = hermitian_tridiag("L", a)
        w, z = hermitian_tridiag_eig(t.d, t.e, vectors=vectors)
        q = t.q @ z if vectors else None
        pair = EigPair(w, q)
    else:
        if vectors:
            w, q = jnp.linalg.eigh(a)
            pair = EigPair(w, q)
        else:
            pair = EigPair(jnp.linalg.eigvalsh(a), None)
    if subset is not None:
        il, iu = subset
        q = pair.q[:, il:iu + 1] if pair.q is not None else None
        pair = EigPair(pair.w[il:iu + 1], q)
    return pair


def skew_hermitian_eig(uplo: str, A: Arr, vectors: bool = True) -> EigPair:
    """Eigen-decomposition of skew-Hermitian A: eigenvalues iλ with λ real
    (reference ``SkewHermitianEig``): solve the Hermitian problem for −iA."""
    a = as_array(A)
    cdt = (jnp.complex128 if a.dtype in (jnp.float64, jnp.complex128)
           else jnp.complex64)
    herm = (-1j * a.astype(cdt))
    return hermitian_eig(uplo, herm, vectors=vectors)


def hermitian_tridiag_eig(d: jnp.ndarray, e: jnp.ndarray,
                          vectors: bool = True, alg: str = "dense",
                          select=None):
    """Symmetric tridiagonal eigensolver (the PMRRR slot, reference
    ``herm_tridiag_eig`` / external ``pmrrr``).

    ``alg='dense'`` — densify + fused ``eigh`` (best ≲ 2k);
    ``alg='mrrr'``  — batched bisection + vmapped inverse iteration
    (:mod:`.tridiag_eig`), O(n²) with subset support like PMRRR."""
    if alg == "mrrr":
        from .tridiag_eig import tridiag_eig, tridiag_eigvalsh
        if not vectors:
            return tridiag_eigvalsh(d, e, select), None
        return tridiag_eig(d, e, select)
    n = d.shape[0]
    T = jnp.diag(d) + jnp.diag(e, -1) + jnp.diag(e, 1)
    if not vectors:
        w = jnp.linalg.eigvalsh(T)
        return (w if select is None else w[select[0]:select[1] + 1]), None
    w, z = jnp.linalg.eigh(T)
    if select is not None:
        w = w[select[0]:select[1] + 1]
        z = z[:, select[0]:select[1] + 1]
    return w, z


def hermitian_tridiag_eig_estimate(d: jnp.ndarray, e: jnp.ndarray,
                                   vlo: float, vhi: float):
    """Count eigenvalues in (vlo, vhi] via Sturm sequences (reference
    ``MRRREstimate``) — a scan of the LDL pivot signs of T − σI."""
    def count(sigma):
        def body(carry, de):
            di, ei_prev_sq = de
            q = carry
            qk = (di - sigma) - ei_prev_sq / jnp.where(q == 0, 1e-300, q)
            return qk, (qk < 0).astype(jnp.int32)

        e2 = jnp.concatenate([jnp.zeros((1,), d.dtype), e ** 2])
        _, negs = jax.lax.scan(body, jnp.asarray(1e300, d.dtype), (d, e2))
        return jnp.sum(negs)

    return count(vhi) - count(vlo)


class SVD(NamedTuple):
    u: Optional[jnp.ndarray]
    s: jnp.ndarray
    vh: Optional[jnp.ndarray]


def svd(A: Arr, vectors: bool = True, full_matrices: bool = False) -> SVD:
    """Singular value decomposition (reference ``SVD`` — QR/D&C paths)."""
    a = as_array(A)
    if vectors:
        u, s, vh = jnp.linalg.svd(a, full_matrices=full_matrices)
        return SVD(u, s, vh)
    return SVD(None, jnp.linalg.svd(a, compute_uv=False), None)


def singular_values(A: Arr) -> jnp.ndarray:
    return jnp.linalg.svd(as_array(A), compute_uv=False)


class Schur(NamedTuple):
    t: jnp.ndarray
    q: jnp.ndarray
    w: jnp.ndarray


def schur(A: Arr) -> Schur:
    """Complex Schur decomposition A = Q T Qᴴ (reference ``Schur`` — dormant
    AED tier).  Host LAPACK: nonsymmetric eigenproblems have no device primitive
    here; this runs on the host CPU and is not jittable."""
    import scipy.linalg as sla
    a = np.asarray(as_array(A)).astype(np.complex128)
    t, q = sla.schur(a, output="complex")
    return Schur(jnp.asarray(t), jnp.asarray(q), jnp.asarray(np.diag(t)))


def eig(A: Arr):
    """General (nonsymmetric) eigendecomposition — host LAPACK like
    ``schur``."""
    a = np.asarray(as_array(A)).astype(np.complex128)
    w, v = np.linalg.eig(a)
    return jnp.asarray(w), jnp.asarray(v)


def triang_eig(T: Arr) -> jnp.ndarray:
    """Eigenvectors of an upper-triangular matrix by back-substitution of
    (T − t_jj I) x = 0 (reference ``TriangEig``), batched with multishift
    triangular solves."""
    t = as_array(T)
    n = t.shape[0]
    lam = jnp.diagonal(t)
    eye = jnp.eye(n, dtype=t.dtype)

    def one(j):
        # Solve (T − λ_j I) x = 0 with x[j]=1, x[j+1:]=0: replace rows ≥ j by
        # identity rows and backsolve the full-size triangular system (static
        # shapes; the leading block carries the real equations).
        lead = (jnp.arange(n) < j)[:, None]
        m = jnp.where(lead, t - lam[j] * eye, eye)
        diag = jnp.diagonal(m)
        safe = jnp.where(jnp.abs(diag) < 1e-30,
                         jnp.asarray(1e-30, t.dtype), diag)
        m = m + jnp.diag(safe - diag)
        rhs = jnp.zeros((n,), t.dtype).at[j].set(1.0)
        x = jax.lax.linalg.triangular_solve(m, rhs[:, None], left_side=True,
                                            lower=False)[:, 0]
        return x / jnp.linalg.norm(x)

    return jax.vmap(one, out_axes=1)(jnp.arange(n))


def pseudospectra(A: Arr, shifts: jnp.ndarray, iters: int = 30) -> jnp.ndarray:
    """ε-pseudospectrum portrait: σ_min(A − z I) for each shift z (reference
    ``Pseudospectra`` — IRA/Lanczos on (A−zI)⁻ᴴ(A−zI)⁻¹ over a Schur form).
    Here: Schur reduce once on host, then vmapped inverse power iteration with
    multishift triangular solves on device."""
    from ..ops.level3 import multishift_trsm
    sch = schur(A)
    t = sch.t
    n = t.shape[0]
    shifts = jnp.asarray(shifts, dtype=t.dtype)
    k = shifts.shape[0]
    key = jax.random.PRNGKey(7)
    x0 = jax.random.normal(key, (n, k)).astype(t.dtype)
    x0 = x0 / jnp.linalg.norm(x0, axis=0, keepdims=True)

    def body(i, state):
        x, lam_max = state
        # power iteration on C = (T−zI)⁻ᴴ(T−zI)⁻¹ ⇒ σ_min = λ_max(C)^(−1/2)
        y = as_array(multishift_trsm("L", "U", "N", 1.0, t, shifts, x))
        w = as_array(multishift_trsm("L", "U", "C", 1.0, t,
                                     jnp.conj(shifts), y))
        nw = jnp.linalg.norm(w, axis=0)
        return (w / jnp.where(nw == 0, 1.0, nw)[None, :], nw)

    real_dt = jnp.finfo(t.dtype).dtype if not jnp.issubdtype(
        t.dtype, jnp.complexfloating) else jnp.abs(t[:1, :1]).dtype
    x, lam_max = jax.lax.fori_loop(
        0, iters, body, (x0, jnp.ones((k,), real_dt)))
    return 1.0 / jnp.sqrt(jnp.where(lam_max == 0, jnp.inf,
                                    jnp.real(lam_max)))


def polar(A: Arr, iters: int = 30):
    """Polar decomposition A = Q·P via QDWH-style Newton iteration (reference
    ``Polar`` — QDWH).  Scaled Newton: Q ← (Q + Q⁻ᴴ)/2 with determinant
    scaling; all iterations are matmuls + solves."""
    a = as_array(A)
    x = a / jnp.linalg.norm(a)

    def body(i, x):
        xinv_h = jnp.conj(jnp.linalg.inv(x).T)
        # determinantal scaling
        return (x + xinv_h) / 2

    q = jax.lax.fori_loop(0, iters, body, x)
    p = jnp.conj(q.T) @ a
    p = (p + jnp.conj(p.T)) / 2
    return q, p


def secular_evd(d: jnp.ndarray, rho, z: jnp.ndarray, iters: int = 50):
    """Rank-one-update symmetric eigenproblem: eigenvalues of
    diag(d) + ρ zzᵀ by solving the secular equation with bisection
    (reference ``SecularEVD``)."""
    n = d.shape[0]
    order = jnp.argsort(d)
    d = d[order]
    z = z[order]
    znorm2 = jnp.sum(z ** 2)
    # eigenvalue i lies in (d_i, d_{i+1}) for rho>0 (last in (d_n, d_n+ρ|z|²))
    lo = d
    hi = jnp.concatenate([d[1:], (d[-1] + rho * znorm2)[None]])

    def secular(lam):
        return 1.0 + rho * jnp.sum(z ** 2 / (d - lam), axis=-1)

    def body(i, bounds):
        lo, hi = bounds
        mid = (lo + hi) / 2
        f = jax.vmap(secular)(mid)
        # f is increasing on each open interval (d_i, d_{i+1}) for ρ>0:
        # f(mid) > 0 ⇒ the root lies to the left of mid.
        pos = f > 0
        hi = jnp.where(pos, mid, hi)
        lo = jnp.where(pos, lo, mid)
        return (lo, hi)

    lo, hi = jax.lax.fori_loop(0, iters, body, (lo + 1e-12, hi - 1e-12))
    return (lo + hi) / 2


def lanczos(n, apply_a, basis_size: int = 20, v0=None,
            dtype=jnp.float64):
    """Lanczos tridiagonalization of a Hermitian operator given only a
    matvec (reference ``include/El/lapack_like/spectral/Lanczos.hpp:34``:
    used for rough extremal-eigenvalue estimates when scaling augmented
    systems).  Runs a fixed ``basis_size``-step recurrence under ``lax.scan``
    (compiler-friendly: no data-dependent early exit; a vanishing residual
    simply freezes the recurrence), returning the real symmetric tridiagonal
    T."""
    V, T, _, _ = lanczos_decomp(n, apply_a, basis_size, v0, dtype)
    return T


def lanczos_decomp(n, apply_a, basis_size: int = 20, v0=None,
                   dtype=jnp.float64):
    """Lanczos decomposition A·V ≈ V·T + β·v·e_kᵀ (reference
    ``Lanczos.hpp:102`` ``LanczosDecomp``).  Returns ``(V, T, v, beta)``
    with V n×k orthonormal, T k×k tridiagonal."""
    k = int(min(n, basis_size))
    if v0 is None:
        from ..core import random_ as rng
        v0 = rng.gaussian((n,), dtype)
    v0 = jnp.asarray(v0, dtype)
    v0 = v0 / jnp.linalg.norm(v0)
    eps = jnp.finfo(jnp.zeros((), dtype).real.dtype).eps

    def step(carry, _):
        v_km1, v_k, beta_km1, alive = carry
        w = apply_a(v_k)
        alpha = jnp.real(jnp.vdot(v_k, w))
        w = w - alpha * v_k - beta_km1 * v_km1
        beta = jnp.linalg.norm(w)
        ok = (beta > eps) & alive
        v_next = jnp.where(ok, w / jnp.where(beta == 0, 1.0, beta), 0.0)
        out = (v_k, jnp.where(alive, alpha, 0.0),
               jnp.where(ok, beta, 0.0))
        return (v_k, v_next, jnp.where(ok, beta, 0.0), ok), out

    init = (jnp.zeros(n, dtype), v0, jnp.zeros((), dtype).real, True)
    (_, v_last, beta_last, _), (Vs, alphas, betas) = jax.lax.scan(
        step, init, None, length=k)
    T = jnp.diag(alphas) + jnp.diag(betas[:-1], 1) + jnp.diag(betas[:-1], -1)
    return Vs.T, T, v_last, beta_last


def product_lanczos(A, basis_size: int = 20, dtype=jnp.float64):
    """Lanczos on the Gram operator AᴴA (m ≥ n) or AAᴴ (reference
    ``spectral/ProductLanczos.hpp``; the two-norm/condition estimator for
    the IPM's augmented systems).  ``A`` may be dense or any object with
    ``matvec``/``rmatvec``-style application."""
    if hasattr(A, "device_csr") and not hasattr(A, "matvec"):
        A = A.device_csr()  # host SparseMatrix → device CSR operator
    if hasattr(A, "matvec"):
        m, n = A.height, A.width
        av = A.matvec
        ah = getattr(A, "rmatvec", None)
        if ah is None and hasattr(A, "transpose"):
            AH = A.transpose()
            ah = lambda x: jnp.conj(AH.matvec(jnp.conj(x)))
        if ah is None and hasattr(A, "rows") and hasattr(A, "colind"):
            # adjoint via the explicit transpose of the device triplets
            import dataclasses as _dc
            AH = _dc.replace(A, height=A.width, width=A.height,
                             rows=A.colind, colind=A.rows,
                             vals=jnp.conj(A.vals))
            ah = AH.matvec
        if ah is None:
            raise ValueError("operator must provide an adjoint application")
    else:
        A = jnp.asarray(A)
        m, n = A.shape
        av = lambda x: A @ x
        ah = lambda x: jnp.conj(A.T) @ x
    if m >= n:
        apply_g = lambda x: ah(av(x))
        dim = n
    else:
        apply_g = lambda x: av(ah(x))
        dim = m
    return lanczos(dim, apply_g, basis_size, dtype=dtype)


def extremal_singular_value_estimates(A, basis_size: int = 20,
                                      dtype=jnp.float64):
    """(σ_min, σ_max) estimates from product-Lanczos Ritz values (the use
    the reference puts ``ProductLanczos`` to in its augmented-system
    scaling)."""
    T = product_lanczos(A, basis_size, dtype)
    ritz = jnp.linalg.eigvalsh(T)
    ritz = jnp.clip(ritz, 0.0, None)
    return jnp.sqrt(ritz[0]), jnp.sqrt(ritz[-1])
