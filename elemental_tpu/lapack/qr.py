"""QR factorization (reference ``src/lapack_like/factor/QR/``: blocked
Householder, tall-skinny TSQR tree reduce ``TS.hpp``, BusingerGolub column
pivoting, Cholesky-QR, Explicit, ApplyQ).

Design:
  * general QR — XLA's ``geqrf`` + ``householder_product`` primitives
    (blocked compact-WY on device).
  * TSQR — ``shard_map`` binary-tree reduction of local QRs over the flat
    ('mc','mr') axis: the direct analog of the reference's tree reduce, with
    each tree level one all-gather-of-R + local QR.
  * CholeskyQR2 — two rounds of (AᵀA → chol → trsm); the fastest matmul path
    for well-conditioned tall-skinny operands.
  * column-pivoted QR — masked ``fori_loop`` with norm downdating
    (BusingerGolub).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import jax
import jax.numpy as jnp

from ..core.distmatrix import DistMatrix, as_array, like
from ..core.grid import Grid
from ..ops.level3 import trsm, with_precision
from .cholesky import cholesky

Arr = Union[jnp.ndarray, DistMatrix]


class QR(NamedTuple):
    q: jnp.ndarray
    r: jnp.ndarray


class QRPivoted(NamedTuple):
    q: jnp.ndarray
    r: jnp.ndarray
    perm: jnp.ndarray  # A[:, perm] = Q·R


@with_precision
def qr(A: Arr, full_matrices: bool = False) -> QR:
    """Householder QR (reference ``QR``)."""
    a = as_array(A)
    q, r = jnp.linalg.qr(a, mode="complete" if full_matrices else "reduced")
    return QR(q, r)


@with_precision
def qr_householder(A: Arr):
    """Packed Householder form (reference's in-place representation,
    LAPACK geqrf convention: R in the upper triangle, reflector vectors below
    the diagonal with implicit unit heads, plus ``taus``).  Computed by a
    masked ``fori_loop`` of reflections; compatible with XLA's
    ``householder_product``."""
    a = as_array(A)
    m, n = a.shape
    k = min(m, n)
    taus0 = jnp.zeros((k,), a.dtype)
    rows = jnp.arange(m)

    def body(j, state):
        a, taus = state
        x = jnp.where(rows >= j, a[:, j], 0.0)
        normx = jnp.linalg.norm(x)
        alpha = x[j]
        absa = jnp.abs(alpha)
        phase = jnp.where(absa == 0, jnp.ones((), a.dtype), alpha / absa)
        beta = -phase * normx
        denom = alpha - beta
        safe = jnp.where(denom == 0, 1.0, denom)
        v = jnp.where(rows > j, x / safe, 0.0).at[j].set(1.0)
        tau = jnp.where(normx == 0, jnp.zeros((), a.dtype),
                        (beta - alpha) / beta)
        a = a - tau * jnp.outer(v, jnp.conj(v) @ a)
        # store the reflector below the diagonal of column j
        a = a.at[:, j].set(jnp.where(rows > j, v, a[:, j]))
        a = a.at[j, j].set(jnp.where(normx == 0, alpha, beta))
        return (a, taus.at[j].set(tau))

    packed, taus = jax.lax.fori_loop(0, k, body, (a, taus0))
    return packed, taus


def apply_q(packed: jnp.ndarray, taus: jnp.ndarray, B: Arr,
            adjoint: bool = False) -> Arr:
    """Apply Q (or Qᴴ) from packed Householder form to B (reference
    ``qr::ApplyQ``)."""
    m = packed.shape[0]
    q = jax.lax.linalg.householder_product(packed, taus)
    b = as_array(B)
    out = (jnp.conj(q.T) @ b) if adjoint else (q @ b)
    return like(B, out)


@with_precision
def tsqr(A: Arr, grid: Grid = None, tree: bool = None) -> QR:
    """Tall-skinny QR over the flat mesh axis (reference ``QR/TS.hpp``).

    A is row-partitioned [VC,*]; each device factors its local block, then
    the n×n R factors combine across devices by one of two strategies:

    * ``tree=True`` — butterfly all-reduce TSQR: log₂p rounds of pairwise
      R exchange (``ppermute``) + 2n×n QR, every rank ending with the same
      R (the reference's tree reduce, comm volume n²·log p per rank).
    * ``tree=False`` — single all-gather of all p R factors + one p·n×n QR
      on every rank (comm p·n² but ONE collective — lower latency).
    * ``tree=None`` — crossover dispatch: the butterfly needs p a power of
      two and wins when the gathered stack p·n² is large; otherwise the
      one-shot all-gather's single-collective latency wins.
    """
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    a = as_array(A)
    if grid is None and isinstance(A, DistMatrix):
        grid = A.grid
    if grid is None or grid.size == 1:
        return qr(a)
    p = grid.size
    m, n = a.shape
    pad_m = ((m + p - 1) // p) * p
    a_p = jnp.pad(a, ((0, pad_m - m), (0, 0)))

    flat_spec = P(("mc", "mr"), None)
    axis = ("mc", "mr")
    pow2 = (p & (p - 1)) == 0
    if tree is None:
        # crossover: gathered-stack bytes beyond ~4 MB → tree wins
        tree = pow2 and p * n * n * a.dtype.itemsize > (4 << 20)
    if tree and not pow2:
        raise ValueError(f"tree TSQR needs a power-of-two mesh, got p={p}")

    def local_gather(ablk):
        q0, r0 = jnp.linalg.qr(ablk, mode="reduced")
        rs = jax.lax.all_gather(r0, axis, axis=0, tiled=True)  # (p*n, n)
        q1, r = jnp.linalg.qr(rs, mode="reduced")
        rank = jax.lax.axis_index(axis)
        q1_blk = jax.lax.dynamic_slice_in_dim(q1, rank * n, n, 0)  # (n, n)
        return q0 @ q1_blk, r

    def local_tree(ablk):
        q0, r = jnp.linalg.qr(ablk, mode="reduced")
        q = q0
        rank = jax.lax.axis_index(axis)
        for lvl in range(p.bit_length() - 1):
            stride = 1 << lvl
            perm = [(i, i ^ stride) for i in range(p)]
            r_other = jax.lax.ppermute(r, axis, perm)
            half = (rank >> lvl) & 1       # my position in the pair stack
            # canonical order (lower rank first) so BOTH partners compute
            # the identical stacked QR — all ranks converge to the same R
            stack = jnp.where(half == 0,
                              jnp.concatenate([r, r_other], axis=0),
                              jnp.concatenate([r_other, r], axis=0))
            q1, r = jnp.linalg.qr(stack, mode="reduced")
            blk = jax.lax.dynamic_slice_in_dim(q1, half * n, n, 0)
            q = q @ blk
        return q, r

    # check_vma=False: R is computed redundantly (identically) on every rank
    # after the combine; the replication is real but not statically provable
    # through the qr primitive.
    fn = shard_map(local_tree if tree else local_gather, mesh=grid.mesh,
                   in_specs=(flat_spec,),
                   out_specs=(flat_spec, P(None, None)), check_vma=False)
    q, r = fn(jax.lax.with_sharding_constraint(
        a_p, NamedSharding(grid.mesh, flat_spec)))
    return QR(q[:m], r)


@with_precision
def cholesky_qr(A: Arr, iterations: int = 2) -> QR:
    """CholeskyQR2 (reference ``QR/Cholesky.hpp``): Q·R via Gram-matrix
    Cholesky, iterated twice for stability.  All flops are matmuls."""
    a = as_array(A)
    q = a
    r_total = jnp.eye(a.shape[1], dtype=a.dtype)
    for _ in range(iterations):
        g = jnp.matmul(jnp.conj(q.T), q, preferred_element_type=a.dtype)
        rr = jnp.conj(jnp.tril(as_array(cholesky("L", g))).T)  # upper
        q = trsm("R", "U", "N", "N", 1, rr, q)
        q = as_array(q)
        r_total = rr @ r_total
    return QR(q, r_total)


@with_precision
def qr_pivoted(A: Arr) -> QRPivoted:
    """Column-pivoted (BusingerGolub) QR via a masked Householder loop
    (reference ``QR/BusingerGolub.hpp``).  The loop's own factorization is
    the output: R comes from the reduced matrix, Q from applying the stored
    reflectors to I — no second factorization."""
    a = as_array(A)
    m, n = a.shape
    steps = min(m, n)
    perm0 = jnp.arange(n)
    taus0 = jnp.zeros((steps,), a.dtype)
    vs0 = jnp.zeros((steps, m), a.dtype)

    def body(k, state):
        a, perm, taus, vs = state
        norms = jnp.sum(jnp.abs(a) ** 2
                        * (jnp.arange(m) >= k)[:, None], axis=0)
        masked = jnp.where(jnp.arange(n) >= k, norms, -1.0)
        j = jnp.argmax(masked)
        cidx = jnp.arange(n).at[k].set(j).at[j].set(k)
        a = a[:, cidx]
        perm = perm[cidx]
        # Householder on column k, rows k: (phase-aligned for complex)
        x = jnp.where(jnp.arange(m) >= k, a[:, k], 0.0)
        normx = jnp.linalg.norm(x)
        alpha = a[k, k]
        absa = jnp.abs(alpha)
        phase = jnp.where(absa > 0, alpha / jnp.where(absa > 0, absa, 1.0),
                          jnp.ones((), a.dtype))
        v = x.at[k].add(phase * normx)
        vnorm2 = jnp.sum(jnp.abs(v) ** 2)
        vnorm2 = jnp.where(vnorm2 == 0, 1.0, vnorm2)
        tau = (2.0 / vnorm2).astype(a.dtype)
        w = tau * (jnp.conj(v) @ a)
        a = a - jnp.outer(v, w)
        taus = taus.at[k].set(tau)
        vs = vs.at[k].set(v)
        return (a, perm, taus, vs)

    a_out, perm, taus, vs = jax.lax.fori_loop(
        0, steps, body, (a, perm0, taus0, vs0))
    r = jnp.triu(a_out[:steps])
    # Q = H_0 · H_1 · … · H_{s−1} · I_{m×s}: apply reflectors in reverse
    q0 = jnp.eye(m, steps, dtype=a.dtype)

    def form_q(i, q):
        k = steps - 1 - i
        v = vs[k]
        return q - taus[k] * jnp.outer(v, jnp.conj(v) @ q)

    q = jax.lax.fori_loop(0, steps, form_q, q0)
    return QRPivoted(q, r, perm)


def explicit_qr(A: Arr) -> QR:
    """Explicit unitary Q and triangular R (reference ``QR/Explicit.hpp``)."""
    return qr(A)


def lq(A: Arr) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """LQ factorization A = L·Q (reference ``factor/LQ``) via QR of Aᴴ."""
    a = as_array(A)
    q, r = jnp.linalg.qr(jnp.conj(a.T), mode="reduced")
    return jnp.conj(r.T), jnp.conj(q.T)


def rq(A: Arr) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """RQ factorization A = R·Q (reference ``factor/RQ``) via flipped LQ."""
    a = as_array(A)
    m, n = a.shape
    l, q = lq(a[::-1, :])
    # a[::-1] = L Q ⇒ a = (L row-flipped) Q; make R upper by col-flip of L
    r = l[::-1, ::-1]
    qf = q[::-1, :]
    return r, qf
