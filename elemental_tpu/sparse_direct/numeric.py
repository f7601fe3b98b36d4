"""Multifrontal numeric factorization + tree solves (reference
``src/lapack_like/factor/LDL/sparse/numeric``: ``Process.hpp:150-275``
extend-add, ``ProcessFront.hpp:29-60`` dense front kernel,
``LowerSolve/Forward.hpp:77-183`` tree solves).

Design: the elimination tree is processed **level by level**
(height-bucketed).  Each level is a fixed-shape batch of padded fronts living
in one flat device pool; per level the executor runs

  1. extend-add: one gather + scatter-add of every child Schur complement
     (the reference's ``SparseAllToAll`` pack/unpack becomes two indexed ops),
  2. a vmapped masked *partial* LDL of all fronts in the level (rank-1
     updates under a ``fori_loop``; the Schur complement is left in place),

so the whole factorization is ~``num_levels`` fused XLA steps regardless of
supernode count, and re-factorization with new values
(``ChangeNonzeroValues``) reuses every plan.  Solves use the padded-unit
trick: extending the partial factor with an identity trailing block makes one
batched ``triangular_solve`` per level perform both the panel solve and the
update accumulation.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import jax
import jax.numpy as jnp

from .symbolic import SymbolicFactorization


def _clamp_pivot(dk, s):
    """Dynamic pivot regularization (reference ``RegularizedLDL``): when a
    signed floor s ≠ 0 is given for this column, boost a too-small pivot's
    MAGNITUDE to |s| — keeping the pivot's own sign (an exactly-zero pivot
    takes s's sign).  Never flips a nonzero pivot across zero: forcing the
    'expected' quasi-definite sign is an O(1) perturbation of the factored
    matrix that cascades into overflow at scale (the sign-forcing variant
    overflows the n≈7k FD KKT factor in fp32), while a
    magnitude boost bounds element growth by |col|/|s| and stays close to
    the true matrix; iterative refinement against the TRUE matrix absorbs
    the perturbation."""
    if s is None:
        return dk
    mag = jnp.abs(s)
    keep = jnp.where(dk == 0, jnp.sign(s), jnp.sign(dk))
    return jnp.where((s != 0) & (jnp.abs(dk) < mag), keep * mag, dk)


def _masked_partial_ldl(F: jnp.ndarray, ns: jnp.ndarray, max_ns: int,
                        conjugate: bool,
                        pf: Optional[jnp.ndarray] = None):
    """Eliminate the first ``ns`` columns of the padded front F (S×S lower),
    leaving L (unit, scaled) in the panel, D on the diagonal, and the Schur
    complement in the trailing block.  ``pf``: optional (S,) signed pivot
    floors (see :func:`_clamp_pivot`)."""
    S = F.shape[0]
    idx = jnp.arange(S)

    def body(k, F):
        elim = k < ns
        dk = F[k, k]
        if pf is not None:
            dk = jnp.where(elim, _clamp_pivot(dk, pf[k]), dk)
        safe = jnp.where(dk == 0, jnp.ones((), F.dtype), dk)
        col = jnp.where((idx > k) & elim, F[:, k] / safe, 0.0)
        row = jnp.conj(col) if conjugate else col
        F = F - jnp.outer(col, row) * dk
        F = F.at[:, k].set(jnp.where((idx > k) & elim, col, F[:, k]))
        F = F.at[k, k].set(dk)
        return F

    return jax.lax.fori_loop(0, max_ns, body, F)


def _masked_partial_ldl_blocked(F: jnp.ndarray, ns: jnp.ndarray,
                                max_ns: int, conjugate: bool,
                                nb: int = 32,
                                pf: Optional[jnp.ndarray] = None):
    """Blocked right-looking variant of :func:`_masked_partial_ldl`
    (reference ``ProcessFront.hpp:29-60``: blocked LDL + Trsm + rank-k).

    Per nb-column panel: eliminate within the S×nb panel with rank-1
    updates, then apply the trailing rank-nb update as ONE S×S matmul — a
    matrix unit does the O(S²·nb) work the sequential variant spends in S²
    outer products.  Identical update domain to the rank-1 version (every (i,j)
    with i,j > pivot), so Schur extend-add semantics are unchanged."""
    S = F.shape[0]
    nb = max(1, min(nb, max_ns))
    npan = -(-max_ns // nb)
    Sp = max(S, npan * nb)
    if Sp != S:
        F = jnp.pad(F, ((0, Sp - S), (0, Sp - S)))
        if pf is not None:
            pf = jnp.pad(pf, (0, Sp - S))
    idx = jnp.arange(Sp)
    tpan = jnp.arange(nb)

    def panel_body(p, F):
        j0 = p * nb

        def inner(kk, Fp):
            k = j0 + kk
            elim = k < ns
            dk = Fp[k, kk]
            if pf is not None:
                dk = jnp.where(elim, _clamp_pivot(dk, pf[k]), dk)
            safe = jnp.where(dk == 0, jnp.ones((), Fp.dtype), dk)
            col = jnp.where((idx > k) & elim, Fp[:, kk] / safe, 0.0)
            # within-panel trailing update needs L at the panel pivot rows
            colp = jax.lax.dynamic_slice(col, (j0,), (nb,))
            rowvec = jnp.where(tpan > kk, colp, 0.0)
            rowvec = jnp.conj(rowvec) if conjugate else rowvec
            Fp = Fp - jnp.outer(col, rowvec) * dk
            Fp = Fp.at[:, kk].set(jnp.where((idx > k) & elim, col,
                                            Fp[:, kk]))
            Fp = Fp.at[k, kk].set(dk)
            return Fp

        Fp = jax.lax.dynamic_slice(F, (0, j0), (Sp, nb))
        Fp = jax.lax.fori_loop(0, nb, inner, Fp)
        F = jax.lax.dynamic_update_slice(F, Fp, (0, j0))
        # trailing rank-nb update as one matmul: U = (Lp·dp)·Lpᵀ, cols ≥ j1
        prow = j0 + tpan
        dp = Fp[prow, tpan]
        # non-eliminated panel columns (pivot ≥ ns) hold Schur data, not L
        Lp = jnp.where((idx[:, None] > prow[None, :])
                       & (prow[None, :] < ns), Fp, 0.0)
        LpT = jnp.conj(Lp).T if conjugate else Lp.T
        U = (Lp * dp[None, :]) @ LpT
        return F - U * (idx[None, :] >= j0 + nb)

    F = jax.lax.fori_loop(0, npan, panel_body, F)
    return F[:S, :S] if Sp != S else F


def _masked_partial_spd(F: jnp.ndarray, ns: jnp.ndarray, max_ns: int,
                        conjugate: bool):
    """SPD fast path: the whole partial factorization as THREE fused XLA
    ops — masked batched Cholesky of the leading block, one triangular
    solve for the panel, one matmul for the Schur complement (reference
    ``ProcessFront.hpp``'s dense-front kernel, expressed as XLA primitives
    instead of a scalar loop).  Produces the same pool layout as the LDL
    kernels: unit-L panel, D on the diagonal, Schur in the trailing block."""
    S = F.shape[0]
    m = int(max_ns)
    im = jnp.arange(m)
    iS = jnp.arange(S)
    lead = F[:m, :m]
    # fronts carry only the lower triangle; Cholesky reads a full matrix
    low = jnp.tril(lead)
    lowT = jnp.conj(jnp.tril(lead, -1)).T if conjugate \
        else jnp.tril(lead, -1).T
    lead = low + lowT
    maskb = (im[:, None] < ns) & (im[None, :] < ns)
    A11 = jnp.where(maskb, lead,
                    (im[:, None] == im[None, :]).astype(F.dtype))
    L11 = jnp.linalg.cholesky(A11)
    colm = im[None, :] < ns
    B = jnp.where(colm, F[:, :m], 0.0)
    # P·L11ᵀ = B  ⇒  P = the Cholesky panel (rows of L), S×m
    P = jax.lax.linalg.triangular_solve(
        L11, B, left_side=False, lower=True,
        transpose_a=True, conjugate_a=conjugate)
    dm = jnp.diagonal(L11)
    Lunit = P / dm[None, :]
    panel = jnp.where(colm & (iS[:, None] > im[None, :]), Lunit, F[:, :m])
    dvals = jnp.broadcast_to((dm * dm)[None, :], (S, m))
    panel = jnp.where(colm & (iS[:, None] == im[None, :]), dvals, panel)
    F = F.at[:, :m].set(panel)
    PT = jnp.conj(P).T if conjugate else P.T
    U = P @ PT
    return F - U * (iS[None, :] >= ns)


@dataclasses.dataclass
class LDLFactorization:
    """Numeric factor state (reference ``(Dist)SparseLDLFactorization``
    facade, ``numeric.hpp:550``)."""

    symb: SymbolicFactorization
    pool: jnp.ndarray            # flat packed fronts (L panels + Schur)
    d: jnp.ndarray               # (n,) pivots in permuted order
    conjugate: bool

    # -- solves -------------------------------------------------------------
    def solve(self, b, ctx=None) -> jnp.ndarray:
        # precision pinned for the same reason as factor(): the level
        # triangular solves lower to matmuls, which would run in TF32
        with jax.default_matmul_precision("highest"):
            return self._solve_impl(b, ctx)

    def solve_context(self):
        """Precompute per-level explicit panel inverses L⁻¹ (jit-safe).

        Inverting each unit-lower panel ONCE per factor turns every
        subsequent solve's level step into one batched matmul
        (``linv @ xf``) instead of a batched triangular solve, which
        pays off when many solves share one factor (the FGMRES sweeps of
        the at-scale IPM).

        Numerics: applying an explicit triangular inverse bounds the
        residual by eps·κ(L_panel) instead of substitution's eps·‖L‖,
        so the context is used where a Krylov wrapper absorbs the
        difference (``KKTFactor.solve_refined``'s FGMRES preconditioner
        — reference ``SolveAfter``/refined path,
        ``DistSparseLDLFactorization.cpp:264``), not in the plain
        direct ``solve()``."""
        with jax.default_matmul_precision("highest"):
            out = []
            for lev in self.symb.levels:
                lp, eye = self._level_panels(lev)
                out.append(self._tri(lp, jnp.broadcast_to(eye, lp.shape),
                                     forward=True))
            return tuple(out)

    def _solve_impl(self, b, ctx=None) -> jnp.ndarray:
        symb = self.symb
        n = symb.n
        x = jnp.asarray(b)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        k = x.shape[1]
        perm = jnp.asarray(symb.perm)
        # x extended with a dummy row absorbing padded scatter traffic
        xe = jnp.concatenate([x[perm], jnp.zeros((1, k), x.dtype)], axis=0)

        # forward: ascending levels
        for i, lev in enumerate(symb.levels):
            xe = self._level_solve(xe, lev, forward=True,
                                   linv=None if ctx is None else ctx[i])
        # diagonal
        xe = xe.at[:n].set(xe[:n] / self.d[:, None].astype(xe.dtype))
        # backward: descending levels
        for i, lev in reversed(list(enumerate(symb.levels))):
            xe = self._level_solve(xe, lev, forward=False,
                                   linv=None if ctx is None else ctx[i])

        iperm = jnp.asarray(symb.iperm)
        out = xe[:n][iperm]
        return out[:, 0] if squeeze else out

    def _level_fronts(self, lev):
        nf = lev.sn_ids.shape[0]
        S = lev.front_size
        seg = jax.lax.dynamic_slice_in_dim(self.pool, lev.offset,
                                           nf * S * S, 0)
        return seg.reshape(nf, S, S)

    def _level_panels(self, lev):
        """Masked unit-lower panels (nf, S, S) for one level, plus eye."""
        S = lev.front_size
        fronts = self._level_fronts(lev)
        idx = jnp.arange(S)
        colmask = idx[None, None, :] < jnp.asarray(lev.ns)[:, None, None]
        eye = jnp.eye(S, dtype=fronts.dtype)
        lp = jnp.where(colmask & (idx[None, :, None] > idx[None, None, :]),
                       fronts, 0.0) + eye[None]
        return lp, eye

    def _tri(self, lp, xf, forward: bool):
        """Batched unit-lower triangular solve of one level's panels."""
        return jax.lax.linalg.triangular_solve(
            lp, xf, left_side=True, lower=True, unit_diagonal=True,
            transpose_a=not forward,
            conjugate_a=(not forward) and self.conjugate)

    def _level_solve(self, xe, lev, forward: bool, linv=None):
        rows = jnp.asarray(lev.front_rows)                 # (nf, S)
        xf = xe[rows]                                      # (nf, S, k)
        if linv is not None:
            # precomputed panel inverse (solve_context): one batched
            # matmul per level — L⁻¹·xf forward, L⁻ᵀ·xf backward
            op = linv if forward else jnp.swapaxes(linv, -1, -2)
            if (not forward) and self.conjugate:
                op = jnp.conj(op)
            w = jnp.einsum("fij,fjk->fik", op, xf)
        else:
            lp, _ = self._level_panels(lev)
            w = self._tri(lp, xf, forward)
        delta = w - xf
        return xe.at[rows.reshape(-1)].add(
            delta.reshape(-1, delta.shape[-1]))

    def solve_with_iterative_refinement(self, A_apply, b, iters: int = 6,
                                        unroll: bool = False):
        """x ← x + F⁻¹(b − A·x) (reference
        ``SolveWithIterativeRefinement``, ``DistSparseLDLFactorization.cpp:264``).
        ``unroll``: straight-line refinement steps instead of a
        ``fori_loop`` (one tree-solve instance in the graph)."""
        b = jnp.asarray(b)
        x = self.solve(b)

        def body(i, x):
            r = b - A_apply(x)
            return x + self.solve(r)

        if unroll:
            for i in range(iters):
                x = body(i, x)
            return x
        return jax.lax.fori_loop(0, iters, body, x)

    # -- products ------------------------------------------------------------
    def multiply_with_l(self, x, adjoint: bool = False) -> jnp.ndarray:
        """y = L·x (or Lᴴ·x) in permuted order (reference ``MultiplyWithL``
        — used by the solver's residual diagnostics)."""
        xe = jnp.asarray(x)
        squeeze = xe.ndim == 1
        if squeeze:
            xe = xe[:, None]
        xe = jnp.concatenate([xe, jnp.zeros((1, xe.shape[1]), xe.dtype)], 0)
        # y = x + Σ_panels (L−I)_panel·x — panel contributions are linear in
        # the ORIGINAL x (columns are disjoint across supernodes), so deltas
        # accumulate into a separate output
        ye = xe
        for lev in self.symb.levels:
            nf = lev.sn_ids.shape[0]
            S = lev.front_size
            fronts = self._level_fronts(lev)
            idx = jnp.arange(S)
            colmask = idx[None, None, :] < jnp.asarray(
                lev.ns)[:, None, None]
            eye = jnp.eye(S, dtype=fronts.dtype)
            lp = jnp.where(colmask
                           & (idx[None, :, None] > idx[None, None, :]),
                           fronts, 0.0) + eye[None]
            if adjoint:
                lp = jnp.conj(jnp.swapaxes(lp, -1, -2)) if self.conjugate \
                    else jnp.swapaxes(lp, -1, -2)
            rows = jnp.asarray(lev.front_rows)
            xf = xe[rows]
            yf = jnp.einsum("fij,fjk->fik", lp, xf)
            ye = ye.at[rows.reshape(-1)].add(
                (yf - xf).reshape(-1, xf.shape[-1]))
        out = ye[:self.symb.n]
        return out[:, 0] if squeeze else out

    def inertia(self):
        d = jnp.real(self.d)
        return (jnp.sum(d > 0), jnp.sum(d < 0), jnp.sum(d == 0))


# pytree: factor state passes through jit as an ARGUMENT (see
# core/statics.py)
from ..core.statics import register_plan_pytree  # noqa: E402

register_plan_pytree(LDLFactorization, ("symb", "pool", "d"))


def _shard_level(fronts, mesh, axis):
    """Subtree-to-device / front-2D mapping (reference ``Process.hpp:150-275``
    subtree→subteam plus the 1D→2D front switch of ``numeric.hpp:29-38``):

    * many small fronts (lower tree levels): shard the BATCH axis — sibling
      subtrees map to devices, the reference's team split;
    * few big fronts (the separator tops, where the O(S³) flops live):
      shard the (S, S) front dims over the 2D mesh — GSPMD distributes the
      chol/trsm/rank-k front kernel the way the reference's L2D [MC,MR]
      fronts do.

    Extend-add between levels becomes XLA-inserted collectives either way;
    ``dryrun_multichip`` measures the net effect against single-device."""
    from jax.sharding import NamedSharding, PartitionSpec
    nf, S = fronts.shape[0], fronts.shape[1]
    ndev = mesh.devices.size
    # On the 8-virtual-device CPU mesh (24³/32³ Laplacians), sharding
    # EVERY level ran 40× slower than single-device — per-level collectives
    # swamp the small batched kernels — and 2D (S,S)-sharding the big top
    # fronts through GSPMD ran 90× slower: GSPMD cannot pipeline a sharded
    # (batched) Cholesky, it all-gathers.  So: batch-shard only levels with
    # enough sibling fronts AND enough flops to amortize the boundary
    # collectives.  The flop-dominant top separator fronts go through the
    # hand-written shard_map panel factorization (dist_front.py, the
    # reference's L2D [MC,MR] fronts) when S ≥ dist_front_min.
    if nf < ndev or nf * S ** 3 < 2e9:
        return fronts
    sh = NamedSharding(mesh, PartitionSpec(axis))
    if isinstance(fronts, jax.core.Tracer):
        return jax.lax.with_sharding_constraint(fronts, sh)
    return jax.device_put(fronts, sh)


def factor(symb: SymbolicFactorization, a_vals, conjugate: bool = False,
           reg: Optional[np.ndarray] = None,
           dtype=jnp.float64, mesh=None, tree_axis: Optional[str] = None,
           panel_blocksize: int = 32, spd: bool = False,
           pivot_floor=None,
           dist_front_min: int = 0) -> LDLFactorization:
    """Numeric multifrontal LDL given the symbolic plan and A's values
    (+ optional diagonal regularization in *original* order, the
    ``RegularizedLDL`` path).

    ``mesh``: optional ``jax.sharding.Mesh`` — each level's front batch is
    sharded over ``tree_axis`` (default: the mesh's first axis), mapping
    sibling subtrees to devices.  ``panel_blocksize``: panel width of the
    blocked front kernel (levels whose elimination width exceeds it use
    the blocked right-looking path).

    ``pivot_floor``: optional (n,) SIGNED per-column pivot floors in
    *original* order — the reference ``RegularizedLDL``'s dynamic
    regularization: each pivot is forced onto its floor's side of zero with
    magnitude ≥ |floor| (see :func:`_clamp_pivot`); pair with iterative
    refinement / FGMRES against the unperturbed matrix.

    ``dist_front_min``: with a ``mesh`` and a value > 0, levels of at
    most 8 fronts of size ≥ this are panel-factored across the whole mesh
    (:mod:`.dist_front`); 0 leaves the tier off."""
    with jax.default_matmul_precision("highest"):
        return _factor_impl(symb, a_vals, conjugate, reg, dtype, mesh,
                            tree_axis, panel_blocksize, spd, pivot_floor,
                            dist_front_min)


def _factor_impl(symb, a_vals, conjugate, reg, dtype, mesh, tree_axis,
                 panel_blocksize, spd, pivot_floor, dist_front_min):
    # Matmul precision is pinned to 'highest' by the factor() wrapper: the
    # front kernels' trailing updates ((Lp·dp)·Lpᵀ, P·Pᵀ, the batched
    # cholesky/triangular_solve) otherwise may run f32 products in TF32 or
    # bf16, and that product error amplified by the factorization's
    # intermediate cancellation destroys the factor for quasi-definite KKT
    # matrices (a factored-solve residual of O(1) against its OWN factored
    # matrix at N=150K with θ spread [0.05, 0.72]).
    a_vals = jnp.asarray(a_vals, dtype)
    pin = lambda p: p
    if mesh is not None:
        # keep the flat pool replicated: left to GSPMD it is sharded, and
        # every dynamic-offset level update then all-gathers a full copy
        from jax.sharding import NamedSharding, PartitionSpec
        rep = NamedSharding(mesh, PartitionSpec())
        pin = lambda p: jax.lax.with_sharding_constraint(p, rep)
    pool = pin(jnp.zeros((symb.pool_size,), dtype))
    pfp = None
    if pivot_floor is not None:
        # permuted floors, with a trailing 0 row absorbing padded gathers
        pfp = jnp.concatenate([
            jnp.asarray(pivot_floor, dtype)[jnp.asarray(symb.perm)],
            jnp.zeros((1,), dtype)])

    # assemble every level's A entries up front (independent of elimination)
    for lev in symb.levels:
        if lev.asm_dst.size:
            pool = pool.at[jnp.asarray(lev.asm_dst)].add(
                a_vals[jnp.asarray(lev.asm_src)])
        if reg is not None and lev.diag_dst.size:
            regp = jnp.asarray(reg, dtype)[jnp.asarray(symb.perm)]
            pool = pool.at[jnp.asarray(lev.diag_dst)].add(
                regp[jnp.asarray(lev.diag_cols)])

    d = jnp.zeros((symb.n,), dtype)
    for lev in symb.levels:
        nf = lev.sn_ids.shape[0]
        S = lev.front_size
        if lev.child_dst.size:
            pool = pin(pool.at[jnp.asarray(lev.child_dst)].add(
                pool[jnp.asarray(lev.child_src)]))
        seg = jax.lax.dynamic_slice_in_dim(pool, lev.offset, nf * S * S, 0)
        fronts = seg.reshape(nf, S, S)
        # distributed 2D-front path (reference L2D [MC,MR] fronts,
        # numeric.hpp:29-38): the few flop-dominant top-separator fronts
        # are panel-factored across the WHOLE mesh instead of replicated
        use_dist_front = (
            mesh is not None and 0 < dist_front_min <= S and nf <= 8
            and not jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating))
        if use_dist_front:
            from .dist_front import dist_partial_ldl
            ns_dev = jnp.asarray(lev.ns)
            pf_lev = (None if pfp is None
                      else pfp[jnp.asarray(lev.front_rows)])
            outs = []
            for fs in range(nf):
                outs.append(dist_partial_ldl(
                    fronts[fs], ns_dev[fs], mesh, conjugate=conjugate,
                    pf=None if pf_lev is None else pf_lev[fs]))
            fronts = jnp.stack(outs)
            pool = pin(jax.lax.dynamic_update_slice_in_dim(
                pool, fronts.reshape(-1), lev.offset, 0))
            d = d.at[jnp.asarray(lev.diag_cols)].set(
                pool[jnp.asarray(lev.diag_dst)])
            continue
        if mesh is not None:
            fronts = _shard_level(fronts, mesh,
                                  tree_axis or mesh.axis_names[0])
        max_ns = int(lev.ns.max())
        if spd:
            kern = lambda F, ns: _masked_partial_spd(F, ns, max_ns,
                                                     conjugate)
            fronts = jax.vmap(kern)(fronts, jnp.asarray(lev.ns))
        else:
            pf_lev = (None if pfp is None
                      else pfp[jnp.asarray(lev.front_rows)])
            if max_ns > panel_blocksize:
                kern = lambda F, ns, pf: _masked_partial_ldl_blocked(
                    F, ns, max_ns, conjugate, nb=panel_blocksize, pf=pf)
            else:
                kern = lambda F, ns, pf: _masked_partial_ldl(
                    F, ns, max_ns, conjugate, pf=pf)
            if pf_lev is None:
                fronts = jax.vmap(lambda F, ns: kern(F, ns, None))(
                    fronts, jnp.asarray(lev.ns))
            else:
                fronts = jax.vmap(kern)(fronts, jnp.asarray(lev.ns),
                                        pf_lev)
        pool = pin(jax.lax.dynamic_update_slice_in_dim(
            pool, fronts.reshape(-1), lev.offset, 0))
        d = d.at[jnp.asarray(lev.diag_cols)].set(
            pool[jnp.asarray(lev.diag_dst)])

    return LDLFactorization(symb, pool, d, conjugate)
