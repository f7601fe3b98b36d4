"""Fixed-pattern sparse KKT engine — the device-resident core of the IPM
tier.

Reference pipeline (SURVEY §3.6, ``examples/interface/LPDirect.py:70-115``):
per iteration, form the regularized quasi-definite KKT, re-factor with
``RegularizedLDL`` *reusing the symbolic analysis* via ``ChangeNonzeroValues``
(``DistSparseLDLFactorization.cpp:149``), then run refined solves.

Design: the KKT pattern is assembled ONCE on host (static blocks:
A, Aᵀ, G, Gᵀ, Q, regularization diagonals; dynamic slots: the barrier
diagonal Θ, cone scaling blocks).  Per-iteration work is pure device code
inside one jitted program: scatter-add the dynamic values into the fixed
value vector, run the level-batched multifrontal LDL
(:func:`elemental_tpu.sparse_direct.numeric.factor`), and solve with
iterative refinement against the *unregularized* KKT (one CSR segment-sum
SpMV per refinement step).  No ``to_dense``, no SciPy, no host round-trips
in the hot loop.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from ..sparse.csr import SparseMatrix
from ..sparse_direct.symbolic import SymbolicFactorization, analyze
from ..sparse_direct.numeric import LDLFactorization, factor as _mf_factor


class KKTBuilder:
    """Assemble a symmetric quasi-definite KKT pattern from static COO
    blocks plus *dynamic slots* whose values change every IPM iteration
    (the reference's ``ChangeNonzeroValues`` reuse, made explicit)."""

    def __init__(self, N: int, dtype=np.float64):
        self.N = int(N)
        self.dtype = np.dtype(dtype)
        self._srows: List[np.ndarray] = []
        self._scols: List[np.ndarray] = []
        self._svals: List[np.ndarray] = []
        self._dyn: List[Tuple[np.ndarray, np.ndarray]] = []

    def add_static(self, rows, cols, vals) -> None:
        self._srows.append(np.asarray(rows, np.int64))
        self._scols.append(np.asarray(cols, np.int64))
        self._svals.append(np.asarray(vals, self.dtype))

    def add_dynamic(self, rows, cols) -> int:
        """Register a dynamic slot; per-iteration values are scatter-ADDED
        (duplicates with static entries sum, as in COO assembly).  Returns
        the slot id for :meth:`KKTSystem.assemble`."""
        self._dyn.append((np.asarray(rows, np.int64),
                          np.asarray(cols, np.int64)))
        return len(self._dyn) - 1

    def finalize(self, perm: Optional[np.ndarray] = None, relax: int = 8,
                 cutoff: int = 64, jdtype=None) -> "KKTSystem":
        N = self.N
        srows = (np.concatenate(self._srows) if self._srows
                 else np.empty(0, np.int64))
        scols = (np.concatenate(self._scols) if self._scols
                 else np.empty(0, np.int64))
        svals = (np.concatenate(self._svals) if self._svals
                 else np.empty(0, self.dtype))
        drows = [r for r, _ in self._dyn]
        dcols = [c for _, c in self._dyn]
        all_rows = np.concatenate([srows] + drows)
        all_cols = np.concatenate([scols] + dcols)
        key = all_rows * N + all_cols
        uniq, inv = np.unique(key, return_inverse=True)
        nnz = uniq.shape[0]
        base = np.zeros(nnz, self.dtype)
        np.add.at(base, inv[:srows.size], svals)
        dyn_pos: List[np.ndarray] = []
        off = srows.size
        for r, _ in self._dyn:
            dyn_pos.append(inv[off:off + r.size].copy())
            off += r.size

        rows = (uniq // N).astype(np.int64)
        cols = (uniq % N).astype(np.int64)
        rowptr = np.zeros(N + 1, np.int64)
        np.add.at(rowptr, rows + 1, 1)
        pattern = SparseMatrix(N, N, np.cumsum(rowptr), cols, base)

        if perm is None:
            from ..sparse_direct.ordering import nested_dissection
            perm = nested_dissection(pattern, cutoff=cutoff)
        symb = analyze(pattern, perm=perm, relax=relax).device()
        return KKTSystem(N, pattern, symb,
                         jnp.asarray(base, jdtype),
                         [jnp.asarray(p.astype(np.int32)) for p in dyn_pos],
                         jnp.asarray(rows.astype(np.int32)),
                         jnp.asarray(cols.astype(np.int32)),
                         jdtype)


@dataclasses.dataclass
class KKTSystem:
    """Finalized fixed-pattern KKT: jit-safe assemble / factor / solve /
    matvec building blocks (compose them inside ONE jitted IPM step)."""

    N: int
    pattern: SparseMatrix            # host CSR (structure; vals = statics)
    symb: SymbolicFactorization
    base_vals: jnp.ndarray           # (nnz,) static entries, device
    dyn_pos: List[jnp.ndarray]       # per-slot positions into vals
    csr_rows: jnp.ndarray            # (nnz,) int32 — matvec row ids
    csr_cols: jnp.ndarray            # (nnz,) int32
    jdtype: Optional[object] = None

    @property
    def nnz(self) -> int:
        return int(self.base_vals.shape[0])

    # -- jit-safe building blocks -------------------------------------------
    def assemble(self, dyn_vals: Sequence[jnp.ndarray]) -> jnp.ndarray:
        """Scatter the dynamic slot values onto the static base (device)."""
        vals = self.base_vals
        for pos, v in zip(self.dyn_pos, dyn_vals):
            vals = vals.at[pos].add(v.astype(vals.dtype))
        return vals

    def equilibrate(self, vals: jnp.ndarray, iters: int = 3
                    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Symmetric Ruiz scaling D·K·D (device; pattern unchanged).  The
        IPM KKT diagonal spans ~μ±2 orders of magnitude near convergence —
        equilibrating before the pivot-free quasi-definite LDL bounds the
        element growth (reference ``equilibrate/SymmetricRuiz`` role)."""
        d = jnp.ones(self.N, vals.dtype)
        v = vals
        for _ in range(iters):
            rmax = jax.ops.segment_max(jnp.abs(v), self.csr_rows,
                                       num_segments=self.N)
            d = d / jnp.where(rmax > 0, jnp.sqrt(rmax), 1.0)
            v = vals * d[self.csr_rows] * d[self.csr_cols]
        return v, d

    def prepare(self, vals: jnp.ndarray, spd: bool = False,
                equilibrate: bool = True,
                pivot_floor=None) -> "KKTFactor":
        """Equilibrate + factor the assembled KKT (jit-safe).

        ``pivot_floor``: optional (N,) signed floors (original order) for
        the multifrontal kernel's dynamic pivot regularization (reference
        ``RegularizedLDL``), given in the scale of ``vals``; they are
        mapped into the equilibrated scale (× D²) here."""
        if equilibrate:
            v, scale = self.equilibrate(vals)
        else:
            v, scale = vals, jnp.ones(self.N, vals.dtype)
        if pivot_floor is not None:
            pivot_floor = pivot_floor * scale * scale
        num = _mf_factor(self.symb, v, dtype=v.dtype, spd=spd,
                         pivot_floor=pivot_floor)
        return KKTFactor(self, vals, num.pool, num.d, scale)

    def matvec(self, vals: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
        """K·x with the given value vector (refinement residuals)."""
        prod = vals * x[self.csr_cols]
        return jax.ops.segment_sum(prod, self.csr_rows,
                                   num_segments=self.N)


def _hessenberg_lstsq(H: jnp.ndarray, b: jnp.ndarray, k: int) -> jnp.ndarray:
    """min‖H·y − b‖ for the (k+1)×k GMRES Hessenberg via k Givens
    rotations + back-substitution — elementary ops only, so it is
    jit-safe in any dtype and needs no LAPACK-style solver inside the
    graph (normal equations would square the conditioning, which an f32
    subsolve then cannot survive).  k is small (≤ ~16), the rotations are
    unrolled."""
    R = H
    for j in range(k):
        a1, a2 = R[j, j], R[j + 1, j]
        rho = jnp.sqrt(a1 * a1 + a2 * a2)
        safe = jnp.where(rho > 0, rho, 1.0)
        c = jnp.where(rho > 0, a1 / safe, 1.0)
        s = jnp.where(rho > 0, a2 / safe, 0.0)
        rj, rj1 = R[j], R[j + 1]
        R = R.at[j].set(c * rj + s * rj1)
        R = R.at[j + 1].set(-s * rj + c * rj1)
        bj, bj1 = b[j], b[j + 1]
        b = b.at[j].set(c * bj + s * bj1)
        b = b.at[j + 1].set(-s * bj + c * bj1)
    y = jnp.zeros(k, H.dtype)
    for j in range(k - 1, -1, -1):
        num = b[j] - R[j, :k] @ y     # y[i]=0 for i ≤ j, so this is Σ_{i>j}
        dj = R[j, j]
        y = y.at[j].set(jnp.where(jnp.abs(dj) > 0, num
                                  / jnp.where(dj == 0, 1.0, dj), 0.0))
    return y


@dataclasses.dataclass
class KKTFactor:
    """Factored (equilibrated) KKT: K = D⁻¹·(L·D_L·Lᵀ)·D⁻¹."""

    sys: KKTSystem
    vals: jnp.ndarray               # unscaled assembled values
    pool: jnp.ndarray
    d: jnp.ndarray
    scale: jnp.ndarray              # D (equilibration)

    def solve(self, rhs: jnp.ndarray, ctx=None) -> jnp.ndarray:
        raw = LDLFactorization(self.sys.symb, self.pool, self.d,
                               False).solve(self.scale * rhs, ctx)
        return self.scale * raw

    def solve_context(self):
        """Per-level panel inverses for the equilibrated factor — build
        once per factor, thread through every ``solve_refined`` against
        it (the at-scale IPM loop hoists this out of the per-sweep
        program; see ``lp_direct``'s jfactor)."""
        return LDLFactorization(self.sys.symb, self.pool, self.d,
                                False).solve_context()

    # KKT size above which solve_refined uses panel inverses by default
    CONTEXT_MIN_N = 4096

    def solve_refined(self, rhs: jnp.ndarray,
                      reg_diag: Optional[jnp.ndarray] = None,
                      iters: int = 2, unroll: bool = False,
                      ctx=None) -> jnp.ndarray:
        """Solve K₀·x = rhs where K₀ = K − diag(reg_diag), by ``iters``
        steps of FGMRES preconditioned with the LDL factor of the
        regularized K (the reference's refined ``SolveAfter`` path,
        upgraded from Richardson to a Krylov-optimal correction).  Near
        convergence the IPM KKT is simultaneously ill-conditioned and
        near-singular in the degenerate directions; plain refinement
        either diverges or stalls there, while GMRES minimizes the true
        residual over the preconditioned Krylov space and falls back
        gracefully (the result is never worse than the plain factored
        solve, which is recovered as β·Z[0] — no separate solve).

        The small least-squares min‖H·y − β·e₁‖ is solved by
        :func:`_hessenberg_lstsq` (k unrolled Givens rotations +
        back-substitution).  ``unroll``: straight-line Arnoldi steps
        instead of a ``fori_loop`` (k tree-solve instances in the graph,
        so only for small systems — each instance adds compile time).

        ``ctx``: per-level panel inverses (:meth:`solve_context`); the k
        preconditioner applications then cost one batched matmul per
        level each instead of a batched triangular solve.  Above
        ``CONTEXT_MIN_N`` the context is built here when the caller gives
        none (callers that solve many times per factor build it once and
        pass it).  Below it the solve is substitution, whose eps·‖L‖
        residual beats the inverse's eps·κ(panel) on the ill-conditioned
        spread-θ panels (the f64 RNNLS driver loses its x ≥ 0 guarantee
        with the inverse preconditioner at N=245)."""
        def K0(x):
            kx = self.sys.matvec(self.vals, x)
            if reg_diag is not None:
                kx = kx - reg_diag * x
            return kx

        N = rhs.shape[0]
        if ctx is None and N > self.CONTEXT_MIN_N:
            ctx = self.solve_context()

        beta = jnp.linalg.norm(rhs)
        k = max(1, int(iters))
        V = jnp.zeros((k + 1, N), rhs.dtype)
        V = V.at[0].set(rhs / jnp.where(beta > 0, beta, 1.0))
        Z = jnp.zeros((k, N), rhs.dtype)
        H = jnp.zeros((k + 1, k), rhs.dtype)

        def body(j, carry):
            V, Z, H = carry
            z = self.solve(V[j], ctx)
            w = K0(z)
            mask = jnp.arange(k + 1) <= j
            coef = (V @ w) * mask
            w = w - V.T @ coef
            hn = jnp.linalg.norm(w)
            H = H.at[:, j].set(coef).at[j + 1, j].set(hn)
            V = V.at[j + 1].set(w / jnp.where(hn > 0, hn, 1.0))
            Z = Z.at[j].set(z)
            return V, Z, H

        if unroll:
            carry = (V, Z, H)
            for j in range(k):
                carry = body(j, carry)
            V, Z, H = carry
        else:
            V, Z, H = jax.lax.fori_loop(0, k, body, (V, Z, H))
        e1 = jnp.zeros(k + 1, rhs.dtype).at[0].set(beta)
        y = _hessenberg_lstsq(H, e1, k)
        cand = Z.T @ y
        x0 = beta * Z[0]               # the plain preconditioned solve
        # monotone safeguard: keep the Krylov combination only if it helps
        better = (jnp.linalg.norm(rhs - K0(cand))
                  < jnp.linalg.norm(rhs - K0(x0)))
        return jnp.where(better, cand, x0)


# Pytrees: KKT containers pass through jit as ARGUMENTS so the plan index
# arrays (csr_rows/cols, dyn_pos, the symbolic level plans) never become
# jaxpr constants (see core/statics.py).
from ..core.statics import register_plan_pytree  # noqa: E402

register_plan_pytree(KKTSystem, ("symb", "base_vals", "dyn_pos",
                                 "csr_rows", "csr_cols"))
register_plan_pytree(KKTFactor, ("sys", "vals", "pool", "d", "scale"))
