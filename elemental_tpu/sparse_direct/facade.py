"""Sparse-direct facade (reference ``(Dist)SparseLDLFactorization``:
``DistSparseLDLFactorization.cpp:53-268`` — Initialize / Factor / Solve /
SolveWithIterativeRefinement / ChangeNonzeroValues / MultiplyWithL)."""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax.numpy as jnp

from ..core.policy import default_real_dtype, residual_bound, x64_enabled
from ..sparse.csr import SparseMatrix
from .symbolic import SymbolicFactorization, analyze
from .numeric import LDLFactorization, factor


class SparseLDLFactorization:
    """Supernodal multifrontal LDLᵀ/LDLᴴ solver.

    Usage mirrors the reference (``tests/lapack_like/SparseLDL.cpp:50-210``):

        f = SparseLDLFactorization()
        f.initialize(A, hermitian=False)   # ordering + symbolic (host)
        f.factor()                         # numeric (device, level-batched)
        x = f.solve(b)
        f.change_nonzero_values(new_vals)  # reuse symbolic; refactor
    """

    def __init__(self, mesh=None, tree_axis=None, spd=False):
        # mesh: optional jax.sharding.Mesh — subtree-to-device sharding of
        # each level's front batch (reference subtree→subteam mapping)
        self.mesh = mesh
        self.tree_axis = tree_axis
        # spd: use the Cholesky fast path (batched XLA chol+trsm+matmul per
        # level) — valid when A is HPD (reference front type SYMM/LDL on an
        # HPD matrix)
        self.spd = spd
        self.A: Optional[SparseMatrix] = None
        self.symb: Optional[SymbolicFactorization] = None
        self.numeric: Optional[LDLFactorization] = None
        self.hermitian = False
        self._reg: Optional[np.ndarray] = None
        self._dtype = default_real_dtype()
        self._factor_jit = None
        self._solve_jit = {}

    # -- lifecycle ----------------------------------------------------------
    def initialize(self, A: SparseMatrix, hermitian: bool = False,
                   perm: Optional[np.ndarray] = None, relax: int = 8,
                   cutoff: int = 64,
                   size_bucket: float = 0.0) -> "SparseLDLFactorization":
        """Ordering + symbolic analysis (reference ``Initialize`` →
        ``NestedDissection`` + ``Analysis``).  ``size_bucket``: see
        :func:`..sparse_direct.symbolic.analyze` — essential at scale
        (pool memory), off by default (more level plans = more compile)."""
        self.A = A
        self.hermitian = hermitian
        # working dtype from core/policy.py: f64 under x64, else f32 — no
        # silent x64-truncation warnings downstream
        if np.iscomplexobj(A.vals):
            self._dtype = jnp.complex128 if x64_enabled() else jnp.complex64
        else:
            self._dtype = default_real_dtype()
        if perm is None:
            from .ordering import nested_dissection
            perm = nested_dissection(A, cutoff=cutoff)
        # .device(): plan index arrays become device arrays passed to the
        # jitted factor/solve as ARGUMENTS (see core/statics.py)
        self.symb = analyze(A, perm=perm, relax=relax,
                            size_bucket=size_bucket).device()
        self._factor_jit = None
        self._solve_jit = {}
        return self

    @property
    def initialized(self) -> bool:
        return self.symb is not None

    @property
    def factored(self) -> bool:
        return self.numeric is not None

    def factor(self, reg: Optional[np.ndarray] = None
               ) -> "SparseLDLFactorization":
        """Numeric factorization (reference ``Factor``; ``reg`` enables the
        RegularizedLDL path: A + diag(reg) is factored, solves against A use
        iterative refinement)."""
        assert self.symb is not None, "call initialize() first"
        self._reg = reg
        # one jitted program for the whole level loop: the tree walk's many
        # small ops otherwise dispatch one by one
        import jax
        if self._factor_jit is None:
            conj, dt = self.hermitian, self._dtype
            use_reg = reg is not None

            mesh, taxis, spd = self.mesh, self.tree_axis, self.spd
            import os
            # opt-in: fronts of at least this size are panel-factored
            # across the whole mesh (dist_front.py) when a mesh is given;
            # 0 (the default) keeps every front on the batched path
            dfm = int(os.environ.get("ELEMENTAL_DIST_FRONT_MIN", "0"))

            def _do(symb, vals, regv):
                num = factor(symb, vals, conjugate=conj,
                             reg=regv if use_reg else None, dtype=dt,
                             mesh=mesh, tree_axis=taxis, spd=spd,
                             dist_front_min=dfm)
                return num.pool, num.d

            self._factor_jit = jax.jit(_do)
        rdt = jnp.zeros((), self._dtype).real.dtype
        regv = jnp.asarray(np.zeros(self.symb.n) if reg is None else reg, rdt)
        pool, d = self._factor_jit(self.symb,
                                   jnp.asarray(self.A.vals, self._dtype),
                                   regv)
        self.numeric = LDLFactorization(self.symb, pool, d, self.hermitian)
        return self

    def _run_factor(self, vals, regv):
        """(pool, d) from the compiled factor program — the bench/dryrun
        timing entry."""
        return self._factor_jit(self.symb, vals, regv)

    def change_nonzero_values(self, new_vals) -> "SparseLDLFactorization":
        """Same structure, new values → refactor reusing the symbolic plan
        (reference ``ChangeNonzeroValues``)."""
        assert self.A is not None
        self.A = self.A.change_nonzero_values(np.asarray(new_vals))
        if self.numeric is not None:
            self.factor(self._reg)
        return self

    # -- solves ---------------------------------------------------------------
    def solve(self, b):
        assert self.numeric is not None, "call factor() first"
        import jax
        b = jnp.asarray(b)
        key = (b.shape, str(b.dtype))
        if key not in self._solve_jit:
            conj = self.hermitian

            def _do(symb, pool, d, bb):
                return LDLFactorization(symb, pool, d, conj).solve(bb)

            self._solve_jit[key] = jax.jit(_do)
        return self._solve_jit[key](self.symb, self.numeric.pool,
                                    self.numeric.d, b)

    def solve_with_iterative_refinement(self, b, iters: int = 6):
        assert self.numeric is not None
        dev = self.A.device_csr()
        apply_a = (lambda x: dev.matmat(x) if x.ndim > 1 else dev.matvec(x))
        return self.numeric.solve_with_iterative_refinement(apply_a, b,
                                                            iters)

    def multiply_with_l(self, x, adjoint: bool = False):
        assert self.numeric is not None
        return self.numeric.multiply_with_l(x, adjoint)

    def diagonal(self):
        assert self.numeric is not None
        return self.numeric.d

    def inertia(self):
        assert self.numeric is not None
        return self.numeric.inertia()

    def residual_bound(self, factor: float = 100.0) -> float:
        """Dtype-derived acceptable relative residual for solve-after-factor
        on this matrix: ``factor · eps(effective dtype) · n`` (reference
        ``Cholesky.cpp:41-44`` — thresholds are derived, not guessed
        per-site)."""
        assert self.A is not None
        return residual_bound(self._dtype, self.A.height, factor)

    def factor_nnz(self) -> int:
        assert self.symb is not None
        return self.symb.nnz_factor

    def factor_gflops(self) -> float:
        """Flop estimate of the factorization (reference
        ``LocalFactorGFlops`` accounting, ``SparseLDL.cpp:143-169``)."""
        assert self.symb is not None
        total = 0.0
        for sn in self.symb.supernodes:
            ns = sn.cols[1] - sn.cols[0]
            nr = len(sn.struct)
            s = ns + nr
            for k in range(ns):
                total += 2.0 * (s - k) ** 2
        return total / 1e9


class DistSparseLDLFactorization(SparseLDLFactorization):
    """Distributed facade (reference ``DistSparseLDLFactorization.cpp:53-268``):
    accepts a :class:`~elemental_tpu.sparse.distsparse.DistSparseMatrix` and
    runs the numeric factorization with each level's front batch sharded over
    the matrix's mesh (subtree-to-subteam mapping, ``Process.hpp:150-275``).

    The symbolic phase consumes the replicated host structure (the
    reference's dist symbolic exchanges lower structs between subteams —
    here nested dissection is a host plan reused across refactorizations);
    the numeric executor is a single SPMD program: per-level vmapped front
    kernels sharded by front, extend-add/assembly on the (replicated) flat
    pool — ``chip_smoke.py --devices 4`` times that layout against one
    device."""

    def initialize(self, A, hermitian: bool = False,
                   perm: Optional[np.ndarray] = None, relax: int = 8,
                   cutoff: int = 64,
                   size_bucket: float = 0.0) -> "DistSparseLDLFactorization":
        from ..sparse.distsparse import DistSparseMatrix
        if isinstance(A, DistSparseMatrix):
            if self.mesh is None:
                self.mesh = A.grid.mesh
                if self.tree_axis is None:
                    self.tree_axis = tuple(A.grid.mesh.axis_names)
            assert A.host is not None, (
                "DistSparseMatrix built without host structure: the "
                "symbolic phase needs the replicated pattern")
            A = A.host
        return super().initialize(A, hermitian=hermitian, perm=perm,
                                  relax=relax, cutoff=cutoff,
                                  size_bucket=size_bucket)
