"""Sparse multiply kernels (reference MISSING tier: ``Multiply(NORMAL, α, A,
X, β, Y)`` spec'd by ``tests/blas_like/Multiply.cpp:19-46``; SpGEMM spec'd by
the IPM's Galerkin A·D·Aᵀ).

Design split:
  * SpMV/SpMM numeric — device (ELL gather-dot, CSR segment-sum, or DIA
    for banded matrices via :func:`elemental_tpu.sparse.plan_spmv`).
  * SpGEMM symbolic — host NumPy merge (irregular, one-time); numeric — a
    device *plan* of (a_idx, b_idx → c_idx) triples executed as one
    segment-sum, so fixed-structure products (every IPM iteration) run fully
    on-device.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

import jax
import jax.numpy as jnp

from .csr import CSRDevice, ELLMatrix, Graph, SparseMatrix
from .distsparse import DistMultiVec, DistSparseMatrix


def multiply(orientation: str, alpha, A, X, beta=0.0, Y=None):
    """Y := α·op(A)·X + β·Y for sparse A (reference ``Multiply`` signature,
    ``tests/blas_like/Multiply.cpp:19-46``).  Accepts SparseMatrix / Graph /
    ELLMatrix / DistSparseMatrix with dense X."""
    if isinstance(A, Graph):
        A = A.to_sparse()
    o = orientation.upper()[0]
    if isinstance(A, SparseMatrix):
        if o == "T":
            A = A.transpose()
        elif o in ("C", "A"):
            A = A.transpose().conj()
        dev = A.device_csr()   # flat 1-D gather form (see csr.py)
        xv = X.data if isinstance(X, DistMultiVec) else jnp.asarray(X)
        prod = dev.matvec(xv) if xv.ndim == 1 else dev.matmat(xv)
    elif isinstance(A, DistSparseMatrix):
        xv = X.data if isinstance(X, DistMultiVec) else jnp.asarray(X)
        if o == "N":
            prod = A.matvec(xv) if xv.ndim == 1 else A.matmat(xv)
        else:
            # distributed transpose: the reversed halo exchange
            # (reference Multiply(TRANSPOSE, DistSparseMatrix, ...))
            if o in ("C", "A"):
                if A.host is None:
                    raise ValueError(
                        "adjoint DistSparse multiply requires the host CSR "
                        "(matrix was built/updated host-stripped)")
                A = A.change_nonzero_values(np.conj(A.host.vals))
            prod = (A.matvec_transpose(xv) if xv.ndim == 1
                    else A.matmat_transpose(xv))
    elif isinstance(A, (ELLMatrix, CSRDevice)):
        xv = jnp.asarray(X)
        prod = A.matvec(xv) if xv.ndim == 1 else A.matmat(xv)
    else:
        raise TypeError(f"unsupported sparse type {type(A)}")
    out = alpha * prod
    if Y is not None:
        yv = Y.data if isinstance(Y, DistMultiVec) else jnp.asarray(Y)
        out = out + beta * yv
    return out


# --------------------------------------------------------------------------
# SpGEMM
# --------------------------------------------------------------------------

@dataclasses.dataclass
class SpGEMMPlan:
    """Device plan for a fixed-structure product C = A·B: one fused
    gather-multiply-segment-sum."""

    c_struct: SparseMatrix      # structure of C (vals are from plan build)
    a_idx: jnp.ndarray          # (nmul,) indices into A.vals
    b_idx: jnp.ndarray          # (nmul,) indices into B.vals
    c_idx: jnp.ndarray          # (nmul,) indices into C.vals
    c_nnz: int

    def numeric(self, a_vals: jnp.ndarray, b_vals: jnp.ndarray) -> jnp.ndarray:
        prod = a_vals[self.a_idx] * b_vals[self.b_idx]
        return jax.ops.segment_sum(prod, self.c_idx,
                                   num_segments=self.c_nnz)


def spgemm_plan(A: SparseMatrix, B: SparseMatrix) -> SpGEMMPlan:
    """Symbolic SpGEMM (host): enumerate every scalar multiplication
    a_ik·b_kj and its destination c_ij, dedup destinations."""
    assert A.width == B.height
    a_rows = np.repeat(np.arange(A.height), A.row_nnz())
    # expand: for each A entry (i,k) pair with every B entry in row k
    b_rownnz = np.diff(B.rowptr)
    counts = b_rownnz[A.colind]               # per-A-entry multiplications
    nmul = int(counts.sum())
    a_idx = np.repeat(np.arange(A.nnz), counts)
    # b positions: for A-entry t with k=A.colind[t], positions B.rowptr[k] + 0..counts[t]-1
    starts = B.rowptr[A.colind]
    offsets = np.arange(nmul) - np.repeat(np.cumsum(counts) - counts, counts)
    b_idx = np.repeat(starts, counts) + offsets
    ci = a_rows[a_idx]
    cj = B.colind[b_idx]
    key = ci * B.width + cj
    uniq, inv = np.unique(key, return_inverse=True)
    c_rows = (uniq // B.width).astype(np.int64)
    c_cols = (uniq % B.width).astype(np.int64)
    c_struct = SparseMatrix.from_coo(A.height, B.width, c_rows, c_cols,
                                     np.zeros(uniq.shape[0], A.vals.dtype),
                                     sum_duplicates=False)
    # from_coo sorted (rows, cols) — uniq keys are already in that order
    return SpGEMMPlan(c_struct, jnp.asarray(a_idx), jnp.asarray(b_idx),
                      jnp.asarray(inv), int(uniq.shape[0]))


def spgemm(A: SparseMatrix, B: SparseMatrix) -> SparseMatrix:
    """C = A·B (host symbolic + device numeric)."""
    plan = spgemm_plan(A, B)
    c_vals = plan.numeric(jnp.asarray(A.vals), jnp.asarray(B.vals))
    return plan.c_struct.change_nonzero_values(np.asarray(c_vals))


@dataclasses.dataclass
class GalerkinPlan:
    """Fixed-structure A·diag(d)·Aᵀ (the IPM normal-equations product,
    the Galerkin A·Aᵀ configuration).  Structure computed once; per-
    iteration numeric is a single fused segment-sum on device."""

    c_struct: SparseMatrix
    a_idx: jnp.ndarray       # left factor entry
    at_idx: jnp.ndarray      # right factor entry (index into A.vals)
    d_idx: jnp.ndarray       # inner (column) index → diag entry
    c_idx: jnp.ndarray
    c_nnz: int

    def numeric(self, a_vals: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
        prod = a_vals[self.a_idx] * d[self.d_idx] * a_vals[self.at_idx]
        return jax.ops.segment_sum(prod, self.c_idx,
                                   num_segments=self.c_nnz)


def galerkin_plan(A: SparseMatrix) -> GalerkinPlan:
    """Plan C = A·diag(d)·Aᵀ.  Enumerates pairs of entries sharing a column:
    for column k with entries rows r₁..r_m, contributes to every (r_i, r_j)."""
    At = A.transpose()  # CSR of Aᵀ: rows = columns of A
    # per column k: list of (row, a_val_idx)
    col_nnz = At.row_nnz()
    # entry positions of A sorted by column: via transpose bookkeeping
    # Build arrays: for column k, A entries are At entries in row k, and the
    # original A.vals index of each is recoverable by matching (row, col).
    a_rows = np.repeat(np.arange(A.height), A.row_nnz())
    order = np.lexsort((a_rows, A.colind))     # sort A entries by (col, row)
    ent_col = A.colind[order]                  # = column of entry
    ent_row = a_rows[order]
    ent_aidx = order                           # index into A.vals
    # pairs within each column
    counts = col_nnz                            # entries per column
    pair_counts = counts * counts
    npair = int(pair_counts.sum())
    col_starts = np.cumsum(counts) - counts
    # enumerate all (i, j) pairs per column
    pk = np.repeat(np.arange(A.width), pair_counts)           # column id
    base = np.repeat(np.cumsum(pair_counts) - pair_counts, pair_counts)
    local = np.arange(npair) - base
    ccount = counts[pk]
    li = local // np.maximum(ccount, 1)
    lj = local % np.maximum(ccount, 1)
    left = ent_aidx[col_starts[pk] + li]
    right = ent_aidx[col_starts[pk] + lj]
    ci = ent_row[col_starts[pk] + li]
    cj = ent_row[col_starts[pk] + lj]
    key = ci * A.height + cj
    uniq, inv = np.unique(key, return_inverse=True)
    c_rows = (uniq // A.height).astype(np.int64)
    c_cols = (uniq % A.height).astype(np.int64)
    c_struct = SparseMatrix.from_coo(A.height, A.height, c_rows, c_cols,
                                     np.zeros(uniq.shape[0], A.vals.dtype),
                                     sum_duplicates=False)
    return GalerkinPlan(c_struct, jnp.asarray(left), jnp.asarray(right),
                        jnp.asarray(pk), jnp.asarray(inv),
                        int(uniq.shape[0]))


def syrk_sparse(A: SparseMatrix, d: Optional[np.ndarray] = None
                ) -> SparseMatrix:
    """C = A·diag(d)·Aᵀ via the Galerkin plan (d defaults to ones)."""
    plan = galerkin_plan(A)
    dv = jnp.asarray(d if d is not None
                     else np.ones(A.width, A.vals.dtype))
    vals = plan.numeric(jnp.asarray(A.vals), dv)
    return plan.c_struct.change_nonzero_values(np.asarray(vals))


# --------------------------------------------------------------------------
# Distributed SpGEMM (reference ``SparseAllToAll`` row-exchange pattern,
# ``src/core/imports/mpi_collectives.hpp``)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class DistSpGEMMPlan:
    """Fixed-structure distributed product C = A·B over the flat mesh axis.

    Both operands are 1D row-partitioned (:class:`DistSparseMatrix`).  The
    symbolic phase (host, once) compresses the reference's row exchange to
    ENTRY granularity: shard i receives exactly the B values its A-columns
    touch, via one padded ``all_to_all`` (never a full-matrix gather); the
    local numeric is one gather·multiply·segment-sum in shard_map.  Re-
    running with new values (IPM Galerkin) is pure device code.
    """

    grid: object
    c_host: SparseMatrix          # global structure of C (vals = zeros)
    c_template: DistSparseMatrix  # distributed C (structure; lvals slots)
    halo: int                     # H: padded all_to_all width
    emul: int                     # padded multiplications per shard
    send_idx: jnp.ndarray         # (p, p, H) into owner's b_lvals flat
    a_idx: jnp.ndarray            # (p, Em) into local a_lvals flat
    w_idx: jnp.ndarray            # (p, Em) into [own b_lvals | halo]
    c_idx: jnp.ndarray            # (p, Em) local padded C slot (Ec ⇒ drop)
    ec: int                       # slots per shard in C's lvals

    def numeric(self, a_lvals: jnp.ndarray, b_lvals: jnp.ndarray
                ) -> jnp.ndarray:
        """Per-shard C values (p, Ec) from per-shard A/B values — jit-safe;
        pass this plan as a jit ARGUMENT (it is a pytree)."""
        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        grid = self.grid
        p = grid.size
        H, Em, Ec = self.halo, self.emul, self.ec
        FLAT = P(("mc", "mr"))

        def local(al, bl, sidx, aidx, widx, cidx):
            send = bl[0][sidx[0].reshape(-1)].reshape(p, H)
            recv = jax.lax.all_to_all(send, ("mc", "mr"), 0, 0, tiled=False)
            w = jnp.concatenate([bl[0], recv.reshape(-1)])
            prod = al[0][aidx[0]] * w[widx[0]]
            return jax.ops.segment_sum(prod, cidx[0], num_segments=Ec
                                       )[None]

        fn = shard_map(local, mesh=grid.mesh,
                       in_specs=(FLAT,) * 6, out_specs=FLAT)
        return fn(a_lvals, b_lvals, self.send_idx, self.a_idx,
                  self.w_idx, self.c_idx).reshape(p, Ec)

    def product(self, A: DistSparseMatrix, B: DistSparseMatrix
                ) -> DistSparseMatrix:
        lvals = self.numeric(A.lvals.reshape(self.grid.size, -1),
                             B.lvals.reshape(self.grid.size, -1))
        import jax as _jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh2 = NamedSharding(self.grid.mesh, P(("mc", "mr"), None))
        host = None
        if self.c_template.host is not None:
            flat = np.asarray(lvals).reshape(-1)
            host = self.c_template.host.change_nonzero_values(
                flat[self.c_template.val_slot])
        return dataclasses.replace(
            self.c_template,
            lvals=_jax.lax.with_sharding_constraint(lvals, sh2)
            if isinstance(lvals, _jax.core.Tracer)
            else _jax.device_put(lvals, sh2),
            host=host)


def dist_spgemm_plan(A: DistSparseMatrix, B: DistSparseMatrix
                     ) -> DistSpGEMMPlan:
    """Symbolic distributed SpGEMM (host, once per structure)."""
    if A.host is None or B.host is None:
        raise ValueError("dist_spgemm_plan requires host CSR structure")
    Ah, Bh = A.host, B.host
    grid = A.grid
    p = grid.size
    rs_a = A.rs

    # global multiplication enumeration (as spgemm_plan)
    a_rows = np.repeat(np.arange(Ah.height), Ah.row_nnz())
    b_rownnz = np.diff(Bh.rowptr)
    counts = b_rownnz[Ah.colind]
    nmul = int(counts.sum())
    a_ent = np.repeat(np.arange(Ah.nnz), counts)
    starts = Bh.rowptr[Ah.colind]
    offs = np.arange(nmul) - np.repeat(np.cumsum(counts) - counts, counts)
    b_ent = np.repeat(starts, counts) + offs
    ci = a_rows[a_ent]
    cj = Bh.colind[b_ent]

    # global C structure + distributed template
    key = ci * Bh.width + cj
    uniq, inv = np.unique(key, return_inverse=True)
    c_rows = (uniq // Bh.width).astype(np.int64)
    c_cols = (uniq % Bh.width).astype(np.int64)
    c_host = SparseMatrix.from_coo(Ah.height, Bh.width, c_rows, c_cols,
                                   np.zeros(uniq.shape[0], Ah.vals.dtype),
                                   sum_duplicates=False)
    c_tmpl = DistSparseMatrix.from_sparse(c_host, grid)
    ec = c_tmpl.lvals.shape[1]

    # shard each multiplication by the C row it lands in (= A's row shard)
    shard = (ci // rs_a).astype(np.int64)
    # owner of each needed B entry = B's row partition
    b_rows_of = np.repeat(np.arange(Bh.height), b_rownnz)
    owner = (b_rows_of[b_ent] // B.rs).astype(np.int64)
    eb = B.lvals.shape[1]                 # own-value block width
    # val_slot is the GLOBAL padded slot (owner·Eb + local); localize it
    b_slot = B.val_slot[b_ent] - owner * eb

    # halo footprint: unique (reader shard, owner, owner-local slot)
    off = shard != owner
    fkey = shard[off] * (p * eb) + owner[off] * eb + b_slot[off]
    funiq = np.unique(fkey)
    f_i = funiq // (p * eb)
    f_j = (funiq // eb) % p
    f_s = funiq % eb
    hcounts = np.zeros((p, p), np.int64)
    np.add.at(hcounts, (f_i, f_j), 1)
    H = max(1, int(hcounts.max()) if hcounts.size else 1)
    send_idx = np.zeros((p, p, H), np.int32)
    blk_key = f_i * p + f_j
    blk_start = np.searchsorted(blk_key, np.arange(p * p))
    pos_in_blk = np.arange(funiq.size) - blk_start[blk_key]
    send_idx[f_j, f_i, pos_in_blk] = f_s.astype(np.int32)

    # workspace index per multiplication
    widx = np.where(off, 0, b_slot).astype(np.int64)
    if off.any():
        pos = np.searchsorted(funiq, fkey)
        widx[off] = eb + f_j[pos] * H + pos_in_blk[pos]

    # pack per-shard multiplication triples, padded to Em
    per = np.zeros(p, np.int64)
    np.add.at(per, shard, 1)
    Em = max(1, int(per.max()))
    a_idx = np.zeros((p, Em), np.int32)
    w_idx = np.zeros((p, Em), np.int32)
    c_idx = np.full((p, Em), ec, np.int32)   # pad ⇒ dropped by segment_sum
    order = np.argsort(shard, kind="stable")
    sh_sorted = shard[order]
    starts_s = np.searchsorted(sh_sorted, np.arange(p))
    slot_of = np.arange(nmul) - starts_s[sh_sorted]
    ea = A.lvals.shape[1]
    a_idx[sh_sorted, slot_of] = (A.val_slot[a_ent[order]]
                                 - shard[order] * ea).astype(np.int32)
    w_idx[sh_sorted, slot_of] = widx[order].astype(np.int32)
    # C destination: shard-local padded slot of the C entry
    c_slot_local = (c_tmpl.val_slot[inv] - shard * ec)
    c_idx[sh_sorted, slot_of] = c_slot_local[order].astype(np.int32)

    import jax as _jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    sh2 = NamedSharding(grid.mesh, P(("mc", "mr"), None))
    sh3 = NamedSharding(grid.mesh, P(("mc", "mr"), None, None))
    return DistSpGEMMPlan(
        grid, c_host, c_tmpl, H, Em,
        _jax.device_put(send_idx, sh3),
        _jax.device_put(a_idx, sh2),
        _jax.device_put(w_idx, sh2),
        _jax.device_put(c_idx, sh2), ec)


def dist_spgemm(A: DistSparseMatrix, B: DistSparseMatrix
                ) -> DistSparseMatrix:
    """C = A·B, both 1D row-partitioned, entry-compressed halo exchange."""
    return dist_spgemm_plan(A, B).product(A, B)


def dist_galerkin(A: DistSparseMatrix, d=None) -> DistSparseMatrix:
    """Distributed C = A·diag(d)·Aᵀ (the IPM normal-equations product):
    d is folded into Aᵀ's row-partitioned values locally, then the fixed-
    structure distributed SpGEMM runs.  For hot loops build the plan once
    (``dist_spgemm_plan(A, At)``) and call ``numeric`` with rescaled
    values."""
    if A.host is None:
        raise ValueError("dist_galerkin requires host CSR structure")
    At_host = A.host.transpose()
    if d is not None:
        d = np.asarray(d)
        rows_t = np.repeat(np.arange(At_host.height), At_host.row_nnz())
        At_host = At_host.change_nonzero_values(At_host.vals * d[rows_t])
    At = DistSparseMatrix.from_sparse(At_host, A.grid)
    return dist_spgemm(A, At)


# pytree: the plan passes through jit as an ARGUMENT (core/statics.py)
from ..core.statics import register_plan_pytree  # noqa: E402

register_plan_pytree(SpGEMMPlan, ("a_idx", "b_idx", "c_idx"))
register_plan_pytree(GalerkinPlan, ("a_idx", "at_idx", "d_idx", "c_idx"))
register_plan_pytree(DistSpGEMMPlan, ("c_template", "send_idx", "a_idx",
                                      "w_idx", "c_idx"))
