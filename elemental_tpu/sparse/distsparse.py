"""Distributed sparse containers (reference tier-3 MISSING: ``DistSparseMatrix``,
``DistMultiVec``, ``DistGraph`` — spec from 44 calling files, e.g.
``tests/lapack_like/SparseLDL.cpp:50-210``, ``examples/interface/BP.py``).

Design: 1D row-block partition over the *flattened* mesh axis
('mc','mr') — the analog of the reference's [VC,*] sparse distribution.

Communication is **halo-compressed** (the reference's ``SparseAllToAll``
pattern, ``Process.hpp:150-275``): at build time each shard's column
footprint is split by owner, and the SpMV exchanges ONLY the off-shard
entries actually referenced, via one padded ``all_to_all``;
the shard's own x-block is read locally.  The transpose SpMV reuses the
same plan with the exchange reversed: local partials accumulate into the
compressed halo workspace and ride the all_to_all back to the owning
shards — so ``Multiply(TRANSPOSE, DistSparseMatrix, …)`` is a first-class
distributed kernel, not a host fallback.

Local compute is the FLAT 1-D gather + sorted segment-sum form of
``sparse/csr.py``'s ``CSRDevice``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.grid import Grid
from .csr import Graph, SparseMatrix

FLAT = P(("mc", "mr"))


def _flat_sharding(grid: Grid, ndim: int = 1) -> NamedSharding:
    spec = P(("mc", "mr"), *([None] * (ndim - 1)))
    return NamedSharding(grid.mesh, spec)


@dataclasses.dataclass
class DistSparseMatrix:
    """Row-block-partitioned sparse matrix on a grid with a precomputed
    halo-exchange plan.

    Per-shard storage (leading axis p sharded over the flat mesh):
      * ``lrows``/``lcols``/``lvals`` (p, E): flat local CSR triplets, row
        ids local to the shard, column ids addressing the local workspace
        ``w = [own x-block (cs) | halo (p·H)]``; padded entries carry
        value 0.
      * ``send_idx`` (p, p, H): ``send_idx[j, i, t]`` = index into shard
        j's x-block of the t-th entry shard i needs from j (the plan of
        the padded all_to_all; H = max off-shard footprint block).
    """

    height: int
    width: int
    grid: Grid
    lrows: jnp.ndarray      # (p, E) int32
    lcols: jnp.ndarray      # (p, E) int32 — workspace-local
    lvals: jnp.ndarray      # (p, E)
    send_idx: jnp.ndarray   # (p, p, H) int32
    cs: int                 # x-block size per shard (width partition)
    rs: int                 # rows per shard
    halo: int               # H
    nnz: int
    val_slot: np.ndarray    # host: padded slot of each original CSR value
    host: Optional[SparseMatrix] = None  # host CSR (symbolic reuse, IO)

    # -- construction --------------------------------------------------------
    @classmethod
    def from_sparse(cls, A: SparseMatrix, grid: Optional[Grid] = None
                    ) -> "DistSparseMatrix":
        if grid is None:
            grid = Grid.default()
        p = grid.size
        rs = -(-A.height // p)
        cs = -(-A.width // p)
        rows = np.repeat(np.arange(A.height), A.row_nnz())
        cols = np.asarray(A.colind)
        shard = (rows // rs).astype(np.int64)
        owner = (cols // cs).astype(np.int64)

        # footprints: for each (reader i, owner j≠i) the sorted unique
        # off-shard columns; H = max block (padded all_to_all width)
        off = shard != owner
        fkey = shard[off] * (p * A.width) + owner[off] * A.width + cols[off]
        funiq = np.unique(fkey)
        f_i = funiq // (p * A.width)
        f_j = (funiq // A.width) % p
        f_c = funiq % A.width
        counts = np.zeros((p, p), np.int64)
        np.add.at(counts, (f_i, f_j), 1)
        H = max(1, int(counts.max()) if counts.size else 1)
        send_idx = np.zeros((p, p, H), np.int32)
        # position of each footprint entry within its (i,j) block
        blk_key = f_i * p + f_j
        blk_start = np.searchsorted(blk_key, np.arange(p * p))
        pos_in_blk = np.arange(funiq.size) - blk_start[blk_key]
        send_idx[f_j, f_i, pos_in_blk] = (f_c - f_j * cs).astype(np.int32)

        # localized column index per entry
        lcol = np.where(off, 0, cols - owner * cs).astype(np.int64)
        if off.any():
            pos = np.searchsorted(funiq, fkey)
            lcol[off] = cs + f_j[pos] * H + pos_in_blk[pos]

        # pack per-shard flat triplets, padded to common E
        per = np.zeros(p, np.int64)
        np.add.at(per, shard, 1)
        E = max(1, int(per.max()))
        # padding slots carry row id rs: out-of-range ids are DROPPED by
        # segment_sum and keep each shard's row array sorted (the
        # indices_are_sorted contract below; trailing zeros would violate it)
        lrows = np.full((p, E), rs, np.int32)
        lcolsa = np.zeros((p, E), np.int32)
        lvalsa = np.zeros((p, E), A.vals.dtype)
        # entries are in CSR order → within each shard already row-sorted
        starts = np.concatenate([[0], np.cumsum(per)])
        slot_of = np.arange(rows.size) - starts[shard]
        lrows[shard, slot_of] = (rows - shard * rs).astype(np.int32)
        lcolsa[shard, slot_of] = lcol.astype(np.int32)
        lvalsa[shard, slot_of] = A.vals
        val_slot = shard * E + slot_of      # original CSR entry → padded slot

        sh3 = NamedSharding(grid.mesh, P(("mc", "mr"), None, None))
        sh2 = NamedSharding(grid.mesh, P(("mc", "mr"), None))
        return cls(A.height, A.width, grid,
                   jax.device_put(lrows, sh2),
                   jax.device_put(lcolsa, sh2),
                   jax.device_put(lvalsa, sh2),
                   jax.device_put(send_idx, sh3),
                   cs, rs, H, A.nnz, val_slot, host=A)

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.height, self.width)

    @property
    def rows_per_shard(self) -> int:
        return self.rs

    def change_nonzero_values(self, new_host_vals) -> "DistSparseMatrix":
        """Reference ``ChangeNonzeroValues``: same structure/plan, new
        numbers — only the padded value array is re-shipped."""
        v = np.asarray(new_host_vals)
        p, E = self.lvals.shape
        flat = np.zeros(p * E, v.dtype)
        flat[self.val_slot] = v
        sh2 = NamedSharding(self.grid.mesh, P(("mc", "mr"), None))
        newA = (self.host.change_nonzero_values(v)
                if self.host is not None else None)
        return dataclasses.replace(
            self, lvals=jax.device_put(flat.reshape(p, E), sh2), host=newA)

    # -- distributed kernels ------------------------------------------------
    def _axis(self):
        return ("mc", "mr")

    def _xblocks(self, x: jnp.ndarray, size: int) -> jnp.ndarray:
        """Pad a global vector/matrix to p·size and shard its rows."""
        p = self.grid.size
        pad = p * size - x.shape[0]
        if pad > 0:
            x = jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
        return jax.lax.with_sharding_constraint(
            x, _flat_sharding(self.grid, x.ndim))

    def matvec(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = A·x — halo all_to_all + flat local gather/segment-sum."""
        return self._apply(x, transpose=False)

    def matvec_transpose(self, x: jnp.ndarray) -> jnp.ndarray:
        """y = Aᵀ·x — local partials into the compressed workspace, then
        the REVERSED halo exchange scatters them to the owning shards."""
        return self._apply(x, transpose=True)

    def matmat(self, X: jnp.ndarray) -> jnp.ndarray:
        return self._apply(X, transpose=False)

    def matmat_transpose(self, X: jnp.ndarray) -> jnp.ndarray:
        return self._apply(X, transpose=True)

    def _apply(self, x: jnp.ndarray, transpose: bool) -> jnp.ndarray:
        grid = self.grid
        p = grid.size
        rs, cs, H = self.rs, self.cs, self.halo
        axis = self._axis()
        x = jnp.asarray(x)
        squeeze = x.ndim == 1
        if squeeze:
            x = x[:, None]
        k = x.shape[1]
        nseg = cs + p * H

        if not transpose:
            xg = self._xblocks(x, cs)

            def local(lrows, lcols, lvals, sidx, xb):
                xb = xb.reshape(cs, k)
                send = xb[sidx[0].reshape(-1)].reshape(p, H * k)
                recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=False)
                w = jnp.concatenate([xb, recv.reshape(p * H, k)], axis=0)
                prod = lvals[0][:, None] * w[lcols[0]]
                y = jax.ops.segment_sum(prod, lrows[0], num_segments=rs,
                                        indices_are_sorted=True)
                return y

            fn = shard_map(local, mesh=grid.mesh,
                           in_specs=(FLAT, FLAT, FLAT, FLAT, FLAT),
                           out_specs=FLAT)
            y = fn(self.lrows, self.lcols, self.lvals, self.send_idx, xg)
            y = y[:self.height]
        else:
            xg = self._xblocks(x, rs)

            def local_t(lrows, lcols, lvals, sidx, xb):
                xb = xb.reshape(rs, k)
                prod = lvals[0][:, None] * xb[lrows[0]]
                w = jax.ops.segment_sum(prod, lcols[0], num_segments=nseg)
                send = w[cs:].reshape(p, H * k)
                recv = jax.lax.all_to_all(send, axis, 0, 0, tiled=False)
                y = w[:cs].at[sidx[0].reshape(-1)].add(
                    recv.reshape(p * H, k))
                return y

            fn = shard_map(local_t, mesh=grid.mesh,
                           in_specs=(FLAT, FLAT, FLAT, FLAT, FLAT),
                           out_specs=FLAT)
            y = fn(self.lrows, self.lcols, self.lvals, self.send_idx, xg)
            y = y[:self.width]
        return y[:, 0] if squeeze else y


# pytree: the shard/halo-plan arrays pass through jit as ARGUMENTS (closing
# over them embeds jaxpr constants; see core/statics.py).  Grid/sizes/host CSR ride the identity aux.
from ..core.statics import register_plan_pytree  # noqa: E402

register_plan_pytree(DistSparseMatrix, ("lrows", "lcols", "lvals",
                                        "send_idx"))


@dataclasses.dataclass
class DistMultiVec:
    """Row-partitioned dense multivector (reference ``DistMultiVec`` — the
    [VC,*] RHS container of the sparse solvers)."""

    data: jnp.ndarray
    grid: Grid

    @classmethod
    def from_array(cls, x, grid: Optional[Grid] = None) -> "DistMultiVec":
        if grid is None:
            grid = Grid.default()
        x = jnp.asarray(x)
        ndim = x.ndim
        if x.shape[0] % grid.size == 0:
            spec = P(("mc", "mr"), *([None] * (ndim - 1)))
        else:
            import warnings
            warnings.warn(
                f"DistMultiVec height {x.shape[0]} is not divisible by the "
                f"{grid.size}-device mesh; storing REPLICATED. Pad the "
                "height to keep the [VC,*] row partition.",
                RuntimeWarning, stacklevel=2)
            spec = P(*([None] * ndim))
        return cls(jax.device_put(x, NamedSharding(grid.mesh, spec)), grid)

    @property
    def height(self) -> int:
        return self.data.shape[0]

    @property
    def width(self) -> int:
        return self.data.shape[1] if self.data.ndim > 1 else 1

    def to_numpy(self) -> np.ndarray:
        return np.asarray(self.data)


class DistGraph(Graph):
    """Distributed graph: pattern shared on host (symbolic layers are
    host-side), partition metadata from the grid."""

    def __init__(self, num_sources, num_targets, rowptr, colind,
                 grid: Optional[Grid] = None):
        super().__init__(num_sources, num_targets, rowptr, colind)
        self.grid = grid if grid is not None else Grid.default()

    @classmethod
    def from_graph(cls, g: Graph, grid: Optional[Grid] = None) -> "DistGraph":
        return cls(g.num_sources, g.num_targets, g.rowptr, g.colind, grid)


@dataclasses.dataclass
class DistMap:
    """1D-distributed index map (reference ``DistMap``,
    ``include/El/core/DistMap/decl.hpp:28-40`` — reordering permutations for
    the sparse solvers); ``translate`` is the batched lookup
    (``DistMap::Translate(localInds)``).

    The map itself can live sharded over a grid's flat axis
    (:meth:`device`); ``translate_device`` then performs the distributed
    batch lookup as one jittable gather — the reference's
    owner-rank-exchange Translate maps to XLA's sharded gather (the
    collective plan is the compiler's)."""

    map_: np.ndarray
    _device_map = None          # sharded jax.Array cache (not a pytree leaf)

    def translate(self, indices) -> np.ndarray:
        return self.map_[np.asarray(indices)]

    def device(self, grid=None) -> "DistMap":
        """Shard the map over the grid's flat mesh axis (reference 1D
        STAR,VC distribution of the map entries)."""
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P
        from ..core.grid import Grid
        g = grid or Grid.default()
        n = self.map_.shape[0]
        p = g.size
        pad = (-n) % p
        mp = np.pad(self.map_, (0, pad))
        sh = NamedSharding(g.mesh, P(tuple(g.mesh.axis_names)))
        dm = DistMap(self.map_)
        dm._device_map = jax.device_put(mp, sh)
        return dm

    def translate_device(self, indices):
        """Distributed batched lookup: ``indices`` may be any (sharded or
        replicated) device array; returns map[indices] with XLA planning
        the cross-shard exchange (reference ``DistMap::Translate``'s
        owner-exchange, compiler-scheduled)."""
        import jax.numpy as jnp
        src = self._device_map
        if src is None:
            src = jnp.asarray(self.map_)
        return jnp.take(src, jnp.asarray(indices), axis=0)

    def inverse(self) -> "DistMap":
        inv = np.empty_like(self.map_)
        inv[self.map_] = np.arange(self.map_.shape[0])
        return DistMap(inv)

    def __len__(self) -> int:
        return int(self.map_.shape[0])
