"""Redistribution primitives (layer L4 of the reference).

The reference implements 24 named redistribution kernels under
``include/El/blas_like/level1/Copy/`` (Translate, AllGather, ColFilter,
RowFilter, ColAllToAllPromote, Contract, AxpyContract, ...), dispatched per
distribution pair from ``DistMatrix::operator=``
(``src/core/DistMatrix/ElementMatrix/MC_MR.cpp:30-165``).

Design: a sharded ``jax.Array`` re-laid-out via
``with_sharding_constraint`` lets XLA's SPMD partitioner emit exactly the
collective each pair needs (all-gather for →STAR, dynamic-slice for filter,
all-to-all for VC↔MC promotions, collective-permute for [MC,MR]↔[MR,MC]).  The
named functions below keep the reference vocabulary for parity and for the
places (SUMMA, sparse solvers) where we want the collective *explicitly* inside
``shard_map`` so it can be pipelined with compute.

``Contract``/``AxpyContract`` are the one semantic addition: they *sum* partial
contributions that live in an explicit leading "partial" axis (a sharded
jax.Array cannot represent ranks holding different values for the same logical
element, so partial-sum states are materialised as an extra axis and reduced
here, matching ``AxpyContract.hpp:75-522``'s reduce-scatter).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .dist import Dist, partition_spec
from .distmatrix import DistMatrix, _constrain
from .grid import Grid


def translate(A: DistMatrix, coldist: Dist, rowdist: Dist) -> DistMatrix:
    """Same-distribution alignment/root change, or any pairwise redistribution
    (reference ``copy::Translate``, generalised)."""
    return A.redistribute(coldist, rowdist)


def all_gather(A: DistMatrix) -> jnp.ndarray:
    """→ fully replicated (reference ``copy::AllGather``: [U,V]→[*,*])."""
    return A.replicate()


def col_filter(A: DistMatrix, coldist: Dist) -> DistMatrix:
    """Subsample rows into a col distribution (reference ``copy::ColFilter``,
    e.g. [*,MR]→[MC,MR]); local slicing, no communication."""
    return A.redistribute(coldist, A.rowdist)


def row_filter(A: DistMatrix, rowdist: Dist) -> DistMatrix:
    return A.redistribute(A.coldist, rowdist)


def transpose_dist(A: DistMatrix) -> DistMatrix:
    """[MC,MR] → [MR,MC] on the same data (reference ``copy::TransposeDist``)."""
    return A.redistribute(A.rowdist, A.coldist)


def contract(partial: jnp.ndarray, grid: Grid, coldist: Dist, rowdist: Dist,
             axis: int = 0) -> DistMatrix:
    """Sum partial contributions stacked along ``axis`` and lay the result out
    as [coldist,rowdist] (reference ``Contract.hpp:75-101``)."""
    data = jnp.sum(partial, axis=axis)
    sh = NamedSharding(grid.mesh, partition_spec(coldist, rowdist))
    return DistMatrix(_constrain(data, sh), coldist, rowdist, grid)


def axpy_contract(alpha, partial: jnp.ndarray, C: DistMatrix,
                  axis: int = 0) -> DistMatrix:
    """C += α·Σ_partial (reference ``AxpyContract.hpp``: the SUMMA reduction
    step, an ``mpi::ReduceScatter`` over the partial-union comm)."""
    data = C.data + alpha * jnp.sum(partial, axis=axis)
    return C.like(_constrain(data, C.grid.sharding(C.coldist, C.rowdist)))


def translate_between_grids(A: DistMatrix, grid: Grid,
                            coldist: Optional[Dist] = None,
                            rowdist: Optional[Dist] = None) -> DistMatrix:
    """Copy a matrix onto a *different* grid (reference
    ``TranslateBetweenGrids.hpp:21-417``, used by multi-grid ensembles and
    tested by ``tests/core/DifferentGrids.cpp``).  XLA resharding across meshes
    is a device_put (host-mediated when the meshes are disjoint)."""
    coldist = coldist if coldist is not None else A.coldist
    rowdist = rowdist if rowdist is not None else A.rowdist
    sh = NamedSharding(grid.mesh, partition_spec(coldist, rowdist))
    return DistMatrix(jax.device_put(A.data, sh), coldist, rowdist, grid)
