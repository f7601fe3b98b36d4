"""Distribution calculus: the XLA re-expression of Elemental's ``Dist`` algebra.

The reference encodes thirteen 2D matrix distributions as pairs drawn from
``Dist {MC, MD, MR, VC, VR, STAR, CIRC}`` (reference ``include/El/core/types.hpp:208-217``)
and derives, via a small algebra (``types.hpp:240-330``), which distribution a
diagonal / partial-reduction / gathered variant lives in.  Here the same role is
played by a *sharding-spec calculus*: each (colDist, rowDist) pair maps to a
``jax.sharding.PartitionSpec`` over a 2D device mesh with axes ``('mc', 'mr')``.

Design notes (XLA-first, not a port):
  * JAX/GSPMD shardings are *blocked*, not element-cyclic.  Element-cyclic layouts
    exist in the reference purely for load balance of panel algorithms; here the
    panel algorithms themselves are re-designed (recursive blocked formulations,
    masked scans) so blocked sharding is the right native layout.  The BLOCK wrap
    (``DistWrap`` in ``types.hpp:228``) therefore collapses onto the same specs.
  * ``VC``/``VR`` (1D vector-cyclic over all p processes) become shardings over the
    *flattened* mesh: ``('mc','mr')`` resp. ``('mr','mc')`` as a tuple axis.
  * ``MD`` (diagonal distribution) has no blocked analogue; it is used only for
    diagonals, which we represent as 1D arrays sharded over the flat mesh.
  * ``CIRC`` (single root) is represented as a replicated sharding carrying a
    ``root``; collectives to/from a root are XLA broadcasts/gathers.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

from jax.sharding import PartitionSpec as P


class Dist(enum.Enum):
    """Mirror of the reference's ``Dist`` enum (``types.hpp:208-217``)."""

    MC = "MC"      # column of a 2D process grid
    MD = "MD"      # diagonal of a 2D process grid
    MR = "MR"      # row of a 2D process grid
    VC = "VC"      # full grid, column-major order
    VR = "VR"      # full grid, row-major order
    STAR = "STAR"  # replicated
    CIRC = "CIRC"  # stored on a single root process


MC = Dist.MC
MD = Dist.MD
MR = Dist.MR
VC = Dist.VC
VR = Dist.VR
STAR = Dist.STAR
CIRC = Dist.CIRC

#: All distribution pairs the reference instantiates
#: (``src/core/DistMatrix/ElementMatrix/*.cpp``, 13 files).
DIST_PAIRS: Tuple[Tuple[Dist, Dist], ...] = (
    (CIRC, CIRC),
    (MC, MR),
    (MC, STAR),
    (MD, STAR),
    (MR, MC),
    (MR, STAR),
    (STAR, MC),
    (STAR, MD),
    (STAR, MR),
    (STAR, STAR),
    (STAR, VC),
    (STAR, VR),
    (VC, STAR),
    (VR, STAR),
)


def _axis_of(d: Dist, transposed: bool = False) -> Optional[object]:
    """Mesh axis (or axis tuple) that a single Dist shards over."""
    if d is Dist.MC:
        return "mc"
    if d is Dist.MR:
        return "mr"
    if d in (Dist.VC, Dist.MD):
        return ("mc", "mr")
    if d is Dist.VR:
        return ("mr", "mc")
    # STAR and CIRC: replicated over the mesh (CIRC carries root metadata).
    return None


def partition_spec(coldist: Dist, rowdist: Dist) -> P:
    """PartitionSpec for a matrix with rows distributed as ``coldist`` and
    columns as ``rowdist`` (Elemental's [U,V] convention: A[MC,MR] shards rows
    over MC and columns over MR)."""
    return P(_axis_of(coldist), _axis_of(rowdist))


def vector_spec(dist: Dist) -> P:
    """PartitionSpec for a 1D array distributed as ``dist``."""
    return P(_axis_of(dist))


# ---------------------------------------------------------------------------
# Distribution algebra — mirrors ``types.hpp:240-330``.
# ---------------------------------------------------------------------------

def diag_col(coldist: Dist, rowdist: Dist) -> Dist:
    """Distribution of a diagonal extracted from an [coldist,rowdist] matrix
    (reference ``DiagCol``, ``types.hpp:240``)."""
    pair = (coldist, rowdist)
    if pair == (MC, MR) or pair == (MR, MC):
        return MD
    if coldist is STAR and rowdist is STAR:
        return STAR
    if coldist is CIRC:
        return CIRC
    return VC


def gathered_dist(d: Dist) -> Dist:
    """Collect a distribution onto every process (reference ``Collect``)."""
    return STAR if d is not CIRC else CIRC


def partial_dist(d: Dist) -> Dist:
    """Partial (pre-reduction) distribution (reference ``Partial``): the dist a
    sum-contribution lives in before ``Contract`` reduce-scatters it."""
    if d is VC:
        return MC
    if d is VR:
        return MR
    return d


def partial_union_dist(u: Dist, v: Dist) -> Dist:
    """Reference ``PartialUnionRow/Col`` helper: the axis over which a partial
    distribution must be reduced."""
    if u is VC and v is STAR:
        return MR
    if u is VR and v is STAR:
        return MC
    return STAR


def is_replicated(coldist: Dist, rowdist: Dist) -> bool:
    return coldist in (STAR, CIRC) and rowdist in (STAR, CIRC)


def transpose_pair(coldist: Dist, rowdist: Dist) -> Tuple[Dist, Dist]:
    """Distribution of the transpose living on the same mesh:
    [MC,MR]ᵀ → [MR,MC] etc."""
    return (rowdist, coldist)
