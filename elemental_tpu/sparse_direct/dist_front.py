"""Distributed dense-front factorization (reference L2D fronts:
``numeric.hpp:29-38`` front types, ``ProcessFront.hpp:29-60`` blocked
LDL + Trsm + rank-k on a per-node ``[MC,MR]`` grid).

Design: the few flop-dominant top-separator fronts are too big
for one device's share of the level batch but too few to batch-shard, and
GSPMD cannot pipeline a sharded Cholesky (90× slower on the virtual CPU
mesh).  So
this module hand-writes the panel pipeline in ``shard_map``:

* the padded front (S, S) is ROW-BLOCK sharded over the whole mesh
  (1D analog of the reference's [MC,MR] front — on an all-to-all
  interconnect the all-gather of one S×nb panel per step is the only collective);
* per panel: every device all-gathers the panel columns, REDUNDANTLY
  eliminates the ≤nb pivots inside them (rank-1 updates on S×nb —
  replicated work, O(S·nb²) ≪ the trailing update), then applies the
  trailing rank-nb update to ITS OWN row block as one matmul;
* the masked-elimination semantics (``ns``-column partial factorization,
  signed pivot floors) are identical to the single-device kernels in
  ``numeric.py``, so the pool format and the extend-add are unchanged.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from .numeric import _clamp_pivot


def _flat_index(axes):
    idx = jax.lax.axis_index(axes[0])
    for a in axes[1:]:
        idx = idx * jax.lax.axis_size(a) + jax.lax.axis_index(a)
    return idx


def dist_partial_ldl(F: jnp.ndarray, ns, mesh, nb: int = 128,
                     conjugate: bool = False,
                     pf: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """Right-looking panel LDL of ONE padded front, row-block sharded over
    every device of ``mesh``.  Eliminates the first ``ns`` columns (traced
    scalar), leaving unit-L/D in the panel and the Schur complement in the
    trailing block — same layout as ``_masked_partial_ldl``.

    ``pf``: optional (S,) signed pivot floors (see ``_clamp_pivot``)."""
    axes = tuple(mesh.axis_names)
    ndev = int(np.prod([mesh.shape[a] for a in axes]))
    S = F.shape[0]
    # rows split evenly into 8-aligned blocks; panels tile the padded size
    L = int(np.lcm(nb, 8 * ndev))
    Sp = -(-S // L) * L
    if Sp != S:
        F = jnp.pad(F, ((0, Sp - S), (0, Sp - S)))
    pfp = None
    if pf is not None:
        pfp = jnp.pad(pf, (0, Sp - S)) if Sp != S else pf
    rows_loc = Sp // ndev
    npan = Sp // nb
    rows = jnp.arange(Sp)
    tpan = jnp.arange(nb)

    def kern(Fl, ns, pfl):
        # Fl: (rows_loc, Sp) local row block
        z = jnp.int32(0)
        r0 = (_flat_index(axes) * rows_loc).astype(jnp.int32)

        def panel_body(p, Fl):
            j0 = (p * nb).astype(jnp.int32)
            Pl = jax.lax.dynamic_slice(Fl, (z, j0), (rows_loc, nb))
            Pp = jax.lax.all_gather(Pl, axes, tiled=True)     # (Sp, nb)

            def elim(kk, Pp):
                k = j0 + kk
                ok = k < ns
                dk = Pp[k, kk]
                if pfl is not None:
                    dk = jnp.where(ok, _clamp_pivot(dk, pfl[k]), dk)
                safe = jnp.where(dk == 0, jnp.ones((), Pp.dtype), dk)
                col = jnp.where((rows > k) & ok, Pp[:, kk] / safe, 0.0)
                colp = jax.lax.dynamic_slice(col, (j0,), (nb,))
                rowv = jnp.where(tpan > kk, colp, 0.0)
                rowv = jnp.conj(rowv) if conjugate else rowv
                Pp = Pp - jnp.outer(col, rowv) * dk
                Pp = Pp.at[:, kk].set(jnp.where((rows > k) & ok, col,
                                                Pp[:, kk]))
                Pp = Pp.at[k, kk].set(dk)
                return Pp

            Pp = jax.lax.fori_loop(0, nb, elim, Pp)
            # trailing rank-nb update of the LOCAL row block (matmul);
            # precision pinned — see numeric._factor_impl
            prow = j0 + tpan
            d = Pp[prow, tpan]
            Lp = jnp.where((rows[:, None] > prow[None, :])
                           & (prow[None, :] < ns), Pp, 0.0)
            Ll = jax.lax.dynamic_slice(Lp, (r0, z), (rows_loc, nb))
            LpT = jnp.conj(Lp).T if conjugate else Lp.T
            U = jnp.matmul(Ll * d[None, :], LpT, precision="highest")
            Fl = Fl - U * (rows[None, :] >= j0 + nb)
            # write the factored panel back into the local rows
            Pl_new = jax.lax.dynamic_slice(Pp, (r0, z), (rows_loc, nb))
            return jax.lax.dynamic_update_slice(Fl, Pl_new, (z, j0))

        return jax.lax.fori_loop(0, npan, panel_body, Fl)

    specs = (P(axes, None), P(), P() if pfp is not None else None)
    in_specs = (specs[0], specs[1]) + ((specs[2],) if pfp is not None
                                       else ())
    fn = shard_map(
        (lambda Fl, ns, pfl: kern(Fl, ns, pfl)) if pfp is not None
        else (lambda Fl, ns: kern(Fl, ns, None)),
        mesh=mesh,
        in_specs=in_specs,
        out_specs=P(axes, None),
        check_rep=False)
    args = (F, jnp.asarray(ns)) + ((pfp,) if pfp is not None else ())
    out = fn(*args)
    return out[:S, :S] if Sp != S else out


def dist_partial_spd(F: jnp.ndarray, ns, mesh, nb: int = 128,
                     conjugate: bool = False) -> jnp.ndarray:
    """SPD wrapper: the LDL elimination on an HPD front yields the same
    pool layout the SPD fast path produces (unit-L panel, D = d on the
    diagonal, Schur trailing block)."""
    return dist_partial_ldl(F, ns, mesh, nb=nb, conjugate=conjugate)
