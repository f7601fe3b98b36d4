"""3D (2.5D) GEMM (reference ``experimental/g3d/G3DGemm.cpp``: replicate over
a depth dimension of independent grids, split the contraction, all-reduce).

Design: a 3D mesh ('d','mc','mr'); A and B are depth-sharded over k, each
depth slice runs a 2D SUMMA contraction on its (mc,mr) sub-mesh, and one
``psum`` over 'd' combines — trading k/d memory per device for a single
depth-axis reduction instead of per-panel communication."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_3d_mesh(devices: Optional[Sequence] = None, depth: int = 2,
                 height: Optional[int] = None) -> Mesh:
    if devices is None:
        devices = jax.devices()
    devices = list(devices)
    n = len(devices)
    assert n % depth == 0, (n, depth)
    per = n // depth
    if height is None:
        height = int(np.sqrt(per))
        while per % height:
            height -= 1
    return Mesh(np.asarray(devices).reshape(depth, height, per // height),
                ("d", "mc", "mr"))


def gemm_3d(A: jnp.ndarray, B: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """C = A·B with the contraction dimension split over the 'd' axis."""
    m, k = A.shape
    _, n = B.shape
    d = mesh.shape["d"]
    h, w = mesh.shape["mc"], mesh.shape["mr"]
    assert k % (d * h * w) == 0 or k % d == 0, "k must split over depth"

    a_spec = P("mc", ("d", "mr"))   # k split over depth × mr
    b_spec = P(("d", "mc"), "mr")
    c_spec = P("mc", "mr")

    def local(a_blk, b_blk):
        # per-depth 2D stationary-C SUMMA over (mc, mr)
        a_row = jax.lax.all_gather(a_blk, "mr", axis=1, tiled=True)
        b_col = jax.lax.all_gather(b_blk, "mc", axis=0, tiled=True)
        part = jnp.matmul(a_row, b_col, preferred_element_type=a_blk.dtype)
        return jax.lax.psum(part, "d")   # combine depth contributions

    fn = shard_map(local, mesh=mesh, in_specs=(a_spec, b_spec),
                   out_specs=c_spec)
    A = jax.lax.with_sharding_constraint(A, NamedSharding(mesh, a_spec))
    B = jax.lax.with_sharding_constraint(B, NamedSharding(mesh, b_spec))
    return fn(A, B)
