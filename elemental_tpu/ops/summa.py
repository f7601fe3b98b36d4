"""SUMMA distributed GEMM over the ('mc','mr') mesh.

XLA re-design of the reference's SUMMA stack
(``src/blas_like/level3/Gemm.cpp:274-345``, ``Gemm/NN.hpp`` variants A/B/C/Dot
+ Cannon + multistream): here the variants map to

  * ``xla``        — ``jnp.einsum`` under sharding constraints; GSPMD inserts
                     the SUMMA communication pattern itself.
  * ``stationary_c`` — explicit ``shard_map``: all-gather A along 'mr' and B
                     along 'mc', one big local matmul.  The analog of
                     SUMMA-Dot: comm volume k·(m/h + n/w) per device.
  * ``stationary_a``/``stationary_b`` — keep the largest operand in place,
                     all-gather the smaller one and reduce-scatter the product
                     (``AxpyContract``'s reduce-scatter, ``AxpyContract.hpp:75``).
  * ``pipelined``  — ring ppermute over 'mr': one A-panel in flight per step,
                     matmul overlapped with the permute (the collective-matmul
                     pattern; replaces the reference's multistream SUMMA
                     ``Gemm/NN_Multistream.hpp`` + Aluminum nonblocking comms).

A size heuristic mirrors ``Gemm/NN.hpp:582-599``.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from ..core.grid import Grid


def _pad_to(x: jnp.ndarray, m: int, n: int) -> jnp.ndarray:
    pm, pn = m - x.shape[0], n - x.shape[1]
    if pm == 0 and pn == 0:
        return x
    return jnp.pad(x, ((0, pm), (0, pn)))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def gemm_xla(A: jnp.ndarray, B: jnp.ndarray, grid: Grid) -> jnp.ndarray:
    """GSPMD path: constrain operands/result to [MC,MR] and let XLA partition
    the contraction."""
    mesh = grid.mesh
    sh = NamedSharding(mesh, P("mc", "mr"))
    A = jax.lax.with_sharding_constraint(A, sh)
    B = jax.lax.with_sharding_constraint(B, sh)
    C = jnp.matmul(A, B, preferred_element_type=A.dtype)
    return jax.lax.with_sharding_constraint(C, sh)


def _stationary_c_local(a_blk, b_blk):
    # a_blk: (m/h, k/w) on ('mc','mr'); b_blk: (k/h, n/w)
    a_row = jax.lax.all_gather(a_blk, "mr", axis=1, tiled=True)   # (m/h, k)
    b_col = jax.lax.all_gather(b_blk, "mc", axis=0, tiled=True)   # (k, n/w)
    return jnp.matmul(a_row, b_col, preferred_element_type=a_blk.dtype)


def _stationary_a_local(a_blk, b_blk, w: int):
    """Big-A panel scheme (reference SUMMA-A role, ``Gemm/NN.hpp:108``):
    A is never gathered — its (m/h, k/w) shards ring along 'mr' one panel
    at a time while B is assembled k-wise with ONE single-axis all-gather
    (k, n/w).  Per-device peak: local A + h·local B + one A panel; the big
    operand's only movement is the ring transit of its own shard (volume
    (w−1)/w·|A|/h per device), overlapped with the matmuls; B is never
    replicated to (k, n) on every rank."""
    return _ring_over_a(a_blk, b_blk, w)


def _stationary_b_local(a_blk, b_blk, h: int):
    """Big-B panel scheme (reference SUMMA-B role, ``Gemm/NN.hpp:227``):
    B is never gathered — its (k/h, n/w) shards ring along 'mc' while A is
    assembled k-wise with ONE single-axis all-gather (m/h, k).  Symmetric
    to :func:`_stationary_a_local`; C (m/h, n/w) accumulates in place, no
    reduction collective needed."""
    a_row = jax.lax.all_gather(a_blk, "mr", axis=1, tiled=True)   # (m/h, k)
    k_h = b_blk.shape[0]
    my = jax.lax.axis_index("mc")
    perm = [(i, (i - 1) % h) for i in range(h)]   # ring along 'mc'

    def step(t, carry):
        b_cur, acc = carry
        src = (my + t) % h                         # k-block resident now
        a_slice = jax.lax.dynamic_slice_in_dim(a_row, src * k_h, k_h, 1)
        b_next = jax.lax.ppermute(b_cur, "mc", perm)
        acc = acc + jnp.matmul(a_slice, b_cur,
                               preferred_element_type=acc.dtype)
        return (b_next, acc)

    acc0 = jnp.zeros((a_blk.shape[0], b_blk.shape[1]), dtype=a_blk.dtype)
    acc0 = jax.lax.pcast(acc0, ("mc", "mr"), to="varying")
    _, acc = jax.lax.fori_loop(0, h, step, (b_blk, acc0), unroll=True)
    return acc


def _pipelined_local(a_blk, b_blk, w: int):
    """Ring collective-matmul: C_loc = Σ_t Apanel_t @ Bpanel_t with the next
    A-panel ppermuted while the current matmul runs (XLA overlaps the
    independent ops)."""
    return _ring_over_a(a_blk, b_blk, w)


def _ring_over_a(a_blk, b_blk, w: int):
    b_col = jax.lax.all_gather(b_blk, "mc", axis=0, tiled=True)   # (k, n/w)
    k_w = a_blk.shape[1]
    my = jax.lax.axis_index("mr")
    perm = [(i, (i - 1) % w) for i in range(w)]  # shift left along the ring

    def step(t, carry):
        a_cur, acc = carry
        # panel index currently resident: (my + t) mod w
        src = (my + t) % w
        b_slice = jax.lax.dynamic_slice_in_dim(b_col, src * k_w, k_w, 0)
        a_next = jax.lax.ppermute(a_cur, "mr", perm)
        acc = acc + jnp.matmul(a_cur, b_slice,
                               preferred_element_type=acc.dtype)
        return (a_next, acc)

    acc0 = jnp.zeros((a_blk.shape[0], b_col.shape[1]), dtype=a_blk.dtype)
    acc0 = jax.lax.pcast(acc0, ("mc", "mr"), to="varying")  # device-varying for scan
    _, acc = jax.lax.fori_loop(0, w, step, (a_blk, acc0), unroll=True)
    return acc


def gemm_summa(A: jnp.ndarray, B: jnp.ndarray, grid: Grid,
               alg: str = "stationary_c") -> jnp.ndarray:
    """Explicit shard_map SUMMA.  A: (m,k), B: (k,n), both laid out [MC,MR];
    returns C (m,n) as [MC,MR].  Pads to mesh-divisible shapes internally."""
    mesh = grid.mesh
    h, w = grid.height, grid.width
    m, k = A.shape
    k2, n = B.shape
    assert k == k2, (A.shape, B.shape)
    # SUMMA needs k divisible by both axes (A splits k over 'mr', B over 'mc').
    mp, kp, np_ = _round_up(m, h), _round_up(k, h * w), _round_up(n, w)
    Ap, Bp = _pad_to(A, mp, kp), _pad_to(B, kp, np_)
    spec = P("mc", "mr")

    if alg == "stationary_c":
        local = _stationary_c_local
        out_spec = spec
    elif alg == "stationary_a":
        local = functools.partial(_stationary_a_local, w=w)
        out_spec = spec
    elif alg == "stationary_b":
        local = functools.partial(_stationary_b_local, h=h)
        out_spec = spec
    elif alg == "pipelined":
        local = functools.partial(_pipelined_local, w=w)
        out_spec = spec
    else:
        raise ValueError(f"unknown SUMMA algorithm {alg!r}")

    fn = shard_map(local, mesh=mesh, in_specs=(spec, spec),
                   out_specs=out_spec)
    Cp = fn(jax.lax.with_sharding_constraint(Ap, NamedSharding(mesh, spec)),
            jax.lax.with_sharding_constraint(Bp, NamedSharding(mesh, spec)))
    if out_spec != spec:
        Cp = jax.lax.with_sharding_constraint(Cp, NamedSharding(mesh, spec))
    return Cp[:m, :n]


def choose_algorithm(m: int, n: int, k: int, grid: Grid,
                     itemsize: int = 4,
                     pipeline_bytes: int = 64 << 20) -> str:
    """Size heuristic in the spirit of ``Gemm/NN.hpp:582-599``: keep the
    largest operand stationary; switch the stationary-C gather to the
    ring-pipelined collective matmul when the per-device gathered panels
    exceed ``pipeline_bytes`` (the panel then streams one ring step at a
    time and the permute overlaps the matmul — the multistream analog,
    ``Gemm/NN_Multistream.hpp``)."""
    p = grid.size
    if p == 1:
        return "xla"
    h, w = grid.height, grid.width
    weight_a, weight_b, weight_c = m * k, k * n, m * n
    if weight_c >= weight_a and weight_c >= weight_b:
        # stationary-C gathers an (m/h, k) strip of A per device; past the
        # device-memory comfort threshold the ring pipeline wins (one k/w panel
        # resident instead of k)
        if (m // max(h, 1)) * k * itemsize > pipeline_bytes:
            return "pipelined"
        return "stationary_c"
    if weight_b >= weight_a:
        return "stationary_b"
    return "stationary_a"
