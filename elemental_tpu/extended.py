"""Extended precision: double-word ("double-double") arithmetic.

Reference parity: the QD/Quad/BigFloat tier (`src/core/imports/{qd,mpfr}.cpp`,
`include/El/core/Element/` — DoubleDouble/QuadDouble, __float128, MPFR
BigFloat).  The reference reaches beyond-hardware precision with software
compensated arithmetic; this module is the XLA equivalent built on
error-free transformations (Knuth TwoSum, Dekker split + TwoProd) that run
as ordinary vectorized jnp ops:

- base f32         → ~48-bit significand ("emulated f64"): the double-word
  kernel path SURVEY §7 calls out for fp64 configs on f32-only hardware;
- base f64         → ~106-bit significand (the reference's DoubleDouble).

Everything is expressed as (hi, lo) pairs of same-shape arrays — a pytree,
so DD values flow through jit/vmap/scan unchanged.  No data-dependent
control flow anywhere: every algorithm is branch-free, so XLA fuses the
compensated chains into the surrounding kernels.

The dangerous failure mode is a compiler re-associating the compensation
(then `two_sum` silently returns err=0).  XLA does not re-associate floats
outside of reductions, and the test suite asserts the achieved precision
(≥1.8× the base mantissa), which would catch any such regression.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp


# ------------------------------------------------------------------
# error-free transformations
# ------------------------------------------------------------------

def two_sum(a, b):
    """Knuth TwoSum: s + err == a + b exactly (6 flops, branch-free)."""
    s = a + b
    bb = s - a
    err = (a - (s - bb)) + (b - bb)
    return s, err


def quick_two_sum(a, b):
    """Dekker FastTwoSum; requires |a| >= |b|."""
    s = a + b
    err = b - (s - a)
    return s, err


def _split_const(dtype):
    # Dekker splitting constant 2^ceil(p/2)+1 (p = significand bits)
    bits = {np.dtype(np.float32): 12, np.dtype(np.float64): 27}[np.dtype(dtype)]
    return (1 << bits) + 1


def split(a):
    """Dekker split: a == hi + lo with both halves on half-width mantissas."""
    c = jnp.asarray(_split_const(a.dtype), a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker TwoProd: p + err == a*b exactly."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, err


# ------------------------------------------------------------------
# the DD pair
# ------------------------------------------------------------------

@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class DD:
    """Double-word number/array: value = hi + lo, |lo| <= ulp(hi)/2."""
    hi: jnp.ndarray
    lo: jnp.ndarray

    def tree_flatten(self):
        return (self.hi, self.lo), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -------------- conversions --------------
    @classmethod
    def from_array(cls, x, dtype=jnp.float32) -> "DD":
        """Split a (wider or equal) host value into (hi, lo) base-dtype
        words: hi = round(x), lo = round(x - hi)."""
        x = np.asarray(x, np.float64)
        hi = x.astype(np.dtype(dtype))
        lo = (x - hi.astype(np.float64)).astype(np.dtype(dtype))
        return cls(jnp.asarray(hi), jnp.asarray(lo))

    def to_float64(self) -> np.ndarray:
        return np.asarray(self.hi, np.float64) + np.asarray(self.lo,
                                                            np.float64)

    @property
    def shape(self):
        return self.hi.shape

    @property
    def dtype(self):
        return self.hi.dtype

    # -------------- operators --------------
    def __add__(self, other):
        return dd_add(self, _as_dd(other, self.dtype))

    def __sub__(self, other):
        return dd_add(self, dd_neg(_as_dd(other, self.dtype)))

    def __mul__(self, other):
        return dd_mul(self, _as_dd(other, self.dtype))

    def __truediv__(self, other):
        return dd_div(self, _as_dd(other, self.dtype))

    def __neg__(self):
        return dd_neg(self)

    def __getitem__(self, idx):
        return DD(self.hi[idx], self.lo[idx])


def _as_dd(x, dtype) -> DD:
    if isinstance(x, DD):
        return x
    x = jnp.asarray(x, dtype)
    return DD(x, jnp.zeros_like(x))


def dd_neg(a: DD) -> DD:
    return DD(-a.hi, -a.lo)


def dd_add(a: DD, b: DD) -> DD:
    """Full (accurate) DD addition — 20 flops, ~2 ulp DD error."""
    s, e = two_sum(a.hi, b.hi)
    t, f = two_sum(a.lo, b.lo)
    e = e + t
    s, e = quick_two_sum(s, e)
    e = e + f
    return DD(*quick_two_sum(s, e))


def dd_mul(a: DD, b: DD) -> DD:
    p, e = two_prod(a.hi, b.hi)
    e = e + (a.hi * b.lo + a.lo * b.hi)
    return DD(*quick_two_sum(p, e))


def dd_div(a: DD, b: DD) -> DD:
    # one Newton step on the hi-word quotient
    q1 = a.hi / b.hi
    r = dd_add(a, dd_neg(dd_mul(_as_dd(q1, a.dtype), b)))
    q2 = r.hi / b.hi
    r = dd_add(r, dd_neg(dd_mul(_as_dd(q2, a.dtype), b)))
    q3 = r.hi / b.hi
    q, e = quick_two_sum(q1, q2)
    return DD(*quick_two_sum(q, e + q3))


def dd_sqrt(a: DD) -> DD:
    # Karp-Markstein: y ≈ 1/sqrt(hi); s = hi*y; refine with one DD step
    y = 1.0 / jnp.sqrt(a.hi)
    s = a.hi * y
    e = dd_add(a, dd_neg(dd_mul(_as_dd(s, a.dtype), _as_dd(s, a.dtype))))
    return dd_add(_as_dd(s, a.dtype), _as_dd(e.hi * (0.5 * y), a.dtype))


def dd_abs(a: DD) -> DD:
    neg = a.hi < 0
    return DD(jnp.where(neg, -a.hi, a.hi), jnp.where(neg, -a.lo, a.lo))


# ------------------------------------------------------------------
# reductions / linear-algebra kernels (log-depth trees)
# ------------------------------------------------------------------

def dd_sum(a: DD, axis: int = -1) -> DD:
    """Compensated sum along ``axis`` via a log-depth pairwise DD tree —
    each level is one vectorized ``dd_add``, so XLA sees O(log n) fused
    elementwise kernels (the vectorized analog of the reference's sequential
    compensated loops)."""
    hi = jnp.moveaxis(a.hi, axis, -1)
    lo = jnp.moveaxis(a.lo, axis, -1)
    n = hi.shape[-1]
    # pad to a power of two with exact zeros
    m = 1 << max(0, (n - 1)).bit_length()
    pad = [(0, 0)] * (hi.ndim - 1) + [(0, m - n)]
    x = DD(jnp.pad(hi, pad), jnp.pad(lo, pad))
    while x.hi.shape[-1] > 1:
        half = x.hi.shape[-1] // 2
        x = dd_add(DD(x.hi[..., :half], x.lo[..., :half]),
                   DD(x.hi[..., half:], x.lo[..., half:]))
    return DD(x.hi[..., 0], x.lo[..., 0])


def dd_dot(x, y) -> DD:
    """Dot product with exact per-element products (TwoProd) and a DD tree
    reduction: ~full double-word accuracy, the compensated ``Dot`` the
    reference gets from QD."""
    xd, yd = _as_dd(x, _base_dtype(x)), _as_dd(y, _base_dtype(y))
    p, e = two_prod(xd.hi, yd.hi)
    e = e + (xd.hi * yd.lo + xd.lo * yd.hi)
    return dd_sum(DD(p, e), axis=-1)


def _base_dtype(x):
    return x.dtype if not isinstance(x, DD) else x.hi.dtype


def dd_norm2(x) -> DD:
    s = dd_dot(x, x)
    return dd_sqrt(s)


def dd_axpy(alpha, x: DD, y: DD) -> DD:
    return dd_add(dd_mul(_as_dd(alpha, x.dtype), x), y)


def dd_matvec(A: DD, x: DD, block: int = 2048) -> DD:
    """y = A·x in double-word precision.  Per-row TwoProd + DD tree sum,
    vectorized over rows (one fused elementwise chain, no Python loops)."""
    p, e = two_prod(A.hi, x.hi[None, :])
    e = e + (A.hi * x.lo[None, :] + A.lo * x.hi[None, :])
    return dd_sum(DD(p, e), axis=-1)


def dd_gemm(A: DD, B: DD, block_k: int = 16) -> DD:
    """C = A·B in double-word precision.

    Formulation: ``lax.scan`` over K-slabs; each slab forms the
    exact (TwoProd) outer-product tensor m×n×kb elementwise and folds it into
    the DD accumulator.  This is the software path — deliberately parallel
    to the reference's QD GEMM, which is likewise a software loop an order
    of magnitude slower than the hardware tier.  For ~f32 accuracy from the
    matrix units use ``ops.level3`` with ``set_matmul_precision('highest')``; DD is
    for when the answer must carry ~2× the hardware mantissa.
    """
    m, k = A.hi.shape
    k2, n = B.hi.shape
    assert k == k2
    kb = min(block_k, k)
    nblk = -(-k // kb)
    kpad = nblk * kb
    Ah = jnp.pad(A.hi, ((0, 0), (0, kpad - k)))
    Al = jnp.pad(A.lo, ((0, 0), (0, kpad - k)))
    Bh = jnp.pad(B.hi, ((0, kpad - k), (0, 0)))
    Bl = jnp.pad(B.lo, ((0, kpad - k), (0, 0)))
    Ah = Ah.reshape(m, nblk, kb).transpose(1, 0, 2)
    Al = Al.reshape(m, nblk, kb).transpose(1, 0, 2)
    Bh = Bh.reshape(nblk, kb, n)
    Bl = Bl.reshape(nblk, kb, n)

    def step(acc, slab):
        ah, al, bh, bl = slab
        # (m, kb, n) exact products of the hi words
        p, e = two_prod(ah[:, :, None], bh[None])
        e = e + (ah[:, :, None] * bl[None] + al[:, :, None] * bh[None])
        part = dd_sum(DD(p, e), axis=1)
        return dd_add(acc, part), None

    zero = DD(jnp.zeros((m, n), A.hi.dtype), jnp.zeros((m, n), A.hi.dtype))
    acc, _ = jax.lax.scan(step, zero, (Ah, Al, Bh, Bl))
    return acc


# ------------------------------------------------------------------
# applications: extended-precision iterative refinement
# ------------------------------------------------------------------

def refined_solve_dd(A, solve_fn, b, iters: int = 3):
    """Iterative refinement with the residual computed in double-word
    precision (the reference's reason for carrying QD: IR in `Refined.hpp`
    promotes a hardware-precision factorization to near-double-word
    accuracy).  ``A`` is the hardware-precision matrix, ``solve_fn`` an
    approximate solver (e.g. a Cholesky solve), ``b`` the RHS."""
    A = jnp.asarray(A)
    Add = _as_dd(A, A.dtype)
    bdd = _as_dd(jnp.asarray(b), A.dtype)
    x = solve_fn(jnp.asarray(b))
    xdd = _as_dd(x, A.dtype)
    for _ in range(iters):
        r = dd_add(bdd, dd_neg(dd_matvec(Add, xdd)))
        d = solve_fn(r.hi + r.lo)
        xdd = dd_add(xdd, _as_dd(d, A.dtype))
    return xdd


# ------------------------------------------------------------------
# QD: quad-double (4-word) expansions — reference QuadDouble parity
# (Hida–Li–Bailey "sloppy" algorithms, branch-free renormalization)
# ------------------------------------------------------------------

def _three_sum(a, b, c):
    t1, t2 = two_sum(a, b)
    a, t3 = two_sum(c, t1)
    b, c = two_sum(t2, t3)
    return a, b, c


def _three_sum2(a, b, c):
    t1, t2 = two_sum(a, b)
    a, t3 = two_sum(c, t1)
    return a, t2 + t3


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass
class QD:
    """Quad-double value: x ≈ c0 + c1 + c2 + c3 (non-overlapping words).
    ~212-bit significand on f64 base (reference ``QuadDouble``), ~96-bit on
    f32 base.  A pytree — flows through jit/vmap unchanged."""

    c0: jnp.ndarray
    c1: jnp.ndarray
    c2: jnp.ndarray
    c3: jnp.ndarray

    def tree_flatten(self):
        return (self.c0, self.c1, self.c2, self.c3), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    @classmethod
    def from_array(cls, x, dtype=jnp.float64) -> "QD":
        hi = jnp.asarray(x, dtype)
        z = jnp.zeros_like(hi)
        return cls(hi, z, z, z)

    @classmethod
    def from_dd(cls, d: DD) -> "QD":
        z = jnp.zeros_like(d.hi)
        return cls(d.hi, d.lo, z, z)

    def to_float64(self) -> np.ndarray:
        return (np.asarray(self.c0, np.float64)
                + np.asarray(self.c1, np.float64)
                + np.asarray(self.c2, np.float64)
                + np.asarray(self.c3, np.float64))

    @property
    def words(self):
        return (self.c0, self.c1, self.c2, self.c3)

    def __add__(self, other):
        return qd_add(self, _as_qd(other, self.c0.dtype))

    def __sub__(self, other):
        o = _as_qd(other, self.c0.dtype)
        return qd_add(self, QD(-o.c0, -o.c1, -o.c2, -o.c3))

    def __mul__(self, other):
        return qd_mul(self, _as_qd(other, self.c0.dtype))

    def __neg__(self):
        return QD(-self.c0, -self.c1, -self.c2, -self.c3)


def _as_qd(x, dtype) -> QD:
    if isinstance(x, QD):
        return x
    if isinstance(x, DD):
        return QD.from_dd(x)
    return QD.from_array(x, dtype)


def qd_renormalize(c0, c1, c2, c3, c4) -> QD:
    """Renormalize a 5-term expansion (standard HLB ladder)."""
    s, t3 = quick_two_sum(c3, c4)
    s, t2 = quick_two_sum(c2, s)
    s, t1 = quick_two_sum(c1, s)
    r0, s = quick_two_sum(c0, s)
    # push the residuals down a second time (branch-free variant of the
    # QD library's conditional ladder; loses <1 ulp of the last word)
    r1, s2 = quick_two_sum(s, t1)
    r2, s3 = quick_two_sum(s2, t2)
    r3 = s3 + t3
    return QD(r0, r1, r2, r3)


def qd_add(a: QD, b: QD) -> QD:
    """a + b (HLB sloppy addition: componentwise two_sums + carry chain)."""
    s0, t0 = two_sum(a.c0, b.c0)
    s1, t1 = two_sum(a.c1, b.c1)
    s2, t2 = two_sum(a.c2, b.c2)
    s3, t3 = two_sum(a.c3, b.c3)
    s1, t0 = two_sum(s1, t0)
    s2, t0, t1 = _three_sum(s2, t0, t1)
    s3, t0 = _three_sum2(s3, t0, t2)
    t0 = t0 + t1 + t3
    return qd_renormalize(s0, s1, s2, s3, t0)


def qd_mul(a: QD, b: QD) -> QD:
    """a · b (HLB sloppy multiplication: O(eps^4) cross terms dropped)."""
    p0, q0 = two_prod(a.c0, b.c0)
    p1, q1 = two_prod(a.c0, b.c1)
    p2, q2 = two_prod(a.c1, b.c0)
    p3, q3 = two_prod(a.c0, b.c2)
    p4, q4 = two_prod(a.c1, b.c1)
    p5, q5 = two_prod(a.c2, b.c0)

    # order-1 terms
    p1, p2, q0 = _three_sum(p1, p2, q0)
    # order-2 terms
    p2, q1, q2 = _three_sum(p2, q1, q2)
    p3, p4, p5 = _three_sum(p3, p4, p5)
    s0, t0 = two_sum(p2, p3)
    s1, t1 = two_sum(q1, p4)
    s2 = q2 + p5
    s1, t0 = two_sum(s1, t0)
    s2 = s2 + t0 + t1
    # order-3 terms
    s3 = (q3 + q4 + q5
          + a.c1 * b.c2 + a.c2 * b.c1 + a.c0 * b.c3 + a.c3 * b.c0)
    return qd_renormalize(p0, p1, s0, s1, s2 + s3)


def qd_sum(a: QD, axis: int = -1) -> QD:
    """Compensated sum along ``axis`` via a log-depth pairwise QD tree —
    each level one vectorized ``qd_add`` (same design as :func:`dd_sum`;
    no O(n)-serial ``fori_loop``)."""
    ws = [jnp.moveaxis(w, axis, -1) for w in a.words]
    n = ws[0].shape[-1]
    m = 1 << max(0, (n - 1)).bit_length()
    pad = [(0, 0)] * (ws[0].ndim - 1) + [(0, m - n)]
    x = QD(*(jnp.pad(w, pad) for w in ws))
    while x.c0.shape[-1] > 1:
        half = x.c0.shape[-1] // 2
        x = qd_add(QD(*(w[..., :half] for w in x.words)),
                   QD(*(w[..., half:] for w in x.words)))
    return QD(*(w[..., 0] for w in x.words))


def qd_dot(x, y) -> QD:
    """Compensated dot product at quad-double precision: exact products
    (TwoProd) accumulated with the log-depth QD tree reduction (reference
    QuadDouble dot)."""
    xj = jnp.asarray(x)
    yj = jnp.asarray(y)
    p, e = two_prod(xj, yj)
    z = jnp.zeros_like(p)
    return qd_sum(QD(p, e, z, z), axis=-1)
