"""Dtype policy.

One place decides which working precision the library uses and which
residual bounds are acceptable, instead of per-site guesses:

* On CPU (or any platform) with ``jax_enable_x64`` active, the natural
  working dtype is float64 — matching the reference's default ``double``
  builds.
* Without x64, float64 silently truncates to float32 (with a
  warning per array); the policy returns float32 up front so no
  truncation-warning spam appears and all tolerance math is honest.

Residual bounds are derived from machine epsilon of the *effective*
dtype and the problem size, mirroring the reference's test bounds
(``/root/reference/tests/lapack_like/Cholesky.cpp:41-44``: pass iff
``||X - A\\Y|| / (eps * n * ||Y||) <= 100``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["default_real_dtype", "effective_dtype", "residual_bound",
           "x64_enabled"]


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def default_real_dtype(platform: str | None = None):
    """The working real dtype for factorizations on this platform:
    float64 when x64 is live, else float32."""
    if x64_enabled():
        return jnp.float64
    return jnp.float32


def effective_dtype(requested):
    """Map a requested dtype onto what the platform will actually compute
    in (float64 → float32 when x64 is off), without emitting the
    truncation warning."""
    dt = np.dtype(requested)
    if not x64_enabled():
        if dt == np.float64:
            return jnp.float32
        if dt == np.complex128:
            return jnp.complex64
    return jnp.dtype(requested) if hasattr(jnp, "dtype") else requested


def residual_bound(dtype, n: int, factor: float = 100.0) -> float:
    """Acceptable relative residual for a backward-stable factor+solve of
    an n×n system: ``factor * eps(dtype) * n`` (reference
    ``Cholesky.cpp:41-44`` formula).  ``dtype`` is mapped through
    :func:`effective_dtype` first, so a nominal float64 without x64
    gets the float32 bound."""
    eps = float(jnp.finfo(effective_dtype(dtype)).eps)
    return factor * eps * max(int(n), 1)
