"""Scalar/type helpers (reference ``include/El/core/Element/``, ``limits``).

fp64 runs natively on the CPU and on the GPU under ``jax_enable_x64``.  ``epsilon``/``safe_min`` mirror the reference's
``limits::Epsilon`` used in every residual bound.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


def real_type(dtype):
    dt = jnp.dtype(dtype)
    if dt == jnp.complex64:
        return jnp.float32
    if dt == jnp.complex128:
        return jnp.float64
    return dt


def complex_type(dtype):
    dt = jnp.dtype(dtype)
    if dt in (jnp.float64, jnp.complex128):
        return jnp.complex128
    return jnp.complex64


def is_complex(dtype) -> bool:
    return jnp.issubdtype(jnp.dtype(dtype), jnp.complexfloating)


def epsilon(dtype) -> float:
    return float(np.finfo(np.dtype(real_type(dtype)).name).eps)


def safe_min(dtype) -> float:
    return float(np.finfo(np.dtype(real_type(dtype)).name).tiny)


def conj_if(cond: bool, x):
    return jnp.conj(x) if cond else x
