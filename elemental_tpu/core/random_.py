"""Global RNG state + samplers (reference ``src/core/random.cpp``,
``include/El/core/random/``): per-process seeded generators with
``Uniform``/``Gaussian``/``Bernoulli`` samplers.

Design: a split-on-use ``jax.random`` key held in module state; matrix
generators in :mod:`elemental_tpu.matrices` draw from here.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_key = None  # lazily created: importing the library must not init a backend


def seed(s: int) -> None:
    global _key
    _key = jax.random.PRNGKey(s)


def next_key():
    global _key
    if _key is None:
        _key = jax.random.PRNGKey(0)
    _key, sub = jax.random.split(_key)
    return sub


def uniform(shape, dtype=jnp.float32, center=0.0, radius=1.0):
    if jnp.issubdtype(dtype, jnp.complexfloating):
        real_dt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        re = jax.random.uniform(next_key(), shape, real_dt, -1.0, 1.0)
        im = jax.random.uniform(next_key(), shape, real_dt, -1.0, 1.0)
        return center + radius * (re + 1j * im).astype(dtype)
    return center + radius * jax.random.uniform(next_key(), shape, dtype,
                                                -1.0, 1.0)


def gaussian(shape, dtype=jnp.float32, mean=0.0, stddev=1.0):
    if jnp.issubdtype(dtype, jnp.complexfloating):
        real_dt = jnp.float32 if dtype == jnp.complex64 else jnp.float64
        re = jax.random.normal(next_key(), shape, real_dt)
        im = jax.random.normal(next_key(), shape, real_dt)
        return mean + stddev * ((re + 1j * im) / jnp.sqrt(2)).astype(dtype)
    return mean + stddev * jax.random.normal(next_key(), shape, dtype)


def bernoulli(shape, p=0.5):
    return jax.random.bernoulli(next_key(), p, shape)


def rademacher(shape, dtype=jnp.float32):
    return jnp.where(bernoulli(shape), 1.0, -1.0).astype(dtype)
