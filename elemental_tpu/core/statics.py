"""Pytree registration for plan-carrying containers.

A device array CLOSED OVER by a jitted function is embedded in the jaxpr
as a constant: it is baked into every compiled program (and into the
persistent compile cache), recompiles when the plan changes, and gives XLA
no way to share one executable between plans of one shape.  Every
container holding plan index arrays therefore registers as a pytree whose big arrays are LEAVES,
so the whole container can be passed through ``jax.jit`` as an argument.

Host-side metadata (shapes, orderings, symbolic trees) is carried as the
pytree aux data via :class:`Static` — an identity-hashed wrapper cached on
the instance, so repeated flattens of the same plan hit the jit cache.
"""

from __future__ import annotations

import dataclasses

import jax


class Static:
    """Identity-hashed aux-data wrapper (same object ⇒ jit cache hit)."""

    __slots__ = ("value",)

    def __init__(self, value):
        self.value = value

    def __hash__(self):
        return object.__hash__(self)

    def __eq__(self, other):
        return self is other


def _aux_of(obj) -> Static:
    # Reuse the stored wrapper unconditionally: unflattened copies carry the
    # ORIGINAL instance's aux so flatten/unflatten round-trips preserve
    # treedef identity (statics never mutate after construction).
    aux = obj.__dict__.get("_aux")
    if aux is None:
        aux = Static(obj)
        object.__setattr__(obj, "_aux", aux)
    return aux


def register_plan_pytree(cls, data_fields):
    """Register ``cls`` (a non-frozen dataclass or plain class) as a pytree:
    ``data_fields`` become leaves/subtrees; everything else rides the cached
    identity aux.  Unflatten rebuilds from the ORIGINAL instance's statics,
    which is sound because plan statics never mutate after construction."""

    data_fields = tuple(data_fields)

    def flatten(obj):
        return tuple(getattr(obj, f) for f in data_fields), _aux_of(obj)

    def unflatten(aux, children):
        src = aux.value
        new = object.__new__(cls)
        new.__dict__.update(src.__dict__)
        for f, c in zip(data_fields, children):
            new.__dict__[f] = c
        new.__dict__["_aux"] = aux
        return new

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls
