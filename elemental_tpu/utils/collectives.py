"""Collective-communication audit: compile a jitted function and walk the
optimized HLO for collective ops, summing their output bytes.

The reference prints per-rank communication/memory accounting in its
drivers (``tests/lapack_like/SparseLDL.cpp:129-196``); on XLA the ground
truth is the compiled module — GSPMD/shard_map insert the collectives, so
auditing the HLO text is the honest way to report communication volume.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np

import jax

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter",
                "collective-permute", "all-to-all")

# e.g.  %x = f32[8,128]{1,0} all-gather(...)   or tuple shapes
_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_OP_RE = re.compile(
    r"=\s*((?:\([^)]*\)|[a-z0-9]+\[[0-9,]*\][^ ]*))\s+"
    r"(" + "|".join(_COLLECTIVES) + r")(?:-start|-done)?\(")


def _shape_bytes(shape_txt: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(shape_txt):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_audit(fn, *args, **kwargs) -> Dict[str, Dict[str, float]]:
    """Compile ``jax.jit(fn)`` for ``args`` and return, per collective
    kind, the op count and summed output bytes of the optimized HLO.

    Note ``-start``/``-done`` async pairs are counted once (on the start
    op); bytes are the collective's OUTPUT shape — a mesh-wide proxy, not
    per-link traffic."""
    # an already-jitted fn is lowered as it is, so its compilation can be
    # found again in the persistent cache
    jitted = fn if hasattr(fn, "lower") else jax.jit(fn)
    compiled = jitted.lower(*args, **kwargs).compile()
    txt = compiled.as_text()
    out: Dict[str, Dict[str, float]] = {
        k: {"count": 0, "bytes": 0} for k in _COLLECTIVES}
    for line in txt.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        if "-done(" in line:
            continue                    # count async pairs once
        shape_txt, kind = m.group(1), m.group(2)
        out[kind]["count"] += 1
        out[kind]["bytes"] += _shape_bytes(shape_txt)
    out["total"] = {
        "count": sum(v["count"] for k, v in out.items()
                     if k in _COLLECTIVES),
        "bytes": sum(v["bytes"] for k, v in out.items()
                     if k in _COLLECTIVES)}
    return out
