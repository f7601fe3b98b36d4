"""Profiling/tracing (reference ``include/El/core/Profiling.hpp:138-190``:
NVTX/roctx/VTune region annotation + synchronizing profiling).

Design: ``jax.profiler`` traces + ``jax.named_scope`` regions.  Every
solver/SUMMA region in this library is annotated the same way the reference
annotates its regions (e.g. ``Gemm/NN.hpp:115-117``).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import Dict, List, Optional

import jax

_enabled = True
_sync = False  # synchronizing profiling (HYDROGEN_DEFAULT_SYNC_PROFILING analog)
_stage_times: Dict[str, float] = {}


def enable_profiling(on: bool = True) -> None:
    global _enabled
    _enabled = on


def enable_sync_profiling(on: bool = True) -> None:
    """Block until device work completes at region ends, so host timers
    measure device time (reference synchronizing profiling)."""
    global _sync
    _sync = on


@contextlib.contextmanager
def profile_region(name: str, color: Optional[int] = None):
    """RAII region annotation (reference ``AUTO_PROFILE_REGION``)."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    with jax.named_scope(name):
        yield
    if _sync:
        (jax.device_put(0.0) + 0).block_until_ready()
    _stage_times[name] = _stage_times.get(name, 0.0) + time.perf_counter() - t0


def profiled(name: Optional[str] = None):
    def deco(fn):
        region = name or fn.__name__

        @functools.wraps(fn)
        def wrapper(*a, **k):
            with profile_region(region):
                return fn(*a, **k)
        return wrapper
    return deco


def stage_times() -> Dict[str, float]:
    """Accumulated per-region host times (the analog of the reference's
    ``timeStages`` solver reports, ``HermitianEig.cpp:943-1056``)."""
    return dict(_stage_times)


def reset_stage_times() -> None:
    _stage_times.clear()


def start_trace(logdir: str) -> None:
    jax.profiler.start_trace(logdir)


def stop_trace() -> None:
    jax.profiler.stop_trace()
