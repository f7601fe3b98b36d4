"""Environment: init, blocksize stacks, CLI args, logging.

Mirrors the reference's ``El::Initialize`` pipeline
(``src/core/environment.cpp:215-330``) and its three-level config system
(SURVEY §5): compile-time options → here module-level flags; the
``Input``/``ProcessInput`` CLI registry (``include/El/core/environment/decl.hpp:52-88``);
and the runtime blocksize stack (``src/blas_like/blocksizes.cpp:16-107``).

No MPI_Init — multi-process JAX uses ``jax.distributed.initialize``;
single-process SPMD over a mesh needs nothing.  Grid/default-mesh setup replaces
the eight communicator splits.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Any, Dict, List, Optional

import jax

from .grid import Grid

logger = logging.getLogger("elemental_tpu")

_initialized = False

def use_compilation_cache(root: str) -> str:
    """Keep JAX's persistent compilation cache in ``$JAX_COMPILATION_CACHE_DIR``
    when that is set, else in ``<root>/.jax_cache`` — a fixed path, because
    the path is part of the cache key.  Returns the directory in use."""
    cache = (os.environ.get("JAX_COMPILATION_CACHE_DIR")
             or os.path.join(os.path.abspath(root), ".jax_cache"))
    jax.config.update("jax_compilation_cache_dir", cache)
    return cache


# --------------------------------------------------------------------------
# Blocksize stacks (reference ``src/blas_like/blocksizes.cpp``): a global
# stack plus per-kernel local stacks consulted by blocked algorithms.
# --------------------------------------------------------------------------

_DEFAULT_BLOCKSIZE = 128  # the reference pushes 128 too
_blocksize_stack: List[int] = [_DEFAULT_BLOCKSIZE]
_local_blocksizes: Dict[str, List[int]] = {}


def blocksize(kernel: Optional[str] = None) -> int:
    if kernel is not None and _local_blocksizes.get(kernel):
        return _local_blocksizes[kernel][-1]
    return _blocksize_stack[-1]


def set_blocksize(nb: int) -> None:
    _blocksize_stack[-1] = nb


def push_blocksize_stack(nb: int) -> None:
    _blocksize_stack.append(nb)


def pop_blocksize_stack() -> int:
    if len(_blocksize_stack) <= 1:
        raise RuntimeError("cannot pop the last blocksize")
    return _blocksize_stack.pop()


def set_local_blocksize(kernel: str, nb: int) -> None:
    _local_blocksizes.setdefault(kernel, []).append(nb)


# --------------------------------------------------------------------------
# Init / finalize
# --------------------------------------------------------------------------

def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialise the runtime (reference ``El::Initialize``).

    For several processes (hosts) pass the ``jax.distributed`` coordinates; for a
    single process this just sets up the default grid and RNG.
    """
    global _initialized
    if _initialized:
        return
    if coordinator_address is not None:
        jax.distributed.initialize(coordinator_address, num_processes,
                                   process_id)
    Grid.set_default(None)  # recompute lazily from jax.devices()
    from . import random_ as _random
    _random.seed(0)
    _initialized = True


def initialized() -> bool:
    return _initialized


def finalize() -> None:
    global _initialized
    _initialized = False


# --------------------------------------------------------------------------
# CLI flag registry (reference Input/ProcessInput/PrintInputReport)
# --------------------------------------------------------------------------

class Args:
    """Typed CLI flag registry: ``Input(name, desc, default)`` then
    ``ProcessInput()`` — every driver/test doubles as a benchmark/repro tool
    exactly like the reference's (``decl.hpp:67-88``)."""

    def __init__(self, argv: Optional[List[str]] = None):
        self._parser = argparse.ArgumentParser(add_help=False)
        self._argv = argv if argv is not None else sys.argv[1:]
        self._values: Dict[str, Any] = {}
        self._descs: Dict[str, str] = {}

    def input(self, name: str, desc: str, default: Any) -> None:
        flag = "--" + name.lstrip("-")
        kwargs: Dict[str, Any] = {"help": desc, "default": default}
        if isinstance(default, bool):
            kwargs["type"] = lambda s: s.lower() in ("1", "true", "yes")
        else:
            kwargs["type"] = type(default)
        self._parser.add_argument(flag, **kwargs)
        self._descs[name.lstrip("-")] = desc

    def process_input(self) -> None:
        ns, _ = self._parser.parse_known_args(self._argv)
        self._values = vars(ns)

    def __getitem__(self, name: str) -> Any:
        return self._values[name.lstrip("-")]

    def print_report(self) -> None:
        output("Input report:")
        for k, v in self._values.items():
            output(f"  --{k} = {v!r}   ({self._descs.get(k, '')})")


_args: Optional[Args] = None


def args() -> Args:
    global _args
    if _args is None:
        _args = Args()
    return _args


# --------------------------------------------------------------------------
# Output / logging (reference Output/OutputFromRoot + per-rank logs)
# --------------------------------------------------------------------------

_indent = 0


def output(*parts: Any) -> None:
    print(" " * _indent + " ".join(str(p) for p in parts))


def output_from_root(*parts: Any) -> None:
    if jax.process_index() == 0:
        output(*parts)


def push_indent(n: int = 2) -> None:
    global _indent
    _indent += n


def pop_indent(n: int = 2) -> None:
    global _indent
    _indent = max(0, _indent - n)


class Timer:
    """Reference ``Timer`` (``include/El/core/Timer.hpp:23-39``)."""

    def __init__(self, name: str = ""):
        self.name = name
        self._start: Optional[float] = None
        self.total = 0.0

    def start(self) -> None:
        self._start = time.perf_counter()

    def stop(self) -> float:
        if self._start is None:
            raise RuntimeError("Timer not started")
        dt = time.perf_counter() - self._start
        self.total += dt
        self._start = None
        return dt

    def partial(self) -> float:
        return (time.perf_counter() - self._start
                if self._start is not None else 0.0)
