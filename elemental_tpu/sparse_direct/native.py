"""ctypes bridge to the native C++ symbolic kernels
(``elemental_tpu/native/symbolic.cpp``: quotient-graph minimum degree — the
SuiteSparse-AMD slot, reference §2.6 item 2).  The library is built on
first use from ``native/Makefile``; when the build fails the callers fall
back to NumPy implementations, with a warning carrying the compiler's
error."""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional

import numpy as np

_LIB = None
_TRIED = False


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    nat_dir = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                           "native"))
    path = os.path.join(nat_dir, "libelemental_native.so")
    src = os.path.join(nat_dir, "symbolic.cpp")
    stale = (not os.path.exists(path) or
             (os.path.exists(src) and
              os.path.getmtime(src) > os.path.getmtime(path)))
    if stale:
        # (re)build on first use from the committed Makefile + source; a
        # failed build is reported, and the NumPy orderings take over
        import subprocess
        import warnings
        try:
            subprocess.run(["make", "-C", nat_dir, "-B"], check=True,
                           capture_output=True, text=True, timeout=120)
        except subprocess.CalledProcessError as e:
            warnings.warn(f"building {path} failed; using the NumPy "
                          f"orderings:\n{e.stderr.strip()}", RuntimeWarning)
        except (OSError, subprocess.TimeoutExpired) as e:
            warnings.warn(f"building {path} failed ({e}); using the NumPy "
                          f"orderings", RuntimeWarning)
    if os.path.exists(path):
        lib = ctypes.CDLL(path)
        csr_sig = [
            ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
            np.ctypeslib.ndpointer(np.int64, flags="C"),
        ]
        lib.el_minimum_degree.restype = ctypes.c_int
        lib.el_minimum_degree.argtypes = csr_sig
        if hasattr(lib, "el_rcm"):
            lib.el_rcm.restype = ctypes.c_int
            lib.el_rcm.argtypes = csr_sig
        _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def minimum_degree(adj: List[np.ndarray]) -> np.ndarray:
    lib = _load()
    n = len(adj)
    rowptr = np.zeros(n + 1, np.int64)
    for i, a in enumerate(adj):
        rowptr[i + 1] = rowptr[i] + len(a)
    colind = (np.concatenate(adj) if n and rowptr[-1] else
              np.zeros(0, np.int64)).astype(np.int64)
    perm = np.zeros(n, np.int64)
    rc = lib.el_minimum_degree(n, rowptr, colind, perm)
    if rc != 0:
        raise RuntimeError(f"el_minimum_degree failed: {rc}")
    return perm


def has_rcm() -> bool:
    lib = _load()
    return lib is not None and hasattr(lib, "el_rcm")


def rcm(rowptr: np.ndarray, colind: np.ndarray) -> np.ndarray:
    """Reverse Cuthill–McKee over a symmetrized CSR pattern (no self loops)."""
    lib = _load()
    n = rowptr.shape[0] - 1
    perm = np.zeros(n, np.int64)
    rc = lib.el_rcm(n, np.ascontiguousarray(rowptr, np.int64),
                    np.ascontiguousarray(colind, np.int64), perm)
    if rc != 0:
        raise RuntimeError(f"el_rcm failed: {rc}")
    return perm
