"""Native C++ RCM (el_rcm) vs the NumPy fallback: both must produce a valid
permutation that restores the bandwidth of a scrambled banded matrix."""

import numpy as np
import scipy.sparse as sp

from elemental_tpu.sparse import SparseMatrix
from elemental_tpu.sparse_direct import native, ordering


def _scrambled_banded(n=512, bw=4, seed=0):
    rng = np.random.default_rng(seed)
    offs = list(range(-bw, bw + 1))
    S = sp.diags([rng.standard_normal(n) for _ in offs], offs,
                 shape=(n, n), format="csr")
    S = (S + S.T).astype(np.float32)
    p = rng.permutation(n)
    return SparseMatrix.from_scipy(S[p][:, p].tocsr()), bw


def _bandwidth(A, perm):
    c = A.to_scipy()[perm][:, perm].tocoo()
    return int(np.abs(c.row - c.col).max())


def test_native_rcm_restores_bandwidth():
    if not native.has_rcm():
        import pytest
        pytest.skip("native library not built")
    A, bw = _scrambled_banded()
    rowptr, colind = ordering._sym_pattern_csr(A)
    perm = native.rcm(rowptr, colind)
    assert sorted(perm.tolist()) == list(range(A.height))
    assert _bandwidth(A, perm) <= 2 * bw + 1


def test_dispatch_prefers_native_and_matches_fallback_quality():
    A, bw = _scrambled_banded(seed=1)
    perm = ordering.reverse_cuthill_mckee(A)
    assert sorted(perm.tolist()) == list(range(A.height))
    assert _bandwidth(A, perm) <= 2 * bw + 1


def test_native_build_failure_warns(monkeypatch):
    """A failed build of the native library is reported with the
    compiler's error, and the NumPy orderings take over."""
    import os
    import subprocess
    import warnings
    from elemental_tpu.sparse_direct import native

    def failing_make(*args, **kwargs):
        raise subprocess.CalledProcessError(
            2, args[0], stderr="symbolic.cpp:1:1: error: no compiler")

    exists = os.path.exists
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(subprocess, "run", failing_make)
    monkeypatch.setattr(os.path, "exists",
                        lambda p: False if p.endswith(".so") else exists(p))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert not native.available()
    assert any("error: no compiler" in str(w.message) for w in caught)
