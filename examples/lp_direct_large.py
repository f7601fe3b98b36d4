"""At-scale sparse IPM demonstration (mirror of
``examples/interface/LPDirect.py:70-115`` on the ConcatFD2D operator).

Solves  min cᵀx  s.t.  A·x = b, x ≥ 0  where A = [FD₁ FD₂] stacks two 2-D
finite-difference blocks (m = n1², n = 2·n1² variables) — every IPM
iteration re-factors the fixed-pattern KKT with the level-batched
multifrontal RegularizedLDL (symbolic reused, ``ChangeNonzeroValues``).

At-scale invocation (n = 10⁵ variables):

    python examples/lp_direct_large.py --n1 224

Reports wall-clock per IPM iteration and the multifrontal factor GFlop
estimate (reference ``LocalFactorGFlops``, ``SparseLDL.cpp:143-169``).
``chip_smoke.py`` phase C runs the same instance in f64 on one GPU and
compares it with HiGHS.
"""

import time

import _path  # noqa: F401
import numpy as np

from elemental_tpu.core.environment import Args, output
from elemental_tpu.optimization import LPCtrl, lp_direct
from elemental_tpu.optimization.kkt import KKTBuilder
from elemental_tpu.sparse import SparseMatrix


def concat_fd_2d(n0, n1):
    """Two 2-D finite-difference blocks side by side (reference BP.py's
    ConcatFD2D stencil), vectorized assembly."""
    m = n0 * n1
    s = np.arange(m)
    x0, x1 = s % n0, s // n0
    rows, cols, vals = [], [], []

    def add(mask, col, val):
        rows.append(s[mask]); cols.append(col[mask])
        vals.append(np.full(int(mask.sum()), float(val)))

    t = np.ones(m, bool)
    add(t, s, 11.0); add(t, s + m, -20.0)
    add(x0 > 0, s - 1, -1.0); add(x0 > 0, s + m - 1, -17.0)
    add(x0 + 1 < n0, s + 1, 2.0); add(x0 + 1 < n0, s + m + 1, -20.0)
    add(x1 > 0, s - n0, -30.0); add(x1 > 0, s + m - n0, -3.0)
    add(x1 + 1 < n1, s + n0, 4.0); add(x1 + 1 < n1, s + m + n0, 3.0)
    return SparseMatrix.from_coo(m, 2 * m, np.concatenate(rows),
                                 np.concatenate(cols),
                                 np.concatenate(vals))


def kkt_factor_gflops(A: SparseMatrix, gamma=1e-9, delta=1e-9) -> float:
    """Flop estimate of one multifrontal KKT factorization."""
    from elemental_tpu.optimization.lp import _build_lp_kkt
    kkt, _ = _build_lp_kkt(A, gamma, delta, None)
    total = 0.0
    for sn in kkt.symb.supernodes:
        ns = sn.cols[1] - sn.cols[0]
        nr = len(sn.struct)
        sfull = ns + nr
        for k in range(ns):
            total += 2.0 * (sfull - k) ** 2
    return total / 1e9


def main():
    args = Args()
    args.input("n1", "FD grid dimension (n = 2*n1^2 variables)", 24)
    args.input("tol", "convergence tolerance", 1e-8)
    args.process_input()
    n1 = args["n1"]
    A = concat_fd_2d(n1, n1)
    m, n = A.shape
    rng = np.random.default_rng(0)
    x0 = np.abs(rng.standard_normal(n)) + 0.1
    b = A.to_scipy() @ x0
    c = np.abs(rng.standard_normal(n)) + 0.5

    gf = kkt_factor_gflops(A)
    output(f"LP: m={m} rows, n={n} vars, nnz(A)={A.nnz}, "
           f"KKT factor ≈ {gf:.3f} GFlop")

    t0 = time.time()
    res = lp_direct(A, b, c, LPCtrl(tol=args["tol"], max_iters=100))
    wall = time.time() - t0
    per_it = wall / max(res.iterations, 1)
    output(f"objective = {res.objective:.8g} in {res.iterations} iterations "
           f"({wall:.1f}s wall, {per_it:.2f}s/it, "
           f"~{gf / per_it:.2f} GFlop/s factor-bound)")
    r = np.linalg.norm(A.to_scipy() @ res.x - b) / (1 + np.linalg.norm(b))
    output(f"primal residual {r:.2e}, min(x) = {res.x.min():.2e}, "
           f"converged={res.converged}")
    assert np.isfinite(r) and res.x.min() > -1e-6
    assert r < 1e-6, r


if __name__ == "__main__":
    main()
