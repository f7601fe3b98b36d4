"""Bring-up check on NVIDIA GPUs: drives the library's main paths once, at
sizes its users run, and compares each with a plain reference.

    python chip_smoke.py                # phases A-D on one GPU
    python chip_smoke.py --phase B      # only the named phase(s)
    python chip_smoke.py --devices 4    # only the 4-GPU path + its 1-GPU
                                        # comparison

Phases (one GPU, ``jax.devices()[0]``):
  A  plan_spmv on a 4096² 2-D Laplacian (DIA) and a 2²⁰-row uniform-random
     CSR (10 nnz/row), f32, against scipy in f64; CG on the Laplacian.
  B  multifrontal sparse LDL (spd, size buckets) on a 48³ 3-D Laplacian in
     f64 and f32, against its residual bound.
  C  the n1 = 224 ConcatFD2D LP (n = 100,352, KKT N = 150,528) through
     ``lp_direct`` in f64, against HiGHS's interior-point method (run in a
     CPU-only child process started at launch, so it overlaps A and B).
  D  dense: gemm (f32 at 'highest', bf16), Cholesky + solve in f64,
     Hermitian tridiagonalization in f32, against NumPy in f64.

Each phase prints its comparison, its compile time (XLA backend compiles
plus persistent-cache reads), wall time and the process's
``peak_bytes_in_use`` so far.  Any failed phase makes the exit code
non-zero.  The last line is a JSON object naming the device.  There is no
CPU fallback: without a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))


# ---------------------------------------------------------------------------
# compile accounting (jax.monitoring events)
# ---------------------------------------------------------------------------

class CompileStats:
    """Backend compile seconds, cache-read seconds and counts since the
    last :meth:`reset`."""

    def __init__(self):
        import jax.monitoring as mon
        self.reset()
        mon.register_event_duration_secs_listener(self._duration)
        mon.register_event_listener(self._event)

    def reset(self):
        self.seconds = 0.0
        self.compiles = 0
        self.cache_hits = 0

    def _duration(self, event, duration, **kwargs):
        if event == "/jax/core/compile/backend_compile_duration":
            self.seconds += duration
            self.compiles += 1
        elif event == "/jax/compilation_cache/cache_retrieval_time_sec":
            self.seconds += duration

    def _event(self, event, **kwargs):
        if event == "/jax/compilation_cache/cache_hits":
            self.cache_hits += 1


def _timed(fn, *args, reps: int = 3):
    """Best wall seconds of ``fn(*args)`` (result blocked on) after one
    warm-up call; returns (seconds, result)."""
    import jax
    out = jax.block_until_ready(fn(*args))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best, out


def _check(name, value, bound):
    ok = bool(np.isfinite(value) and value <= bound)
    print(f"    {name}: {value:.3e} (bound {bound:.1e}) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{name} {value:.3e} exceeds {bound:.1e}")


# ---------------------------------------------------------------------------
# phases (each takes its sizes, so the CPU tests can run them tiny)
# ---------------------------------------------------------------------------

def phase_spmv_cg(n1=4096, n_rand=1 << 20, nnz_row=10, cg_iters=100):
    """A: plan_spmv (DIA stencil and CSR) in f32 against scipy in f64, then
    CG on the Laplacian with the plan's matvec."""
    import jax
    import jax.numpy as jnp
    from elemental_tpu.lapack import cg
    from elemental_tpu.matrices import sparse_laplacian_2d
    from elemental_tpu.sparse import SparseMatrix, plan_spmv

    dev = jax.devices()[0]
    rng = np.random.default_rng(0)
    mv = jax.jit(lambda p, v: p.matvec(v))
    out = {}
    lap = sparse_laplacian_2d(n1, n1, scaled=False)
    rows = np.repeat(np.arange(n_rand), nnz_row)
    rnd = SparseMatrix.from_coo(n_rand, n_rand, rows,
                                rng.integers(0, n_rand, rows.size),
                                rng.standard_normal(rows.size))
    for name, A, kind in [("laplacian", lap, "stencil"),
                          ("random", rnd, "csr")]:
        t0 = time.perf_counter()
        plan = plan_spmv(A)
        host = time.perf_counter() - t0
        assert plan.kind == kind, (name, plan.kind)
        plan = plan.device(dev, jnp.float32)
        x = rng.standard_normal(A.width).astype(np.float32)
        xd = jax.device_put(plan.to_plan_space(x), dev)
        sec, y = _timed(mv, plan, xd, reps=10)
        y = plan.from_plan_space(np.asarray(y, np.float64))
        ref = A.to_scipy() @ x.astype(np.float64)
        print(f"    {name}: n={A.height} nnz={A.nnz} plan={plan.kind} "
              f"(host {host:.2f} s), SpMV {sec * 1e6:.1f} us, "
              f"{A.nnz / sec / 1e9:.2f} Gnnz/s, "
              f"{plan.stream_bytes / sec / 1e9:.1f} GB/s", flush=True)
        _check(f"{name} SpMV max err / max|y|",
               np.abs(y - ref).max() / np.abs(ref).max(), 1e-5)
        out[f"{name}_spmv_us"] = sec * 1e6
        if name == "laplacian":
            lap_plan, b = plan, xd

    solve = jax.jit(lambda p, b: cg(p.matvec, b, tol=0.0,
                                    max_iters=cg_iters))
    sec, res = _timed(solve, lap_plan, b, reps=1)
    assert int(res.iterations) == cg_iters
    xs = np.asarray(res.x, np.float64)
    true = np.linalg.norm(np.asarray(b, np.float64) - lap.to_scipy() @ xs)
    rec = float(res.residual)
    print(f"    CG {cg_iters} its: {sec * 1e3:.1f} ms "
          f"({sec / cg_iters * 1e6:.1f} us/it), recurrence residual "
          f"{rec:.4e}, true residual {true:.4e}", flush=True)
    _check("CG |true - recurrence| / recurrence", abs(true - rec) / rec,
           1e-3)
    out["cg_us_per_it"] = sec / cg_iters * 1e6
    return out


F32_LDL_RESIDUAL = 1e-5


def phase_sparse_ldl(nl=48, size_bucket=1.5):
    """B: SparseLDLFactorization(spd) on a 3-D Laplacian, f64 then f32
    (same ordering), checked against ``residual_bound``."""
    import jax
    from elemental_tpu.matrices import sparse_laplacian_3d
    from elemental_tpu.sparse_direct import SparseLDLFactorization

    A = sparse_laplacian_3d(nl, nl, nl, scaled=False)
    b = np.random.default_rng(1).standard_normal(A.height)
    out, perm = {}, None
    for x64 in (True, False):
        with jax.enable_x64(x64):
            f = SparseLDLFactorization(spd=True)
            t0 = time.perf_counter()
            f.initialize(A, perm=perm, size_bucket=size_bucket)
            host = time.perf_counter() - t0
            perm = f.symb.perm
            t0 = time.perf_counter()
            f.factor()
            jax.block_until_ready(f.numeric.d)
            first = time.perf_counter() - t0
            sec, _ = _timed(lambda: f.factor().numeric.d, reps=2)
            x = np.asarray(f.solve(b), np.float64)
            tag = np.dtype(f._dtype).name
            gf = f.factor_gflops()
            print(f"    {tag}: n={A.height} pool "
                  f"{f.symb.pool_size * np.dtype(f._dtype).itemsize / 1e9:.2f}"
                  f" GB, {len(f.symb.levels)} levels, symbolic {host:.1f} s,"
                  f" first factor {first:.1f} s, factor {sec:.3f} s "
                  f"({gf / sec:.1f} GFlop/s of {gf:.1f} GFlop)", flush=True)
        r = np.linalg.norm(A.to_scipy() @ x - b) / np.linalg.norm(b)
        # 100·eps·n passes anything in f32 at this n (1.3 at 48³); the
        # second limit catches TF32 front products (~1e-3) where sound
        # f32 runs give ~4e-7
        bound = f.residual_bound() if x64 else min(f.residual_bound(),
                                                   F32_LDL_RESIDUAL)
        _check(f"{tag} ‖Ax−b‖/‖b‖", r, bound)
        out[f"factor_s_{tag}"] = sec
    return out


def _concat_fd_lp(n1):
    """The phase-C instance: min cᵀx s.t. [FD₁ FD₂]·x = b, x ≥ 0 (the
    reference's ConcatFD2D driver) with a feasible b and positive c."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    from lp_direct_large import concat_fd_2d
    A = concat_fd_2d(n1, n1)
    rng = np.random.default_rng(0)
    b = A.to_scipy() @ (np.abs(rng.standard_normal(A.width)) + 0.1)
    c = np.abs(rng.standard_normal(A.width)) + 0.5
    return A, b, c


def _highs_optimum(n1):
    """HiGHS's interior-point method plus crossover on the phase-C
    instance (at n1=224 its default dual simplex stops without an
    answer).  Runs in a child process that never touches the GPU."""
    os.environ["JAX_PLATFORMS"] = "cpu"
    import scipy.optimize as so
    A, b, c = _concat_fd_lp(n1)
    t0 = time.perf_counter()
    ref = so.linprog(c, A_eq=A.to_scipy(), b_eq=b, bounds=(0, None),
                     method="highs-ipm")
    return ref.status, ref.message, ref.fun, time.perf_counter() - t0


def _start_highs(n1):
    """(executor, future) of :func:`_highs_optimum` in a spawned child."""
    import concurrent.futures as cf
    import multiprocessing as mp
    ex = cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn"))
    return ex, ex.submit(_highs_optimum, n1)


def phase_lp(n1=224, tol=1e-8, highs=None):
    """C: the ConcatFD2D LP through ``lp_direct`` in f64, against HiGHS on
    the same instance, solved meanwhile in a CPU-only child process.
    ``highs``: the future of that solve when the caller started it
    earlier (:func:`_start_highs`); else it starts here."""
    from elemental_tpu.optimization import LPCtrl, lp_direct

    A, b, c = _concat_fd_lp(n1)
    m, n = A.shape
    ex = None
    if highs is None:
        ex, highs = _start_highs(n1)
    try:
        t0 = time.perf_counter()
        res = lp_direct(A, b, c, LPCtrl(tol=tol, max_iters=100))
        wall = time.perf_counter() - t0
        status, message, ref_obj, t_highs = highs.result()
    finally:
        if ex is not None:
            ex.shutdown(cancel_futures=True)
    assert status == 0, message
    its = np.asarray(res.iter_seconds)
    print(f"    m={m} n={n} KKT N={m + n}: {res.iterations} iterations, "
          f"{wall:.1f} s wall, {its.sum():.1f} s in the iterations "
          f"(median {np.median(its):.3f} s/it, first {its[0]:.1f} s incl. "
          f"compile), converged={res.converged}; HiGHS {t_highs:.1f} s",
          flush=True)
    if not res.converged:
        raise AssertionError("lp_direct did not converge")
    prim = np.linalg.norm(A.to_scipy() @ res.x - b) / np.linalg.norm(b)
    _check("relative primal residual", prim, 1e-6)
    _check("|obj − obj_HiGHS| / |obj_HiGHS|",
           abs(res.objective - ref_obj) / abs(ref_obj), 1e-6)
    _check("min(x) below zero", max(0.0, -res.x.min()), 1e-8)
    return {"iterations": res.iterations, "wall_s": wall,
            "s_per_it": float(np.median(its))}


def phase_dense(n_gemm=8192, n_chol=16384, n_tri=4096, sample=512):
    """D: gemm on a 1×1 Grid (f32 'highest', bf16), Cholesky + solve in
    f64, Hermitian tridiagonalization in f32."""
    import jax
    import jax.numpy as jnp
    import scipy.linalg as sla
    import elemental_tpu as el
    from elemental_tpu import lapack as la
    from elemental_tpu.core.policy import residual_bound
    from elemental_tpu.ops import level3

    dev = jax.devices()[0]
    grid = el.Grid(devices=[dev], height=1)
    rng = np.random.default_rng(2)
    out = {}

    a = rng.standard_normal((n_gemm, n_gemm)).astype(np.float32)
    bm = rng.standard_normal((n_gemm, n_gemm)).astype(np.float32)
    s = min(sample, n_gemm)
    ref = a[:s].astype(np.float64) @ bm.astype(np.float64)
    for tag, dt, bound in [("f32", jnp.float32, 1e-5),
                           ("bf16", jnp.bfloat16, 1e-2)]:
        A = el.distribute(jnp.asarray(a, dt), el.MC, el.MR, grid)
        B = el.distribute(jnp.asarray(bm, dt), el.MC, el.MR, grid)
        f = jax.jit(lambda A, B: el.ops.gemm("N", "N", 1.0, A, B).data)
        sec, C = _timed(f, A, B)
        err = np.abs(np.asarray(C[:s], np.float64) - ref).max()
        print(f"    gemm {tag} n={n_gemm} (library precision "
              f"'{level3._matmul_precision}'): {sec * 1e3:.2f} ms, "
              f"{2 * n_gemm ** 3 / sec / 1e12:.1f} TFLOP/s", flush=True)
        _check(f"gemm {tag} max err / max|C|", err / np.abs(ref).max(),
               bound)
        out[f"gemm_{tag}_ms"] = sec * 1e3

    with jax.enable_x64(True):
        key = jax.random.PRNGKey(3)
        G = jax.random.normal(key, (n_chol, n_chol), jnp.float64)
        S = jax.jit(lambda G: G @ G.T / n_chol
                    + jnp.eye(n_chol, dtype=G.dtype))(G)
        Bv = jax.random.normal(jax.random.PRNGKey(4), (n_chol, 4),
                               jnp.float64)
        del G
        chol = jax.jit(lambda S: la.cholesky("L", S))
        sec, L = _timed(chol, S)
        fact = jax.jit(lambda S, L: jnp.linalg.norm(S - L @ L.T)
                       / jnp.linalg.norm(S))
        X = jax.jit(lambda L, B: la.cholesky_solve_after("L", "N", L, B))(
            L, Bv)
        solv = jax.jit(lambda S, X, B: jnp.linalg.norm(S @ X - B)
                       / (jnp.linalg.norm(S) * jnp.linalg.norm(X)))
        print(f"    cholesky f64 n={n_chol}: {sec * 1e3:.1f} ms, "
              f"{n_chol ** 3 / 3 / sec / 1e12:.2f} TFLOP/s", flush=True)
        bound = residual_bound(jnp.float64, n_chol)
        _check("‖A−LLᵀ‖/‖A‖", float(fact(S, L)), bound)
        _check("‖AX−B‖/(‖A‖‖X‖)", float(solv(S, X, Bv)), bound)
        out["cholesky_ms"] = sec * 1e3
        del S, L, X

    t = rng.standard_normal((n_tri, n_tri)).astype(np.float32)
    t = t + t.T
    tri = jax.jit(lambda A: la.hermitian_tridiag("L", A, want_q=False)[:2])
    sec, (d, e) = _timed(tri, jax.device_put(t, dev), reps=1)
    w_t = sla.eigvalsh_tridiagonal(np.asarray(d, np.float64),
                                   np.asarray(e, np.float64))
    w_a = np.linalg.eigvalsh(t.astype(np.float64))
    print(f"    hermitian_tridiag f32 n={n_tri} (blocked updates pinned to "
          f"'highest'): {sec * 1e3:.1f} ms", flush=True)
    _check("tridiag eigenvalue err / max|λ|",
           np.abs(w_t - w_a).max() / np.abs(w_a).max(),
           residual_bound(jnp.float32, n_tri))
    out["tridiag_ms"] = sec * 1e3
    return out


def phase_multi(devices, n_gemm=16384, n_chol=16384, n1=4096, nl=48,
                cg_iters=100, dist_front_min=1536):
    """The distributed path on a 2-D grid over ``devices``: SUMMA gemm,
    distributed Cholesky, DistSparseMatrix SpMV + CG, and
    DistSparseLDLFactorization with distributed 2-D fronts (fronts of at
    least ``dist_front_min``) — each against one device or a host
    reference, with HLO collective counts.  The LDL uses size buckets, as
    phase B does."""
    import jax
    import jax.numpy as jnp
    import elemental_tpu as el
    from elemental_tpu import lapack as la
    from elemental_tpu.core.policy import residual_bound
    from elemental_tpu.matrices import sparse_laplacian_2d, sparse_laplacian_3d
    from elemental_tpu.sparse import DistSparseMatrix
    from elemental_tpu.sparse_direct import (DistSparseLDLFactorization,
                                             SparseLDLFactorization)
    from elemental_tpu.utils.collectives import collective_audit

    grid = el.Grid(devices=devices)
    one = devices[0]
    print(f"    grid {grid.height}x{grid.width} over {len(devices)} "
          f"{one.device_kind}", flush=True)
    rng = np.random.default_rng(5)
    out = {}

    def coll(fn, *args):
        t = collective_audit(fn, *args)["total"]
        return f"{t['count']} collectives, {t['bytes'] / 1e6:.1f} MB"

    with jax.default_device(one):
        a = jax.random.normal(jax.random.PRNGKey(7), (n_gemm, n_gemm),
                              jnp.float32)
        bm = jax.random.normal(jax.random.PRNGKey(8), (n_gemm, n_gemm),
                               jnp.float32)
    ref_f = jax.jit(lambda a, b: jnp.matmul(a, b, precision="highest"))
    sec1, ref = _timed(ref_f, a, bm)
    ref = np.asarray(ref)
    print(f"    1-device matmul f32 highest n={n_gemm}: "
          f"{sec1 * 1e3:.1f} ms", flush=True)
    A = el.distribute(a, el.MC, el.MR, grid)
    B = el.distribute(bm, el.MC, el.MR, grid)
    for alg in ("stationary_a", "stationary_b", "stationary_c",
                "pipelined"):
        f = jax.jit(lambda A, B, alg=alg: el.ops.gemm(
            "N", "N", 1.0, A, B, alg=alg).data)
        sec, C = _timed(f, A, B)
        err = np.abs(np.asarray(C) - ref).max() / np.abs(ref).max()
        print(f"    SUMMA {alg}: {sec * 1e3:.1f} ms "
              f"({sec1 / sec:.2f}x one device), {coll(f, A, B)}",
              flush=True)
        _check(f"SUMMA {alg} max err / max|C|", err, 1e-5)
        out[f"summa_{alg}_ms"] = sec * 1e3
    del a, bm, A, B, C, ref

    with jax.enable_x64(True), jax.default_device(one):
        G = jax.random.normal(jax.random.PRNGKey(6), (n_chol, n_chol),
                              jnp.float64)
        S = el.distribute(jax.jit(lambda G: G @ G.T / n_chol + jnp.eye(
            n_chol, dtype=G.dtype))(G), el.MC, el.MR, grid)
        del G
        chol = jax.jit(lambda S: la.cholesky("L", S).data)
        sec, L = _timed(chol, S)
        res = jax.jit(lambda S, L: jnp.linalg.norm(S.data - L @ L.T)
                      / jnp.linalg.norm(S.data))(S, L)
        print(f"    dist cholesky f64 n={n_chol}: {sec * 1e3:.1f} ms, "
              f"{coll(chol, S)}", flush=True)
        _check("dist ‖A−LLᵀ‖/‖A‖", float(res),
               residual_bound(jnp.float64, n_chol))
        out["dist_cholesky_ms"] = sec * 1e3
        del S, L

    lap = sparse_laplacian_2d(n1, n1, scaled=False)
    dl = DistSparseMatrix.from_sparse(lap, grid)
    x = rng.standard_normal(lap.height)
    xd = jax.device_put(x.astype(np.float32))
    dl32 = dl.change_nonzero_values(lap.vals.astype(np.float32))
    mv = jax.jit(lambda d, v: d.matvec(v))
    sec, y = _timed(mv, dl32, xd, reps=10)
    ref = lap.to_scipy() @ x.astype(np.float32).astype(np.float64)
    print(f"    dist SpMV f32 n={lap.height}: {sec * 1e6:.1f} us, "
          f"{coll(mv, dl32, xd)}", flush=True)
    _check("dist SpMV max err / max|y|",
           np.abs(np.asarray(y, np.float64) - ref).max()
           / np.abs(ref).max(), 1e-5)
    solve = jax.jit(lambda d, b: la.cg(d.matvec, b, tol=0.0,
                                       max_iters=cg_iters))
    sec, r = _timed(solve, dl32, xd, reps=1)
    true = np.linalg.norm(np.asarray(xd, np.float64)
                          - lap.to_scipy() @ np.asarray(r.x, np.float64))
    rec = float(r.residual)
    print(f"    dist CG {cg_iters} its: {sec * 1e3:.1f} ms", flush=True)
    _check("dist CG |true - recurrence| / recurrence",
           abs(true - rec) / rec, 1e-3)
    del dl, dl32

    with jax.enable_x64(True):
        lap3 = sparse_laplacian_3d(nl, nl, nl, scaled=False)
        b = rng.standard_normal(lap3.height)
        fd = DistSparseLDLFactorization(spd=True)
        fd.initialize(DistSparseMatrix.from_sparse(lap3, grid),
                      size_bucket=1.5)
        big = [lev.front_size for lev in fd.symb.levels
               if lev.front_size >= dist_front_min
               and lev.sn_ids.shape[0] <= 8]
        assert big, "no level qualifies for the distributed 2-D fronts"
        prev = os.environ.get("ELEMENTAL_DIST_FRONT_MIN")
        os.environ["ELEMENTAL_DIST_FRONT_MIN"] = str(dist_front_min)
        try:
            fd.factor()
        finally:
            if prev is None:
                del os.environ["ELEMENTAL_DIST_FRONT_MIN"]
            else:
                os.environ["ELEMENTAL_DIST_FRONT_MIN"] = prev
        sec_mesh, _ = _timed(lambda: fd.factor().numeric.d, reps=2)
        xs = np.asarray(fd.solve(b))
        r = np.linalg.norm(lap3.to_scipy() @ xs - b) / np.linalg.norm(b)
        print(f"    dist LDL {nl}^3 f64: {len(big)} levels on 2-D fronts "
              f"(sizes {big}), factor {sec_mesh:.3f} s on the mesh",
              flush=True)
        _check("dist LDL ‖Ax−b‖/‖b‖", r, fd.residual_bound())
        vals = jnp.asarray(lap3.vals)
        regz = jnp.zeros(lap3.height)
        print(f"    dist LDL factor program: "
              f"{coll(fd._factor_jit, fd.symb, vals, regz)}", flush=True)
        perm = fd.symb.perm
        del fd, vals, regz          # free the mesh pool before one card's
        with jax.default_device(one):
            f1 = SparseLDLFactorization(spd=True)
            f1.initialize(lap3, perm=perm, size_bucket=1.5)
            f1.factor()
            sec_one, _ = _timed(lambda: f1.factor().numeric.d, reps=2)
        print(f"    LDL {nl}^3 f64 on one device: {sec_one:.3f} s "
              f"(mesh {sec_one / sec_mesh:.2f}x)", flush=True)
        out.update(dist_ldl_s=sec_mesh, one_ldl_s=sec_one)
    return out


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _gpu_or_exit(count):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"chip_smoke: needs an NVIDIA GPU; JAX found "
                 f"'{devs[0].platform}' devices only")
    if len(devs) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX found {len(devs)}")
    return devs[:count]


def _card_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the 4-GPU path and its comparison")
    ap.add_argument("--phase", action="append", choices=list("ABCD"),
                    help="run only these phases (repeatable)")
    args = ap.parse_args(argv)

    devices = _gpu_or_exit(args.devices)
    import jax
    jax.config.update("jax_enable_x64", True)
    from elemental_tpu.core.environment import use_compilation_cache
    cache = use_compilation_cache(ROOT)
    n_cached = len(os.listdir(cache)) if os.path.isdir(cache) else 0
    dev = devices[0]
    print(_card_line())
    print(f"device_kind: {dev.device_kind}; jax {jax.__version__}; "
          f"compile cache {cache} ({n_cached} entries at start)", flush=True)

    highs_ex = None
    if args.devices == 4:
        phases = [("multi", lambda: phase_multi(devices))]
    else:
        names = args.phase or list("ABCD")
        highs = None
        if "C" in names:
            # the reference LP solve is CPU-only and the slowest part of
            # phase C: start it now so it overlaps the phases before C
            highs_ex, highs = _start_highs(224)
        phases = [("A", phase_spmv_cg), ("B", phase_sparse_ldl),
                  ("C", lambda: phase_lp(highs=highs)), ("D", phase_dense)]
        phases = [p for p in phases if p[0] in names]

    stats = CompileStats()
    failed = []
    try:
        for name, fn in phases:
            print(f"phase {name}:", flush=True)
            stats.reset()
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:  # noqa: BLE001 — reported, fails the run
                traceback.print_exc()
                failed.append(name)
            wall = time.perf_counter() - t0
            peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
            print(f"phase {name}: {'FAILED' if name in failed else 'ok'}, "
                  f"compile {stats.seconds:.1f} s ({stats.compiles} "
                  f"compiles, {stats.cache_hits} cache hits), wall "
                  f"{wall:.1f} s, peak_bytes_in_use {peak / 1e9:.2f} GB",
                  flush=True)
    finally:
        if highs_ex is not None:
            highs_ex.shutdown(cancel_futures=True)
    if failed:
        print(json.dumps({"ok": False, "failed": failed}))
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
