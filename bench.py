"""Kernel-level benchmark on one GPU: per-stage rate and its share of the
device's speed of light.

    python bench.py                       # every stage
    BENCH_STAGES=gemm,stencil python bench.py

The parent process imports no JAX: it runs each stage in a child process,
one after another (one process on the card at a time), with a hard
timeout, and prints ONE JSON line ``{"stages": {...}, "failed": [...]}``
in which every stage result names its device.  It exits non-zero if any
stage failed.

Every stage names the execution unit its arithmetic runs on and divides
by that unit's peak from ``elemental_tpu.utils.roofline.CHIPS`` (keyed by
``device_kind``; an unknown device fails the stage).  Times are the
marginal of dependent chains of two lengths, (t(R₂) − t(R₁))/(R₂ − R₁),
which removes fixed dispatch cost; a sample faster than the speed of light
is a measurement error and is rejected.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))


def _marginal(sweep, r1, r2, sol, tries=5):
    """Median of three marginal per-rep times; samples below the speed of
    light ``sol`` (seconds per rep) are dropped."""
    ests = []
    for _ in range(tries):
        dt = (sweep(r2) - sweep(r1)) / (r2 - r1)
        if dt >= sol:
            ests.append(dt)
        if len(ests) == 3:
            return statistics.median(ests)
    raise RuntimeError(f"no physically possible marginal: {ests}")


def _chain_sweep(step, x0):
    """sweep(reps) → best seconds of a jitted ``reps``-long dependent
    chain of ``step`` starting at ``x0``."""
    import jax
    import jax.numpy as jnp
    fns = {}

    def sweep(reps):
        if reps not in fns:
            fns[reps] = jax.jit(lambda x: jnp.sum(jax.lax.fori_loop(
                0, reps, lambda i, a: step(a), x)).astype(jnp.float32))
        f = fns[reps]
        float(f(x0))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            float(f(x0))
            best = min(best, time.perf_counter() - t0)
        return best
    return sweep


def _spec():
    from elemental_tpu.utils.roofline import chip_spec
    return chip_spec()


# --------------------------------------------------------------------------
# stages (run inside child processes)
# --------------------------------------------------------------------------

def stage_stencil():
    """DIA SpMV on a 4096² 2-D Laplacian in f32 (plan_spmv's stencil tier);
    memory-bound: diagonals + x + y streamed once."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from elemental_tpu.matrices import sparse_laplacian_2d
    from elemental_tpu.sparse import plan_spmv

    A = sparse_laplacian_2d(4096, 4096, scaled=False)
    plan = plan_spmv(A).device(jax.devices()[0], jnp.float32)
    x = jnp.asarray(np.random.default_rng(0).standard_normal(A.width),
                    jnp.float32)
    spec = _spec()
    sol = plan.stream_bytes / spec.hbm_bw
    dt = _marginal(_chain_sweep(lambda v: plan.matvec(v) * 0.125, x),
                   20, 120, sol)
    return {"unit": "hbm", "us": dt * 1e6, "nnz_per_s": A.nnz / dt,
            "bytes_per_s": plan.stream_bytes / dt, "sol_frac": sol / dt}


def stage_unstructured():
    """CSR SpMV, uniform-random n=2²⁰, 10 nnz/row, f32 (plan_spmv's csr
    tier); memory-bound accounting: values + two int32 index streams."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from elemental_tpu.sparse import SparseMatrix, plan_spmv

    n = 1 << 20
    rng = np.random.default_rng(0)
    A = SparseMatrix.from_coo(n, n, np.repeat(np.arange(n), 10),
                              rng.integers(0, n, 10 * n),
                              rng.standard_normal(10 * n))
    plan = plan_spmv(A).device(jax.devices()[0], jnp.float32)
    x = jnp.asarray(rng.standard_normal(n), jnp.float32)
    spec = _spec()
    sol = plan.stream_bytes / spec.hbm_bw
    dt = _marginal(_chain_sweep(lambda v: plan.matvec(v) * 0.3, x),
                   20, 120, sol)
    return {"unit": "hbm", "kind": plan.kind, "us": dt * 1e6,
            "nnz_per_s": A.nnz / dt, "sol_frac": sol / dt}


def stage_gemm():
    """8192² matmul: bf16 on the tensor cores, f32 at 'highest' (the
    library's default pin), and f32 at default precision (TF32)."""
    import numpy as np
    import jax.numpy as jnp
    from elemental_tpu.utils.roofline import matmul_unit

    spec = _spec()
    m = 8192
    a = np.random.default_rng(0).standard_normal((m, m)).astype(np.float32)
    out = {}
    for name, dtype, prec in [("bf16", jnp.bfloat16, "default"),
                              ("f32_highest", jnp.float32, "highest"),
                              ("f32_default", jnp.float32, "default")]:
        x = jnp.asarray(a, dtype)
        unit = matmul_unit(dtype, prec)
        flops = 2.0 * m ** 3
        sol = flops / spec.peaks[unit]
        step = lambda acc: (jnp.matmul(x, acc, precision=prec)  # noqa
                            / np.sqrt(m)).astype(dtype)
        dt = _marginal(_chain_sweep(step, x), 4, 24, sol)
        out[name] = {"unit": unit, "ms": dt * 1e3,
                     "tflops": flops / dt / 1e12, "sol_frac": sol / dt}
    return out


def stage_sparse_ldl():
    """Multifrontal LDL factor (spd, f64) on a 32³ 3-D Laplacian; the front
    matmuls run as DGEMM on the f64 tensor cores."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    jax.config.update("jax_enable_x64", True)
    from elemental_tpu.matrices import sparse_laplacian_3d
    from elemental_tpu.sparse_direct import SparseLDLFactorization

    A = sparse_laplacian_3d(32, 32, 32, scaled=False)
    f = SparseLDLFactorization(spd=True)
    f.initialize(A, size_bucket=1.5)
    f.factor()
    b = np.random.default_rng(0).standard_normal(A.height)
    r = float(np.linalg.norm(A.to_scipy() @ np.asarray(f.solve(b)) - b)
              / np.linalg.norm(b))
    if not r < f.residual_bound():
        raise AssertionError(f"LDL residual {r} > {f.residual_bound()}")
    vals = jnp.asarray(A.vals)
    reg = jnp.zeros(A.height)

    def sweep(reps):
        f._run_factor(vals, reg)
        t0 = time.perf_counter()
        for _ in range(reps):
            _, d = f._run_factor(vals, reg)
        float(jnp.sum(d))
        return time.perf_counter() - t0

    gf = f.factor_gflops()
    spec = _spec()
    sol = gf * 1e9 / spec.peaks["tensor_f64"]
    dt = _marginal(sweep, 2, 6, sol)
    return {"unit": "tensor_f64", "factor_s": dt, "gflops": gf / dt,
            "sol_frac": sol / dt, "residual": r}


def stage_condense():
    """HermitianTridiag, Bidiag and Hessenberg at n=4096 in f32; their
    blocked updates are pinned to 'highest', so the f32 CUDA cores bound
    them."""
    import numpy as np
    import jax
    import jax.numpy as jnp
    from elemental_tpu.lapack import hermitian_tridiag
    from elemental_tpu.lapack.condense import (_bidiag_blocked,
                                               _hessenberg_blocked)

    n = 4096
    rng = np.random.default_rng(0)
    a = rng.standard_normal((n, n)).astype(np.float32)
    A = jnp.asarray(a + a.T)
    G = jnp.asarray(rng.standard_normal((n, n)).astype(np.float32))
    spec = _spec()
    out = {}
    for name, fn, arg, flops in [
            ("tridiag", lambda A: hermitian_tridiag("L", A,
                                                    want_q=False)[:2],
             A, 4 / 3 * n ** 3),
            ("bidiag", lambda a: _bidiag_blocked(a, nb=32), G,
             8 / 3 * n ** 3),
            ("hessenberg", lambda a: _hessenberg_blocked(a, nb=32), A,
             10 / 3 * n ** 3)]:
        f = jax.jit(fn)

        def sweep(reps, f=f, arg=arg):
            jax.block_until_ready(f(arg))
            t0 = time.perf_counter()
            for _ in range(reps):
                o = f(arg)
            jax.block_until_ready(o)
            return time.perf_counter() - t0

        sol = flops / spec.peaks["cuda_f32"]
        dt = _marginal(sweep, 1, 3, sol)
        out[name] = {"unit": "cuda_f32", "s": dt,
                     "gflops": flops / dt / 1e9, "sol_frac": sol / dt}
    return out


STAGES = {"stencil": stage_stencil, "unstructured": stage_unstructured,
          "gemm": stage_gemm, "sparse_ldl": stage_sparse_ldl,
          "condense": stage_condense}


def _child(name):
    import jax
    from elemental_tpu.core.environment import use_compilation_cache
    use_compilation_cache(ROOT)
    dev = jax.devices()[0]
    res = STAGES[name]()
    res["device"] = {"platform": dev.platform, "kind": dev.device_kind}
    print("BENCH_RESULT " + json.dumps(res))


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--stage":
        _child(sys.argv[2])
        return 0
    only = os.environ.get("BENCH_STAGES")
    names = only.split(",") if only else list(STAGES)
    timeout = float(os.environ.get("BENCH_TIMEOUT", "900"))
    results, failed = {}, []
    for name in names:
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--stage", name],
                capture_output=True, text=True, timeout=timeout)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("BENCH_RESULT ")]
            if proc.returncode == 0 and lines:
                results[name] = json.loads(lines[-1][len("BENCH_RESULT "):])
            else:
                results[name] = {"error": proc.stderr.strip()[-800:]}
        except subprocess.TimeoutExpired:
            results[name] = {"error": f"timeout after {timeout:.0f} s"}
        except Exception:  # noqa: BLE001 — recorded and fails the run
            results[name] = {"error": traceback.format_exc(limit=3)}
        if "error" in results[name]:
            failed.append(name)
    print(json.dumps({"stages": results, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
