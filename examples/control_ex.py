"""Control-theory solvers (mirror of the reference ``src/control`` tier:
Sylvester, Lyapunov, algebraic Riccati via the matrix sign function)."""
import _path  # noqa: F401
import numpy as np
import jax.numpy as jnp
from elemental_tpu.core.environment import Args, output
from elemental_tpu.control import lyapunov, ricatti, sylvester


def main():
    args = Args()
    args.input("n", "size", 24)
    args.process_input()
    n = args["n"]
    rng = np.random.default_rng(9)
    # Sylvester: spectra separated by the imaginary axis
    A = rng.standard_normal((n, n)) + n * np.eye(n)
    B = rng.standard_normal((n, n)) + n * np.eye(n)
    C = rng.standard_normal((n, n))
    X = np.asarray(sylvester(jnp.asarray(A), jnp.asarray(B), jnp.asarray(C)))
    r1 = np.linalg.norm(A @ X + X @ B - C) / np.linalg.norm(C)
    # Lyapunov
    Q = rng.standard_normal((n, n))
    Cs = -(Q @ Q.T) - np.eye(n)
    As = rng.standard_normal((n, n)) + 1.5 * n * np.eye(n)
    Xl = np.asarray(lyapunov(jnp.asarray(As), jnp.asarray(Cs)))
    r2 = np.linalg.norm(As @ Xl + Xl @ As.T - Cs) / np.linalg.norm(Cs)
    # continuous algebraic Riccati: AᵀX + XA − XKX + L = 0
    Astab = rng.standard_normal((n, n)) - 2 * n * np.eye(n)
    Bk = rng.standard_normal((n, n // 2))
    K = Bk @ Bk.T
    Lq = rng.standard_normal((n, n))
    L = Lq @ Lq.T + np.eye(n)
    # ricatti(uplo, A, K, L) solves AᴴX + XA + K − X·L·X = 0: our CARE
    # AᵀX + XA − X·K·X + L = 0 maps to (constant=L, quadratic=K)
    Xr = np.asarray(ricatti("L", jnp.asarray(Astab), jnp.asarray(L),
                            jnp.asarray(K)))
    r3 = np.linalg.norm(Astab.T @ Xr + Xr @ Astab - Xr @ K @ Xr + L) \
        / np.linalg.norm(L)
    output(f"sylvester {r1:.2e}, lyapunov {r2:.2e}, riccati {r3:.2e}")
    # dtype-aware bounds (in f32 the sign iterations carry ~1e3·eps)
    from elemental_tpu.core.policy import default_real_dtype
    eps = float(jnp.finfo(default_real_dtype()).eps)
    b1 = max(1e-8, 3e3 * eps)
    b3 = max(1e-6, 3e4 * eps)
    assert r1 < b1 and r2 < b1 and r3 < b3, (r1, r2, r3, b1, b3)


if __name__ == "__main__":
    main()
