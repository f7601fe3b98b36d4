"""Classic matrix drivers (mirrors of ``examples/interface/Fourier.py``,
``JordanCholesky.py``, ``DruinskyToledo.py``): construct, factor, verify
the defining identities."""
import _path  # noqa: F401
import numpy as np
import jax.numpy as jnp
from elemental_tpu.core.environment import Args, output
from elemental_tpu.lapack import cholesky
from elemental_tpu.lapack.ldl import ldl_pivoted, solve_after_pivoted
from elemental_tpu.core.distmatrix import as_array
from elemental_tpu.matrices import druinsky_toledo, fourier, jordan_cholesky


def main():
    args = Args()
    args.input("n", "size", 24)
    args.process_input()
    n = args["n"]
    from elemental_tpu.core.policy import x64_enabled
    tol = 1e-10 if x64_enabled() else 1e-5
    # Fourier: unitary DFT matrix
    F = np.asarray(fourier(n))
    uerr = np.abs(F.conj().T @ F - np.eye(n)).max()
    assert uerr < tol, uerr
    # JordanCholesky: chol factor is the scaled Jordan block
    A = jordan_cholesky(n)
    L = np.tril(np.asarray(as_array(cholesky("L", jnp.asarray(A)))))
    J = np.eye(n) + 2.0 * np.eye(n, k=-1)   # the scaled Jordan block
    jerr = np.abs(L - J).max()
    assert jerr < tol, jerr
    # DruinskyToledo: Bunch-Kaufman growth counterexample still solves
    G = np.asarray(druinsky_toledo(n // 2), np.float64)
    b = np.random.default_rng(0).standard_normal(G.shape[0])
    fact = ldl_pivoted(jnp.asarray(G))
    x = np.asarray(solve_after_pivoted(fact, jnp.asarray(b)))
    rerr = np.linalg.norm(G @ x - b) / np.linalg.norm(b)
    assert rerr < max(1e-6, 100 * tol), rerr
    output(f"fourier unitary {uerr:.1e}; Jordan-Cholesky match {jerr:.1e}; "
           f"Druinsky-Toledo BK solve residual {rerr:.1e}")


if __name__ == "__main__":
    main()
