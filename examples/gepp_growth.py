"""GEPP growth driver (mirror of ``examples/interface/GEPPGrowth.py``):
the Wilkinson matrix attaining 2^{n-1} partial-pivoting growth."""
import _path  # noqa: F401
import numpy as np
import jax.numpy as jnp
from elemental_tpu.core.environment import Args, output
from elemental_tpu.lapack import lu
from elemental_tpu.matrices import gepp_growth


def main():
    args = Args()
    args.input("n", "size", 16)
    args.process_input()
    n = args["n"]
    A = gepp_growth(n)
    fact = lu(jnp.asarray(np.asarray(A, np.float64)))
    u = np.triu(np.asarray(fact.lu))
    growth = np.abs(u).max() / np.abs(np.asarray(A)).max()
    output(f"GEPP growth on Wilkinson({n}): {growth:.1f} "
           f"(theory 2^{n - 1} = {2 ** (n - 1)})")
    # getrf's classical partial pivoting: exactly 2^{n-1}
    assert abs(growth - 2 ** (n - 1)) / 2 ** (n - 1) < 1e-10, growth


if __name__ == "__main__":
    main()
