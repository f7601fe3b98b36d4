"""The minimum end-to-end slice (SURVEY §7): 2-D Laplacian, planned for
the device by ``plan_spmv`` (the DIA stencil tier) and CG-solved.

Run:  python examples/cg_laplacian.py --n1 256
"""

import _path  # noqa: F401
import numpy as np

import jax
import jax.numpy as jnp

from elemental_tpu.core.environment import Args, output
from elemental_tpu.lapack import cg
from elemental_tpu.matrices import sparse_laplacian_2d
from elemental_tpu.sparse import plan_spmv


def main():
    args = Args()
    args.input("n1", "grid side", 256)
    args.process_input()
    n1 = args["n1"]

    A = sparse_laplacian_2d(n1, n1, scaled=False)
    plan = plan_spmv(A).device(jax.devices()[0], jnp.float32)
    b = jax.device_put(
        np.random.default_rng(0).standard_normal(A.height).astype(np.float32),
        jax.devices()[0])

    res = jax.jit(lambda plan, b: cg(plan.matvec, b, tol=1e-6,
                                     max_iters=5000))(plan, b)
    x = res.x
    output(f"CG ({plan.kind} plan): {int(res.iterations)} iterations, "
           f"residual {float(res.residual):.3e}")
    check = np.linalg.norm(A.to_scipy() @ np.asarray(x) - np.asarray(b))
    output(f"host-verified residual: {check:.3e}")


if __name__ == "__main__":
    main()
