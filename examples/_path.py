"""Make examples runnable from a source checkout without installation."""
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                "..")))

# The reference is an fp64 LAPACK-world library; the examples run in fp64
# on every platform (the CPU and the GPU both compute it natively).
import jax

jax.config.update("jax_enable_x64", True)
