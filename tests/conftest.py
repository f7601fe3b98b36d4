"""Test harness: multi-device testing without a cluster.

The reference tests distributed code by oversubscribing MPI ranks on one host
(``mpiexec -np 4``, SURVEY §4).  Here: force 8 virtual CPU devices via
XLA_FLAGS and build meshes from ``jax.devices('cpu')``.  This must run before
any CPU backend initialization, hence at conftest import time.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

# The reference's fp64 configurations run in f64.
jax.config.update("jax_enable_x64", True)
# Tests run on CPU: deterministic, fast compiles, 8 virtual devices.
jax.config.update("jax_default_device", None)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def cpu_devices():
    return jax.devices("cpu")


@pytest.fixture(scope="session")
def grid8():
    """2x4 grid over 8 virtual CPU devices."""
    from elemental_tpu.core import Grid
    return Grid(devices=cpu_devices(), height=2)


@pytest.fixture(scope="session")
def grid4():
    from elemental_tpu.core import Grid
    return Grid(devices=cpu_devices()[:4], height=2)


@pytest.fixture(scope="session")
def grid1():
    from elemental_tpu.core import Grid
    return Grid(devices=cpu_devices()[:1], height=1)


@pytest.fixture(autouse=True)
def _default_to_cpu():
    """Keep test arrays on the CPU backend (the 8 virtual devices) even
    where an accelerator is attached."""
    with jax.default_device(cpu_devices()[0]):
        yield


@pytest.fixture
def gpu_device():
    """The first GPU; tests marked ``gpu`` skip where JAX has none.  Decided
    here, at run time, never while a module is imported."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; on the card run "
                    "`python -m pytest -m gpu tests/`")
    return gpus[0]


@pytest.fixture(params=["float32", "float64"])
def rdtype(request):
    return np.dtype(request.param)


@pytest.fixture(params=["float32", "float64", "complex64", "complex128"])
def dtype(request):
    return np.dtype(request.param)
