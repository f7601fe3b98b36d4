"""The per-device peak table and the compilation-cache location."""

import os

import jax
import jax.numpy as jnp
import pytest

from elemental_tpu.core.environment import use_compilation_cache
from elemental_tpu.utils.roofline import CHIPS, chip_spec, matmul_unit


def test_chip_table_h100():
    spec = chip_spec("NVIDIA H100 80GB HBM3")
    assert spec.hbm_bw == 3.35e12
    assert spec.peaks == {"tensor_bf16": 989e12, "tensor_tf32": 495e12,
                          "cuda_f32": 67e12, "tensor_f64": 67e12,
                          "cuda_f64": 34e12}
    assert "data sheet" in spec.source


def test_chip_table_unknown_device_raises():
    with pytest.raises(KeyError, match="no peak rates"):
        chip_spec("TPU v5 lite")
    # the CPU devices the tests run on are not in the table either
    with pytest.raises(KeyError):
        chip_spec()


def test_every_chip_names_its_units_and_source():
    units = {"tensor_bf16", "tensor_tf32", "cuda_f32", "tensor_f64",
             "cuda_f64"}
    for spec in CHIPS.values():
        assert set(spec.peaks) == units and spec.source


@pytest.mark.parametrize("dtype,precision,unit", [
    (jnp.bfloat16, "default", "tensor_bf16"),
    (jnp.float32, "highest", "cuda_f32"),
    (jnp.float32, "default", "tensor_tf32"),
    (jnp.float64, "highest", "tensor_f64"),
])
def test_matmul_unit(dtype, precision, unit):
    assert matmul_unit(dtype, precision) == unit


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_dir(env_set, tmp_path, monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
        expect = str(tmp_path / "c")
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        expect = os.path.join(str(tmp_path), ".jax_cache")
    try:
        assert use_compilation_cache(str(tmp_path)) == expect
        assert jax.config.jax_compilation_cache_dir == expect
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
