"""Roofline audit helpers: per-device peak rates and speed-of-light shares.

Usage::

    from elemental_tpu.utils.roofline import audit, chip_spec
    report = audit(fn, args, flops=..., bytes_accessed=..., unit="cuda_f32")
    # report.sol_fraction, report.achieved_flops, report.bound

Timing uses the marginal-chain methodology: dependent sweeps of two lengths
remove fixed dispatch latency.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    hbm_bw: float                 # B/s
    peaks: Dict[str, float]       # execution unit -> dense FLOP/s
    source: str


# One table, keyed by ``jax.Device.device_kind``.  A device missing from it
# is an error: a guessed peak makes every roofline share meaningless.
CHIPS = {
    "NVIDIA H100 80GB HBM3": ChipSpec(
        "H100 SXM", 3.35e12,
        {"tensor_bf16": 989e12,   # bf16/fp16 operands on the tensor cores
         "tensor_tf32": 495e12,   # f32 matmuls at default precision
         "cuda_f32": 67e12,       # f32 FMA outside the tensor cores
         "tensor_f64": 67e12,     # DGEMM on the tensor cores
         "cuda_f64": 34e12},      # f64 FMA outside the tensor cores
        "NVIDIA H100 Tensor Core GPU data sheet, SXM5, dense rates at the "
        "700 W board power"),
}


def chip_spec(device_kind: Optional[str] = None) -> ChipSpec:
    """The peak table entry for ``device_kind`` (default: the first
    device's); raises ``KeyError`` for a device the table does not hold."""
    kind = device_kind or jax.devices()[0].device_kind
    try:
        return CHIPS[kind]
    except KeyError:
        raise KeyError(f"no peak rates for device kind {kind!r}; add it to "
                       f"elemental_tpu.utils.roofline.CHIPS with its "
                       f"source") from None


def matmul_unit(dtype, precision: str = "highest") -> str:
    """The execution unit a dense matmul of ``dtype`` runs on under
    ``precision``: bf16 on the bf16 tensor cores; f32 at 'highest' on the
    CUDA cores (full f32 products), at lower precision in TF32; f64 on the
    f64 tensor cores."""
    dt = jnp.dtype(dtype)
    if dt == jnp.bfloat16 or dt == jnp.float16:
        return "tensor_bf16"
    if dt in (jnp.float64, jnp.complex128):
        return "tensor_f64"
    return "cuda_f32" if precision == "highest" else "tensor_tf32"


@dataclasses.dataclass
class RooflineReport:
    seconds: float
    achieved_flops: float
    achieved_bw: float
    bound: str              # 'memory' or 'compute'
    unit: str
    sol_seconds: float
    sol_fraction: float

    def __str__(self):
        return (f"{self.seconds * 1e6:.1f} us | "
                f"{self.achieved_flops / 1e12:.2f} TFLOP/s, "
                f"{self.achieved_bw / 1e9:.0f} GB/s | {self.bound}-bound "
                f"({self.unit}), {100 * self.sol_fraction:.1f}% of SoL")


def marginal_time(fn: Callable, x0, r1: int = 20, r2: int = 100,
                  tries: int = 3) -> float:
    """Per-application device time of ``fn`` via dependent-chain slope."""
    def sweep(reps):
        f = jax.jit(lambda x: jnp.sum(jax.lax.fori_loop(
            0, reps, lambda i, acc: fn(acc), x)))
        float(f(x0))
        best = float("inf")
        for _ in range(tries):
            t0 = time.perf_counter()
            float(f(x0))
            best = min(best, time.perf_counter() - t0)
        return best

    t1, t2 = sweep(r1), sweep(r2)
    return max((t2 - t1) / (r2 - r1), 1e-12)


def audit(fn: Callable, x0, flops: float, bytes_accessed: float,
          unit: str = "cuda_f32", chain: bool = True,
          seconds: Optional[float] = None) -> RooflineReport:
    """Roofline-audit a self-composable kernel (fn: x → x-like) whose
    arithmetic runs on ``unit`` (see :func:`matmul_unit`)."""
    spec = chip_spec()
    if seconds is None:
        seconds = marginal_time(fn, x0) if chain else _simple_time(fn, x0)
    t_mem = bytes_accessed / spec.hbm_bw
    t_cmp = flops / spec.peaks[unit]
    sol = max(t_mem, t_cmp)
    return RooflineReport(
        seconds=seconds,
        achieved_flops=flops / seconds,
        achieved_bw=bytes_accessed / seconds,
        bound="memory" if t_mem >= t_cmp else "compute",
        unit=unit,
        sol_seconds=sol,
        sol_fraction=sol / seconds,
    )


def _simple_time(fn, x0, reps: int = 20) -> float:
    out = fn(x0)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(x0)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps
