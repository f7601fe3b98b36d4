"""chip_smoke.py: every phase at a tiny size on the CPU (the comparisons
and control flow; the card runs them at full size), the GPU requirement,
and the on-card pass marked ``gpu``."""

import os
import subprocess
import sys

import jax
import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def test_phase_spmv_cg_tiny():
    out = chip_smoke.phase_spmv_cg(n1=24, n_rand=512, cg_iters=20)
    assert set(out) == {"laplacian_spmv_us", "random_spmv_us",
                        "cg_us_per_it"}


def test_phase_sparse_ldl_tiny():
    out = chip_smoke.phase_sparse_ldl(nl=7)
    assert set(out) == {"factor_s_float64", "factor_s_float32"}


def test_phase_lp_tiny():
    out = chip_smoke.phase_lp(n1=8)
    assert out["iterations"] > 0


def test_phase_dense_tiny():
    # 300 > the recursive Cholesky base case; 200 takes the blocked
    # tridiagonalization
    out = chip_smoke.phase_dense(n_gemm=96, n_chol=300, n_tri=200,
                                 sample=32)
    assert {"gemm_f32_ms", "gemm_bf16_ms", "cholesky_ms",
            "tridiag_ms"} <= set(out)


def test_phase_multi_tiny():
    devs = jax.devices("cpu")[:4]
    out = chip_smoke.phase_multi(devs, n_gemm=64, n_chol=128, n1=16, nl=10,
                                 cg_iters=10, dist_front_min=96)
    assert {"summa_pipelined_ms", "dist_cholesky_ms", "dist_ldl_s",
            "one_ldl_s"} <= set(out)


def test_check_rejects_out_of_bound():
    with pytest.raises(AssertionError):
        chip_smoke._check("x", 2e-5, 1e-5)
    with pytest.raises(AssertionError):
        chip_smoke._check("x", float("nan"), 1e-5)
    chip_smoke._check("x", 1e-6, 1e-5)


def test_main_without_gpu_exits_nonzero(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_script_alone_fails(tmp_path):
    """Outside the checkout (no package beside it) the script fails and
    prints no result."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=env, capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.gpu
def test_phases_on_gpu(gpu_device):
    """On the card: the phases at reduced sizes, compiled for the GPU."""
    with jax.default_device(gpu_device):
        chip_smoke.phase_spmv_cg(n1=256, n_rand=1 << 14, cg_iters=20)
        chip_smoke.phase_sparse_ldl(nl=12)
        chip_smoke.phase_lp(n1=16)
        chip_smoke.phase_dense(n_gemm=1024, n_chol=1024, n_tri=512)


def test_main_starts_reference_first_and_fails_on_a_failed_phase(
        monkeypatch, capsys, tmp_path):
    """The driver starts phase C's reference solve before any phase, runs
    every selected phase even after a failure, stops the reference's
    process, and reports the failure in a non-zero exit and its last
    line."""
    import json
    import elemental_tpu.core.environment as env
    calls = []

    class Executor:
        def shutdown(self, cancel_futures=False):
            calls.append("shutdown")

    def start_highs(n1):
        calls.append("highs")
        return Executor(), "future"

    def fail():
        raise RuntimeError("planted failure")

    monkeypatch.setattr(env, "use_compilation_cache",
                        lambda root: str(tmp_path))
    monkeypatch.setattr(chip_smoke, "_gpu_or_exit",
                        lambda count: jax.devices()[:count])
    monkeypatch.setattr(chip_smoke, "_start_highs", start_highs)
    monkeypatch.setattr(chip_smoke, "phase_spmv_cg", fail)
    monkeypatch.setattr(chip_smoke, "phase_lp",
                        lambda highs=None: calls.append(("C", highs)))
    monkeypatch.setattr(chip_smoke, "phase_dense", lambda: calls.append("D"))
    rc = chip_smoke.main(["--phase", "A", "--phase", "C", "--phase", "D"])
    assert rc == 1
    assert calls == ["highs", ("C", "future"), "D", "shutdown"]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": False, "failed": ["A"]}
