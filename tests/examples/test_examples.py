"""Every example driver doubles as an integration test (reference pattern:
``examples/`` are self-verifying drivers for the application tiers)."""

import importlib.util
import os
import sys

import pytest

EXDIR = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                     "examples"))

DRIVERS = ["bp", "bpdn", "lav", "cp", "ds", "en", "nnls", "svm", "tv",
           "lp_affine", "qp_direct_ex", "socp_trivial",
           "long_only_portfolio", "least_squares", "linear_solve", "eig",
           "fox_li", "different_grids", "sparse_multiply",
           # second wave of ports
           "glm", "lse", "tikhonov_ex", "rls", "soc_atom",
           "pseudospectra_portrait", "control_ex", "triang_eig_ex",
           "pnorm", "symmetric_solve_ex", "inv_pos", "simple_solve",
           "remote_update", "lattice_tools", "gepp_growth",
           "product_lanczos_ex", "matrix_zoo", "dynamic_reg_counter",
           # third wave of ports
           "rnnls_ex", "bp_complex", "qp_affine_ex", "soc_members", "lcf",
           "remote_dist_sparse", "multiply_ex", "sequential_least_squares",
           "sequential_linear_solve", "sequential_lse", "lll_singular",
           "bp_dense", "bpdn_dense", "cp_dense", "ds_dense", "en_dense",
           "lav_dense", "lp_direct_dense", "lp_affine_dense", "nnls_dense",
           "qp_direct_dense", "qp_affine_dense", "svm_dense"]


@pytest.mark.parametrize("name", DRIVERS)
def test_example_driver(name, monkeypatch):
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    monkeypatch.syspath_prepend(EXDIR)
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", os.path.join(EXDIR, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main()
