"""Test configuration: CPU with 8 virtual devices, unless the GPU tier is
asked for.

Sharding tests need a multi-device mesh; we emulate 8 devices on the host
CPU (the standard JAX pattern for testing pjit/shard_map programs).

The ``gpu`` tier (tests/test_gpu.py) runs on a real card:

    FEMCY_TEST_GPU=1 FEMCY_TPU_X64=0 python -m pytest -m gpu tests/test_gpu.py

With FEMCY_TEST_GPU=1 this file leaves JAX's platform alone; each GPU test
decides inside its ``gpu_device`` fixture whether a card is present, so
every worker collects the same tests.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

if os.environ.get("FEMCY_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")

import pathlib  # noqa: E402

import pytest  # noqa: E402

REFERENCE_TESTS = pathlib.Path("/root/reference/tests")


@pytest.fixture(scope="session")
def fixtures_dir() -> pathlib.Path:
    if not REFERENCE_TESTS.exists():
        pytest.skip("reference fixture directory not available")
    return REFERENCE_TESTS


# ---------------------------------------------------------------------------
# Test tiering.  The full suite takes ~47 minutes on this host (most of it
# XLA compiles of the heavyweight e2e analyses); the names below are the
# measured long-runners (pytest --durations, 2026-08-19).  They get the
# ``slow`` marker at collection time so the default developer loop is
#
#     pytest -m "not slow"       # quick tier, ~2 minutes
#     pytest                     # everything (CI / pre-round)
#
# Matching is by bare test-function name (parametrized variants inherit).
_SLOW_TESTS = frozenset({
    # >100 s
    "test_twist_c3d10_full_180deg_with_dynamic_rescue",
    "test_graft_entry_contract",
    "test_twist_c3d10_full_mesh_90deg",
    # 10-60 s
    "test_mg_iteration_count_mesh_independent",
    "test_riks_finds_cook_625_limit_point",
    "test_system_multigrid_in_newton_path",
    "test_cook_5mpa_converges_with_consistent_tangent",
    "test_femsystem_sharded_nonlinear_end_to_end_matches_single_device",
    "test_sharded_structured_nonzero_dirichlet",
    "test_sharded_structured_matches_single_device",
    "test_system_multigrid_preconditioner_matches_direct",
    "test_sharded_structured_program_has_no_gather",
    "test_sharded_matches_direct",
    "test_sharded_padded_rows_are_inert",
    "test_sharded_multigrid_matches_and_cuts_iterations",
    "test_beam_mesh_convergence",
    "test_femsystem_sharded_linear_matches_single_device",
    "test_banded_sharding_e2e_nonlinear_via_femsystem",
    "test_banded_consistent_tangent_matches_single_device",
    "test_slab_consistent_tangent_matches_single_device",
    "test_banded_neumann_rhs_and_device_counts",
    "test_fused_newton_dense_cg_e2e",
    "test_cutback_parity",
    "test_mg_pcg_matches_jacobi_and_is_fast",
    "test_matches_host_loop",
    "test_multiblock_dynamic_rescue",
    "test_dynamic_rescue_under_banded_sharding",
    "test_mixed_precision_refine_near_incompressible",
    "test_fused_newton_matches_default",
    "test_abort_message_reports_element_inversion",
    "test_banded_matches_direct",
    "test_dynamic_rescue_crosses_and_completes",
    "test_twist_plate_user_rotation_bc",
    "test_hex8_matches_tets_on_bending",
    "test_mixed_precision_refine_nonlinear_newton",
    "test_newton_refine_respects_stabilization",
    "test_diagnose_failure_opt_out",
    "test_riks_matches_newton_on_stable_path",
    "test_beam_large_deformation_consistent_tangent_agrees",
    # 4-120 s (measured on the first quick-tier pass)
    "test_cli_failure_exit_code",
    "test_stabilized_sharded_matches_single_device",
    "test_sharded_device_counts",
    "test_sharded_newton_step_matches_single_device",
    "test_system_uses_structured_plan_and_solves",
    "test_wedge6_matches_hexes_on_bending",
    "test_multigrid_level_values_match_rediscretization",
    "test_amg_iteration_count_mesh_independent",
    "test_cli_end_to_end",
    "test_stabilized_beam_matches_unstabilized",
    "test_chebyshev_smoother_converges",
    "test_nonlinear_single_block_matches_femsystem",
    "test_amg_pcg_matches_direct_and_iterations_bounded",
    "test_wedge6_patch_test_exact",
    "test_banded_on_reference_inp_fixture",
    "test_dense_pcg_matches_sparse_pcg",
    "test_mixed_type_patch_test",
    "test_hex8_patch_test_exact",
    "test_cook_nu4999_cg_needs_more_than_ndof_iters",
    "test_tangent_eig_after_converged_solve",
    "test_analytic_values_match_rediscretization",
    "test_nonlinear_neo_hookean_steel_sandwich",
    "test_multiblock_cg_matches_direct",
    "test_checkpoint_resume_continues",
    "test_cli_f32_mode",
    "test_c3d8_inp_roundtrip",
})


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.originalname in _SLOW_TESTS or item.name in _SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture(scope="session")
def gpu_device():
    """The first GPU device; skips (decided at run time) when there is none."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with FEMCY_TEST_GPU=1 on the card)")
    return jax.devices()[0]
