"""chip_smoke.py on the CPU: its gates at tiny sizes, and its device guard.

The phases run here at nx=4-8 through the same code the GPU run takes at
full size (the native pattern build and the XLA paths run on the CPU); the
script itself must refuse to run without a GPU.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse as sp

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def test_device_guard_exits_nonzero_on_cpu():
    with pytest.raises(SystemExit) as exc:
        chip_smoke.phase_device()
    assert exc.value.code != 0


def test_script_fails_without_gpu_and_prints_no_result():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], env=env,
        capture_output=True, text=True, timeout=120, cwd=REPO,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr


def test_check_prints_error_beside_limit(capsys):
    assert chip_smoke.check("demo", 1e-6, 1e-5) == 1e-6
    assert "1.000e-06 <= 1.0e-05 OK" in capsys.readouterr().out
    with pytest.raises(chip_smoke.GateFailed):
        chip_smoke.check("demo", 2e-5, 1e-5)
    with pytest.raises(chip_smoke.GateFailed):
        chip_smoke.check("demo", float("nan"), 1e-5)


@pytest.mark.parametrize("sparse", [False, True])
def test_operator_error(sparse):
    rng = np.random.default_rng(0)
    ref = rng.standard_normal((6, 6))
    dev = ref + 1e-7 * np.abs(ref).max() * np.eye(6)
    if sparse:
        ref, dev = sp.csr_matrix(ref), sp.csr_matrix(dev)
    err = chip_smoke.operator_error(dev, ref)
    assert 0.5e-7 < err < 2e-7


def test_residual_error_is_relative_inf_norm():
    K = sp.diags([2.0, 4.0])
    assert chip_smoke.residual_error(K, [1.0, 1.0], [2.0, 4.0]) == 0.0
    assert chip_smoke.residual_error(K, [1.0, 1.1], [2.0, 4.0]) == (
        pytest.approx(0.1)
    )


@pytest.fixture(scope="module")
def box4():
    import jax.numpy as jnp

    import bench

    return bench.box_cell(4, jnp.float32)


def test_structured_gates_pass_and_catch_a_wrong_solution(box4):
    raw, _, K64, b64 = chip_smoke.structured_reference(
        box4.mesh, box4.material, box4.dia, box4.fixed, box4.rhs)
    vals = box4.assemble(box4.arrs)
    assert chip_smoke.operator_error(vals, raw) <= chip_smoke.OPERATOR_TOL
    x, _, _ = box4.run()
    assert chip_smoke.residual_error(K64, x, b64) <= 2e-3
    wrong = np.asarray(x) * 1.01
    assert chip_smoke.residual_error(K64, wrong, b64) > 2e-3
    assert chip_smoke.operator_error(np.asarray(vals) * 1.001, raw) > 1e-5


def test_structured_phase_runs_at_nx4():
    chip_smoke.phase_structured(nx=4)


def test_unstructured_phase_runs_at_nx4():
    chip_smoke.phase_unstructured(nx=4)


def test_kernel_phase_runs_at_small_widths():
    chip_smoke.phase_kernels(nx=4, unstructured_nx=4, run_tier=False)


def test_nonlinear_phase_and_equilibrium_gate():
    system, inp, report, _, _ = chip_smoke.solve_bending(
        (8, 4, 4), preconditioner="multigrid", linear_solver="cg")
    assert report.success
    fixed = np.zeros(system.mesh.n_dof, bool)
    for bc in inp.dirichlet_bcs:
        fixed[np.asarray(bc.node_set) * 3 + bc.dof] = True
    f_ext = chip_smoke.external_force(system.mesh, inp)
    err = chip_smoke.equilibrium_error(system.mesh, system.material,
                                       system.dof, f_ext, fixed)
    assert err <= system.config.newton_rel_tol
    # the undeformed state is far from equilibrium under the full load
    assert chip_smoke.equilibrium_error(
        system.mesh, system.material, np.zeros(system.mesh.n_dof), f_ext,
        fixed) > 0.5


def test_last_line_shape(monkeypatch, capsys):
    """main() ends with exactly the contract's JSON line."""
    # main() pins f32 for its own process; restore this worker's setting
    monkeypatch.setenv("FEMCY_TPU_X64", os.environ.get("FEMCY_TPU_X64", "1"))

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(chip_smoke, "phase_device", lambda multichip: Dev())
    for name in ("phase_kernels", "phase_structured", "phase_unstructured",
                 "phase_nonlinear"):
        monkeypatch.setattr(chip_smoke, name, lambda: None)
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    got = json.loads(last)
    assert got["ok"] is True
    assert got["device"]["platform"] == "gpu"
    assert set(got["device"]) == {"platform", "kind", "count"}
