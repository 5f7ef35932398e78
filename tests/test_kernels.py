"""Triton DIA SpMV kernel tests (Pallas interpret mode on the CPU backend).

The kernel replaces XLA's shifted-slice SpMV inside the CG on a GPU in f32
(kernels/dia_spmv.py; both times in PERF.md).  Here it is pinned exact
against the XLA path on real structured operators, and its chooser is
pinned to refuse running off-GPU outside interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from femcy_tpu.kernels.dia_spmv import (
    kernel_available,
    make_spmv,
    prep_values,
    spmv,
    spmv_plan,
)
from femcy_tpu.materials import LinearIsotropic
from femcy_tpu.meshgen import box_tets
from femcy_tpu.solvers.dia import (
    build_structured_dia_pattern,
    dia_pcg_solve,
    dia_spmv,
)
from femcy_tpu.structured import (
    analytic_structured_dia_values,
    dia_dirichlet_linear_numpy,
)


def _operator(nx):
    mesh = box_tets(nx, nx, nx)
    dia = build_structured_dia_pattern(mesh)
    vals = analytic_structured_dia_values(
        mesh, LinearIsotropic(1000.0, 0.3).C, dia
    )
    fixed = np.zeros(mesh.n_dof, bool)
    bottom = np.nonzero(mesh.nodes[:, 2] < 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    vals = dia_dirichlet_linear_numpy(vals, dia.offsets, dia.diag_idx, fixed)
    return mesh, dia, vals, fixed


@pytest.mark.parametrize("nx", [3, 5])
def test_pallas_spmv_exact_vs_slices(nx):
    mesh, dia, vals, _ = _operator(nx)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(mesh.n_dof), jnp.float32)
    v32 = jnp.asarray(vals, jnp.float32)
    y_ref = dia_spmv(v32, dia.offsets, x)

    plan = spmv_plan(mesh.n_dof, dia.offsets, interpret=True)
    assert plan.n_pad % plan.block == 0 and plan.n_pad >= mesh.n_dof
    y = spmv(plan, prep_values(plan, v32), x)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(y_ref), rtol=0,
        atol=1e-5 * float(jnp.abs(y_ref).max()),
    )


@pytest.mark.parametrize("block", [128, 256])
def test_spmv_padding_covers_partial_last_block(block):
    """n not a multiple of the block: padded rows are cut off, the shifted
    windows of the last block stay inside the padded x."""
    mesh, dia, vals, _ = _operator(3)
    plan = spmv_plan(mesh.n_dof, dia.offsets, interpret=True, block=block)
    assert mesh.n_dof % block != 0
    assert plan.x_len == plan.n_pad + plan.pad_lo + max(dia.offsets)
    vt = prep_values(plan, jnp.asarray(vals, jnp.float32))
    assert vt.shape == (dia.n_offsets, plan.n_pad)
    assert float(jnp.abs(vt[:, mesh.n_dof:]).max()) == 0.0
    x = jnp.ones(mesh.n_dof, jnp.float32)
    y = spmv(plan, vt, x)
    assert y.shape == (mesh.n_dof,)
    np.testing.assert_allclose(
        np.asarray(y), np.asarray(dia_spmv(jnp.asarray(vals, jnp.float32),
                                           dia.offsets, x)),
        rtol=0, atol=1e-5 * np.abs(vals).sum(axis=1).max(),
    )


def test_pcg_with_pallas_spmv_matches(nx=4):
    mesh, dia, vals, fixed = _operator(nx)
    rng = np.random.default_rng(1)
    b = jnp.asarray(
        np.where(fixed, 0.0, rng.standard_normal(mesh.n_dof)), jnp.float32
    )
    v32 = jnp.asarray(vals, jnp.float32)
    x_ref, it_ref, _ = dia_pcg_solve(v32, dia.offsets, dia.diag_idx, b)
    spmv_pair = make_spmv(mesh.n_dof, dia.offsets, interpret=True)
    x, it, _ = dia_pcg_solve(v32, dia.offsets, dia.diag_idx, b,
                             spmv=spmv_pair)
    scale = float(jnp.abs(x_ref).max())
    np.testing.assert_allclose(
        np.asarray(x) / scale, np.asarray(x_ref) / scale, atol=2e-5
    )


def test_multigrid_pcg_with_pallas_spmv(nx=8):
    from femcy_tpu.solvers.multigrid import StructuredMultigrid

    mesh, dia, vals, fixed = _operator(nx)
    mat = LinearIsotropic(1000.0, 0.3)
    mg = StructuredMultigrid(
        mesh, mat, fixed, dia=dia, coarsest_max_dof=400
    )
    rng = np.random.default_rng(2)
    b = jnp.asarray(
        np.where(fixed, 0.0, rng.standard_normal(mesh.n_dof)), jnp.float32
    )
    v32 = jnp.asarray(vals, jnp.float32)
    # the GPU f32 run builds the whole hierarchy in f32; the test backend
    # builds it in f64, so cast the level operands down
    ops = jax.tree.map(
        lambda a: a.astype(jnp.float32)
        if hasattr(a, "dtype") and a.dtype == jnp.float64
        else a,
        mg.operands(),
    )
    x_ref, _, _ = mg.pcg_solve(v32, b, eps=1e-5, ops=ops)
    spmv_pair = make_spmv(mesh.n_dof, dia.offsets, interpret=True)
    x, _, _ = mg.pcg_solve(v32, b, eps=1e-5, ops=ops, spmv=spmv_pair)
    scale = float(jnp.abs(x_ref).max())
    np.testing.assert_allclose(
        np.asarray(x) / scale, np.asarray(x_ref) / scale, atol=1e-4
    )


def test_make_spmv_chooser():
    mesh, dia, _, _ = _operator(3)
    assert jax.default_backend() == "cpu"
    # off-GPU the auto choosers keep XLA's shifted slices ...
    assert not kernel_available(jnp.float32)
    # ... and asking for the kernel without interpret mode raises
    with pytest.raises(ValueError, match="GPU"):
        make_spmv(mesh.n_dof, dia.offsets)
    assert make_spmv(mesh.n_dof, dia.offsets, interpret=True) is not None


def test_system_spmv_option_off_gpu():
    """FEMSystem: spmv='auto' keeps XLA off-GPU, 'triton' raises there."""
    from femcy_tpu import FEMSystem, SolverConfig

    mesh = box_tets(2, 2, 2)
    mat = LinearIsotropic(1000.0, 0.3)
    sys_auto = FEMSystem(mesh, mat, False, SolverConfig(linear_solver="cg"))
    assert sys_auto.dia is not None and sys_auto._spmv is None
    with pytest.raises(ValueError, match="GPU"):
        FEMSystem(mesh, mat, False, SolverConfig(spmv="triton"))
    with pytest.raises(ValueError, match="unknown"):
        FEMSystem(mesh, mat, False, SolverConfig(spmv="pallas"))
