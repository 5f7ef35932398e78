"""On-card kernel/solver checks (the ``gpu`` tier).

Every other test in this suite runs on the virtual-device CPU mesh
(conftest.py).  This module runs the hot kernels and solver paths on a real
NVIDIA GPU, compiled for the card, in f32:

    FEMCY_TEST_GPU=1 FEMCY_TPU_X64=0 python -m pytest -m gpu tests/test_gpu.py

chip_smoke.py runs exactly that in its kernel phase.  Elsewhere every test
here skips through the ``gpu_device`` fixture, which decides at run time.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu_device")]

F32 = jnp.float32
RTOL = 1e-4  # f32 kernel-vs-kernel agreement


@pytest.fixture(scope="module")
def structured16():
    from femcy_tpu.meshgen import box_tets
    from femcy_tpu.solvers.dia import build_structured_dia_pattern

    mesh = box_tets(16, 16, 16)
    dia = build_structured_dia_pattern(mesh)
    return mesh, dia


@pytest.fixture(scope="module")
def material():
    from femcy_tpu.materials import LinearIsotropic

    return LinearIsotropic(modulus=1000.0, poisson_ratio=0.3)


@pytest.fixture(scope="module")
def analytic16(structured16, material):
    from femcy_tpu.structured import analytic_structured_dia_values

    mesh, dia = structured16
    return analytic_structured_dia_values(mesh, np.asarray(material.C), dia)


@pytest.mark.parametrize(
    "accumulate,isotropic",
    [("triton", True), ("triton", False), ("xla", False)],
)
def test_structured_assembly_matches_analytic(
    structured16, material, analytic16, accumulate, isotropic
):
    """structured_assemble_coords -- the Triton accumulate with the
    isotropic 3-term or the generic 9-term prep, and the XLA shifted-slice
    accumulate -- vs the closed-form f64 operator of the uniform grid."""
    from femcy_tpu.structured import (
        build_structured_plan,
        structured_assemble_coords,
    )

    mesh, dia = structured16
    plan = build_structured_plan(mesh, dia)
    coords = jnp.asarray(mesh.nodes, F32)
    dN = jnp.asarray(mesh.element.dshape_at_gp, F32)
    w = jnp.asarray(mesh.element.gauss_weights, F32)
    C32 = jnp.asarray(material.C, F32)
    C_host = np.asarray(material.C) if isotropic else None
    vals = np.asarray(
        jax.jit(
            lambda c: structured_assemble_coords(
                c, mesh, dN, w, C32, plan, accumulate=accumulate,
                C_host=C_host,
            )
        )(coords)
    ).astype(np.float64)
    err = np.abs(vals - analytic16).max() / np.abs(analytic16).max()
    assert err < RTOL, err


def test_triton_spmv_matches_xla_slices(structured16, analytic16):
    """The Triton DIA SpMV vs XLA's shifted-slice SpMV on random input over
    the full 59-offset operator."""
    from femcy_tpu.kernels.dia_spmv import make_spmv
    from femcy_tpu.solvers.dia import dia_spmv

    mesh, dia = structured16
    prep, apply_fn = make_spmv(mesh.n_dof, dia.offsets)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.standard_normal(mesh.n_dof), F32)
    v32 = jnp.asarray(analytic16.astype(np.float32))
    y_k = np.asarray(jax.jit(lambda v, xx: apply_fn(prep(v), xx))(v32, x))
    y_x = np.asarray(
        jax.jit(lambda v, xx: dia_spmv(v, dia.offsets, xx))(v32, x)
    )
    err = np.abs(y_k - y_x).max() / (np.abs(y_x).max() + 1e-30)
    assert err < RTOL, err


def test_dia_pcg_solves_structured_operator(structured16, analytic16):
    """The DIA Jacobi-PCG (lax.while_loop, Triton SpMV inside) reaches its
    residual gate on the BC-eliminated operator."""
    from femcy_tpu.kernels.dia_spmv import make_spmv
    from femcy_tpu.solvers.dia import dia_dirichlet_linear, dia_pcg_solve

    mesh, dia = structured16
    fixed = np.zeros(mesh.n_dof, dtype=bool)
    bottom = np.nonzero(mesh.nodes[:, 2] < 1e-9)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    top = np.nonzero(mesh.nodes[:, 2] > mesh.nodes[:, 2].max() - 1e-9)[0]
    rhs[top * 3] = 1.0
    values_bc, b = jax.jit(
        lambda v, r, f, s: dia_dirichlet_linear(
            v, dia.offsets, dia.diag_idx, r, f, s
        )
    )(
        jnp.asarray(analytic16.astype(np.float32)),
        jnp.asarray(rhs, F32), jnp.asarray(fixed),
        jnp.zeros(mesh.n_dof, F32),
    )
    x, iters, rmax = jax.jit(
        lambda v, bb: dia_pcg_solve(v, dia.offsets, dia.diag_idx, bb,
                                    eps=1e-4,
                                    spmv=make_spmv(mesh.n_dof, dia.offsets))
    )(values_bc, b)
    x = np.asarray(x)
    assert np.isfinite(x).all() and np.abs(x).max() > 0
    r0 = float(np.abs(np.asarray(b)).max())
    assert float(rmax) < 1e-4 * r0, (int(iters), float(rmax), r0)


@pytest.fixture(scope="module")
def unstructured10(material):
    """General ELL path fixture: pattern + assembled BC-eliminated values."""
    from femcy_tpu import assembly
    from femcy_tpu import bc as bc_mod
    from femcy_tpu.meshgen import unstructured_box_tets
    from femcy_tpu.topology import build_pattern

    mesh = unstructured_box_tets(10)
    pattern = build_pattern(mesh)
    nodes = jnp.asarray(mesh.nodes, F32)
    dN = jnp.asarray(mesh.element.dshape_at_gp, F32)
    w = jnp.asarray(mesh.element.gauss_weights, F32)
    C = jnp.asarray(material.C, F32)
    dsdx, vol = assembly.gradients_and_volume(
        nodes, jnp.asarray(mesh.elements), dN, w
    )
    Ke = assembly.element_stiffness(dsdx, vol, C)
    values = assembly.scatter_stiffness(
        Ke, jnp.asarray(pattern.ensure_scatter_targets()),
        mesh.n_dof, pattern.width,
    )
    fixed = np.zeros(mesh.n_dof, dtype=bool)
    bot = np.nonzero(mesh.nodes[:, 2] < 1e-9)[0]
    for d in range(3):
        fixed[bot * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    top = np.nonzero(mesh.nodes[:, 2] > mesh.nodes[:, 2].max() - 1e-9)[0]
    rhs[top * 3] = 1.0
    values_bc, b = bc_mod.apply_dirichlet_linear(
        values, jnp.asarray(pattern.colidx), jnp.asarray(pattern.diag_slot),
        jnp.asarray(rhs, F32), jnp.asarray(fixed),
        jnp.zeros(mesh.n_dof, F32),
    )
    return mesh, pattern, values_bc, b, fixed


def test_general_assembly_matches_host_f64(unstructured10, material):
    """The batched-einsum + segment-sum device assembly (f32, general ELL
    path) against the exactly-assembled f64 host twin."""
    from femcy_tpu import assembly_host

    mesh, pattern, values_bc, b, fixed = unstructured10
    A_dev = pattern.to_scipy(np.asarray(values_bc, dtype=np.float64))
    K = assembly_host.assemble_csr_host(
        mesh, pattern, np.asarray(material.C)
    )
    zeros = np.zeros(mesh.n_dof)
    K_bc, _ = assembly_host.dirichlet_csr_host(
        K, zeros, np.asarray(fixed), zeros
    )
    diff = np.abs((A_dev - K_bc).toarray()).max()
    scale = np.abs(K_bc.toarray()).max()
    assert diff / scale < 5e-6, diff / scale


def test_bell_spmv_matches_ell(unstructured10):
    """The block-ELL vector-row SpMV (solvers/bell.py, the AMG fine-level
    workhorse) vs the scalar dof-ELL SpMV."""
    from femcy_tpu.solvers.bell import bell_from_ell, bell_spmv, build_bell_plan
    from femcy_tpu.solvers.cg import ell_spmv

    mesh, pattern, values_bc, b, fixed = unstructured10
    plan = build_bell_plan(pattern, mesh.dm)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.standard_normal(mesh.n_dof), F32)

    def both(values, xx):
        bv = bell_from_ell(values, plan)
        return bell_spmv(bv, jnp.asarray(plan.ncol), xx), ell_spmv(
            values, jnp.asarray(pattern.colidx), xx
        )

    y_bell, y_ell = jax.jit(both)(values_bc, x)
    err = np.abs(np.asarray(y_bell) - np.asarray(y_ell)).max() / (
        np.abs(np.asarray(y_ell)).max() + 1e-30
    )
    assert err < RTOL, err


def test_ell_pcg_matches_host_direct(unstructured10):
    """The general ELL Jacobi-PCG on chip vs the host f64 direct solve."""
    import scipy.sparse.linalg as spla

    from femcy_tpu.solvers.cg import pcg_solve

    mesh, pattern, values_bc, b, fixed = unstructured10
    x, iters, rmax = jax.jit(
        lambda v, bb: pcg_solve(
            v, jnp.asarray(pattern.colidx), jnp.asarray(pattern.diag_slot),
            bb, eps=1e-5,
        )
    )(values_bc, b)
    A = pattern.to_scipy(np.asarray(values_bc, dtype=np.float64))
    x_ref = spla.spsolve(A.tocsc(), np.asarray(b, dtype=np.float64))
    err = np.abs(np.asarray(x) - x_ref).max() / np.abs(x_ref).max()
    assert err < 5e-3, (err, int(iters))  # f32 CG at a 1e-5 inf-norm gate


def test_amg_pcg_on_device_matches_host_direct(unstructured10, material):
    """SolverConfig(preconditioner='amg') end-to-end on the chip: hierarchy
    from the device operator, bell-layout V-cycle, f32 PCG."""
    import scipy.sparse.linalg as spla

    from femcy_tpu import FEMSystem, SolverConfig

    mesh, pattern, values_bc, b, fixed = unstructured10
    system = FEMSystem(
        mesh, material, False,
        SolverConfig(preconditioner="amg", linear_solver="cg", cg_eps=1e-5),
    )
    x = system._solve_linear_system(values_bc, b, jnp.asarray(fixed))
    A = pattern.to_scipy(np.asarray(values_bc, dtype=np.float64))
    x_ref = spla.spsolve(A.tocsc(), np.asarray(b, dtype=np.float64))
    err = np.abs(np.asarray(x) - x_ref).max() / np.abs(x_ref).max()
    assert err < 5e-3, (err, system._last_cg_iters)


def test_consistent_tangent_equals_secant_at_reference_config(
    unstructured10, material
):
    """At dof=0 (F=I) the autodiff consistent tangent of the linear
    material must equal the secant stiffness -- an on-chip check of the
    per-element JVP kernels."""
    from femcy_tpu import assembly

    mesh, pattern, values_bc, b, fixed = unstructured10
    nodes = jnp.asarray(mesh.nodes, F32)
    dN = jnp.asarray(mesh.element.dshape_at_gp, F32)
    w = jnp.asarray(mesh.element.gauss_weights, F32)
    C = jnp.asarray(material.C, F32)

    def both(dof):
        Ke_c = assembly.consistent_tangent(
            dof, jnp.asarray(mesh.elements), nodes, dN, w, material
        )
        # dof == 0: the current configuration IS the reference one
        dsdx, vol = assembly.gradients_and_volume(
            nodes, jnp.asarray(mesh.elements), dN, w
        )
        Ke_s = assembly.element_stiffness(dsdx, vol, C)
        return Ke_c, Ke_s

    Ke_c, Ke_s = jax.jit(both)(jnp.zeros(mesh.n_dof, F32))
    err = np.abs(np.asarray(Ke_c) - np.asarray(Ke_s)).max() / (
        np.abs(np.asarray(Ke_s)).max() + 1e-30
    )
    assert err < 1e-3, err


def test_internal_force_invariants_on_chip(unstructured10, material):
    """Internal force at dof=0 vanishes; under a rigid translation it stays
    zero; its free-body sum vanishes under a random smooth field."""
    from femcy_tpu import FEMSystem, SolverConfig

    mesh, pattern, values_bc, b, fixed = unstructured10

    system = FEMSystem(
        mesh, material, True, SolverConfig(tangent="consistent")
    )
    zeros = jnp.zeros(mesh.n_dof, F32)
    free = jnp.zeros(mesh.n_dof, dtype=bool)  # no constraints: free body
    _, _, _, _, _, f0 = system._internal_force_parts(
        system._arrs, zeros, free, zeros
    )
    scale = float(np.abs(np.asarray(values_bc)).max())
    assert float(jnp.abs(f0).max()) < 1e-5 * scale
    # rigid translation: F stays I, zero force
    trans = jnp.tile(jnp.asarray([0.3, -0.2, 0.1], F32), mesh.n_nodes)
    _, _, _, _, _, f1 = system._internal_force_parts(
        system._arrs, trans, free, trans
    )
    assert float(jnp.abs(f1).max()) < 1e-4 * scale
    # smooth deformation: the free-body resultant vanishes
    defo = jnp.asarray(
        0.05 * np.sin(np.pi * mesh.nodes) .reshape(-1), F32
    )
    _, _, _, _, _, f2 = system._internal_force_parts(
        system._arrs, defo, free, defo
    )
    resultant = jnp.abs(jnp.sum(f2.reshape(-1, 3), axis=0))
    assert float(resultant.max()) < 1e-3 * float(jnp.abs(f2).max())
