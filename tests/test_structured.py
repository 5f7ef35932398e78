"""Structured scatter-free assembly must match the general DIA scatter."""

import jax.numpy as jnp
import jax
import numpy as np
import pytest

from femcy_tpu import assembly
from femcy_tpu.materials import LinearIsotropic
from femcy_tpu.meshgen import box_tets
from femcy_tpu.solvers.dia import build_dia_pattern, dia_scatter
from femcy_tpu.structured import build_structured_plan, structured_dia_scatter
from femcy_tpu.topology import build_pattern


def test_structured_scatter_matches_general():
    mesh = box_tets(3, 4, 2)
    ell = build_pattern(mesh)
    dia = build_dia_pattern(mesh, ell=ell)
    mat = LinearIsotropic(1000.0, 0.3)
    dsdx, vol = assembly.gradients_and_volume(
        jnp.asarray(mesh.nodes),
        jnp.asarray(mesh.elements),
        jnp.asarray(mesh.element.dshape_at_gp),
        jnp.asarray(mesh.element.gauss_weights),
    )
    Ke = assembly.element_stiffness(dsdx, vol, jnp.asarray(mat.C))
    v_ref = dia_scatter(
        Ke, jnp.asarray(dia.scatter_targets), dia.n_dof, dia.n_offsets
    )
    plan = build_structured_plan(mesh, dia)
    v_str = structured_dia_scatter(Ke, plan)
    np.testing.assert_allclose(np.asarray(v_str), np.asarray(v_ref), atol=1e-12)


def test_structured_force_scatter_matches_general():
    import jax

    mesh = box_tets(3, 2, 4)
    from femcy_tpu.materials import LinearIsotropic

    mat = LinearIsotropic(1000.0, 0.3)
    ell = build_pattern(mesh)
    dia = build_dia_pattern(mesh, ell=ell)
    plan = build_structured_plan(mesh, dia)
    rng = np.random.default_rng(0)
    dof = jnp.asarray(0.01 * rng.standard_normal(mesh.n_dof))
    dsdX0, _ = assembly.gradients_and_volume(
        jnp.asarray(mesh.nodes), jnp.asarray(mesh.elements),
        jnp.asarray(mesh.element.dshape_at_gp),
        jnp.asarray(mesh.element.gauss_weights),
    )
    F = assembly.deformation_gradient(dof, jnp.asarray(mesh.elements), dsdX0)
    sigma = assembly.gp_stress(F, mat, large=True)
    coords = jnp.asarray(mesh.nodes) + dof.reshape(-1, 3)
    dsdx, vol = assembly.gradients_and_volume(
        coords, jnp.asarray(mesh.elements),
        jnp.asarray(mesh.element.dshape_at_gp),
        jnp.asarray(mesh.element.gauss_weights),
    )
    f_ref = assembly.internal_force(
        dsdx, sigma, vol, jnp.asarray(ell.force_targets), ell.n_dof
    )
    from femcy_tpu.structured import structured_force_scatter

    f_elem = jnp.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)
    f_str = structured_force_scatter(f_elem, plan, mesh)
    np.testing.assert_allclose(np.asarray(f_str), np.asarray(f_ref), atol=1e-12)


def test_structured_element_nodes_matches_gather():
    from femcy_tpu.structured import structured_element_nodes

    mesh = box_tets(3, 4, 2)
    rng = np.random.default_rng(1)
    vals = rng.standard_normal((mesh.n_nodes, 3))
    ref = vals[mesh.elements]  # the gather the slices replace
    out = np.asarray(structured_element_nodes(jnp.asarray(vals), mesh))
    np.testing.assert_array_equal(out, ref)


def test_pallas_accumulate_matches_xla():
    """The Triton accumulate kernel (Pallas, interpret mode on CPU) equals
    the XLA shifted-slice path to f32 roundoff on a non-cubic box."""
    from femcy_tpu.materials import LinearIsotropic
    from femcy_tpu.solvers.dia import build_structured_dia_pattern
    from femcy_tpu.structured import (
        build_structured_plan,
        structured_assemble_coords,
    )

    mesh = box_tets(4, 3, 5, 2.0, 1.5, 1.0)
    mat = LinearIsotropic(200.0, 0.3)
    dia = build_structured_dia_pattern(mesh)
    plan = build_structured_plan(mesh, dia)
    coords = jnp.asarray(mesh.nodes, jnp.float32)
    dN = jnp.asarray(mesh.element.dshape_at_gp, jnp.float32)
    w = jnp.asarray(mesh.element.gauss_weights, jnp.float32)
    C = jnp.asarray(mat.C, jnp.float32)
    ref = np.asarray(
        structured_assemble_coords(coords, mesh, dN, w, C, plan,
                                   accumulate="xla")
    )
    out = np.asarray(
        structured_assemble_coords(coords, mesh, dN, w, C, plan,
                                   accumulate="triton", interpret=True)
    )
    np.testing.assert_allclose(
        out, ref, rtol=0, atol=1e-5 * np.abs(ref).max()
    )


def test_pallas_assemble_matches_f64_oracle():
    """The kernel-path assembly in f32 (generic 9-term prep) stays at
    roundoff distance from the f64 analytic operator: the kernel path is
    pinned against the exact oracle rather than another f32 path."""
    from femcy_tpu.materials import LinearIsotropic
    from femcy_tpu.solvers.dia import build_structured_dia_pattern
    from femcy_tpu.structured import (
        analytic_structured_dia_values,
        build_structured_plan,
        structured_assemble_coords,
    )

    mesh = box_tets(6, 4, 4, 1.5, 1.0, 1.0)
    mat = LinearIsotropic(1000.0, 0.3)
    dia = build_structured_dia_pattern(mesh)
    plan = build_structured_plan(mesh, dia)
    oracle = analytic_structured_dia_values(mesh, np.asarray(mat.C), dia)
    out = np.asarray(
        structured_assemble_coords(
            jnp.asarray(mesh.nodes, jnp.float32), mesh,
            jnp.asarray(mesh.element.dshape_at_gp, jnp.float32),
            jnp.asarray(mesh.element.gauss_weights, jnp.float32),
            jnp.asarray(mat.C, jnp.float32), plan, accumulate="triton",
            interpret=True,
        )
    )
    err = np.abs(out - oracle).max() / np.abs(oracle).max()
    assert err < 1e-5, err


def test_pallas_isotropic_prep_matches_f64_oracle():
    """The ISOTROPIC 3-term prep (C_host given -- the path FEMSystem and
    the benchmark actually run in production) stays at roundoff distance
    from the f64 analytic operator, like the generic 9-term prep above."""
    from femcy_tpu.materials import LinearIsotropic
    from femcy_tpu.solvers.dia import build_structured_dia_pattern
    from femcy_tpu.structured import (
        analytic_structured_dia_values,
        build_structured_plan,
        structured_assemble_coords,
    )

    mesh = box_tets(6, 4, 4, 1.5, 1.0, 1.0)
    mat = LinearIsotropic(1000.0, 0.3)
    dia = build_structured_dia_pattern(mesh)
    plan = build_structured_plan(mesh, dia)
    oracle = analytic_structured_dia_values(mesh, np.asarray(mat.C), dia)
    out = np.asarray(
        structured_assemble_coords(
            jnp.asarray(mesh.nodes, jnp.float32), mesh,
            jnp.asarray(mesh.element.dshape_at_gp, jnp.float32),
            jnp.asarray(mesh.element.gauss_weights, jnp.float32),
            jnp.asarray(mat.C, jnp.float32), plan, accumulate="triton",
            C_host=np.asarray(mat.C), interpret=True,
        )
    )
    err = np.abs(out - oracle).max() / np.abs(oracle).max()
    assert err < 1e-5, err


def test_matmul_precision_defaults_to_highest():
    """importing femcy_tpu must force full-f32 matmul precision: a reduced
    default (TF32 on an NVIDIA GPU, about three decimal digits) is far
    too coarse for the 0.1% stress accuracy gate."""
    import jax

    assert jax.config.jax_default_matmul_precision == "highest"


def test_system_uses_structured_plan_and_solves():
    from femcy_tpu import FEMSystem, SolverConfig
    from femcy_tpu.materials import LinearIsotropic

    mesh = box_tets(4, 3, 3)
    mat = LinearIsotropic(1000.0, 0.3)
    system = FEMSystem(mesh, mat, geometric_nonlinear=True)
    assert system._structured_plan is not None

    # one Newton evaluation must run through the structured path and give a
    # finite residual
    fixed = np.zeros(mesh.n_dof, bool)
    left = np.nonzero(mesh.nodes[:, 0] < 1e-9)[0]
    for d in range(3):
        fixed[left * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    right = np.nonzero(mesh.nodes[:, 0] > mesh.nodes[:, 0].max() - 1e-9)[0]
    rhs[right * 3 + 1] = 0.5
    dof, values, residual, res, vol = system._jit_newton_eval(
        system._arrs,
        jnp.zeros(mesh.n_dof),
        jnp.asarray(rhs),
        jnp.asarray(fixed),
        jnp.asarray(np.zeros(mesh.n_dof)),
    )
    assert np.isfinite(float(res))

    # and the structured system must agree with a forced-ELL system
    sys_ell = FEMSystem(
        mesh, mat, geometric_nonlinear=True,
        config=SolverConfig(sparse_format="ell"),
    )
    _, _, r2, res2, _ = sys_ell._jit_newton_eval(
        sys_ell._arrs,
        jnp.zeros(mesh.n_dof),
        jnp.asarray(rhs),
        jnp.asarray(fixed),
        jnp.asarray(np.zeros(mesh.n_dof)),
    )
    np.testing.assert_allclose(float(res), float(res2), rtol=1e-12)


def test_auto_chooser_never_interprets_off_gpu():
    """Off-GPU the auto chooser takes the XLA path (no pallas_call in the
    program), and forcing the kernel without interpret=True raises instead
    of silently running the interpreter."""
    import jax

    from femcy_tpu.materials import LinearIsotropic
    from femcy_tpu.solvers.dia import build_structured_dia_pattern
    from femcy_tpu.structured import (
        build_structured_plan,
        kernel_assembly_eligible,
        structured_assemble_coords,
    )

    mesh = box_tets(2, 2, 2)
    mat = LinearIsotropic(1000.0, 0.3)
    plan = build_structured_plan(mesh, build_structured_dia_pattern(mesh))
    args = (jnp.asarray(mesh.nodes, jnp.float32), mesh,
            jnp.asarray(mesh.element.dshape_at_gp, jnp.float32),
            jnp.asarray(mesh.element.gauss_weights, jnp.float32),
            jnp.asarray(mat.C, jnp.float32), plan)
    assert jax.default_backend() == "cpu"
    assert not kernel_assembly_eligible(mesh, jnp.float32)
    jaxpr = str(jax.make_jaxpr(
        lambda c: structured_assemble_coords(c, *args[1:],
                                             C_host=np.asarray(mat.C))
    )(args[0]))
    assert "pallas_call" not in jaxpr
    with pytest.raises(ValueError, match="GPU"):
        structured_assemble_coords(*args, accumulate="triton")
    with pytest.raises(ValueError, match="unknown"):
        structured_assemble_coords(*args, accumulate="pallas")
