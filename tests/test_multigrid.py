"""Geometric multigrid preconditioner (structured meshes, beyond-parity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from femcy_tpu import assembly
from femcy_tpu.materials import LinearIsotropic
from femcy_tpu.meshgen import box_tets
from femcy_tpu.solvers.dia import (
    build_dia_pattern,
    dia_dirichlet_linear,
    dia_pcg_solve,
)
from femcy_tpu.solvers.multigrid import (
    StructuredMultigrid,
    prolong,
    restrict,
)
from femcy_tpu.structured import build_structured_plan, structured_assemble
from femcy_tpu.topology import build_pattern


def _problem(nx):
    mesh = box_tets(nx, nx, nx)
    mat = LinearIsotropic(1000.0, 0.3)
    fixed = np.zeros(mesh.n_dof, bool)
    bottom = np.nonzero(mesh.nodes[:, 2] < 1e-12)[0]
    top = np.nonzero(mesh.nodes[:, 2] > 1 - 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    rhs[top * 3] = 1.0

    ell = build_pattern(mesh)
    dia = build_dia_pattern(mesh, ell=ell)
    plan = build_structured_plan(mesh, dia)
    dsdx, vol = assembly.gradients_and_volume(
        jnp.asarray(mesh.nodes),
        jnp.asarray(mesh.elements),
        jnp.asarray(mesh.element.dshape_at_gp),
        jnp.asarray(mesh.element.gauss_weights),
    )
    values = structured_assemble(dsdx, vol, jnp.asarray(mat.C), plan)
    values_bc, b = dia_dirichlet_linear(
        values, dia.offsets, dia.diag_idx, jnp.asarray(rhs), jnp.asarray(fixed),
        jnp.zeros(mesh.n_dof),
    )
    return mesh, mat, fixed, dia, values_bc, b


def test_prolong_restrict_are_transposes():
    """<P u_c, v_f> == <u_c, R v_f> for random vectors (R = P^T exactly)."""
    rng = np.random.default_rng(0)
    gc = (4, 2, 6)
    gf = tuple(2 * d for d in gc)
    nc = 3 * np.prod([d + 1 for d in gc])
    nf = 3 * np.prod([d + 1 for d in gf])
    u = jnp.asarray(rng.standard_normal(nc))
    v = jnp.asarray(rng.standard_normal(nf))
    lhs = float(jnp.dot(prolong(u, gc), v))
    rhs = float(jnp.dot(u, restrict(v, gf)))
    np.testing.assert_allclose(lhs, rhs, rtol=1e-12)


def test_prolong_preserves_constants_in_interior():
    gc = (4, 4, 4)
    u = jnp.ones(3 * 5 * 5 * 5)
    uf = prolong(u, gc)
    np.testing.assert_allclose(np.asarray(uf), 1.0, atol=1e-12)


def test_mg_pcg_matches_jacobi_and_is_fast():
    mesh, mat, fixed, dia, values_bc, b = _problem(16)
    x_j, it_j, _ = dia_pcg_solve(values_bc, dia.offsets, dia.diag_idx, b, eps=1e-8)
    mg = StructuredMultigrid(mesh, mat, fixed)
    assert len(mg.levels) >= 2
    x_m, it_m, _ = mg.pcg_solve(values_bc, b, eps=1e-8)
    scale = np.abs(np.asarray(x_j)).max()
    np.testing.assert_allclose(
        np.asarray(x_m) / scale, np.asarray(x_j) / scale, atol=1e-6
    )
    # textbook multigrid: ~order-of-magnitude fewer iterations than Jacobi
    assert int(it_m) < int(it_j) / 5


def test_mg_iteration_count_mesh_independent():
    its = []
    for nx in (16, 32):
        mesh, mat, fixed, dia, values_bc, b = _problem(nx)
        mg = StructuredMultigrid(mesh, mat, fixed)
        _, it, _ = mg.pcg_solve(values_bc, b, eps=1e-8)
        its.append(int(it))
    # 8x the elements, essentially constant iterations (measured 13 -> 14),
    # unlike Jacobi-PCG which roughly doubles (357 -> 691)
    assert its[1] <= its[0] + 6


def test_mg_rejects_odd_grids():
    mesh = box_tets(7, 7, 7)
    mat = LinearIsotropic(1000.0, 0.3)
    with pytest.raises(ValueError):
        StructuredMultigrid(mesh, mat, np.zeros(mesh.n_dof, bool),
                            coarsest_max_dof=100)


def test_system_multigrid_preconditioner_matches_direct():
    """FEMSystem with preconditioner='multigrid' solves through the V-cycle
    CG and agrees with the direct solver."""
    import jax.numpy as jnp

    from femcy_tpu import FEMSystem, SolverConfig

    mesh = box_tets(8, 8, 8)
    mat = LinearIsotropic(1000.0, 0.3)
    fixed = np.zeros(mesh.n_dof, bool)
    bottom = np.nonzero(mesh.nodes[:, 2] < 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    top = np.nonzero(mesh.nodes[:, 2] > 1 - 1e-12)[0]
    rhs[top * 3] = 1.0
    sval = np.zeros(mesh.n_dof)

    sys_mg = FEMSystem(
        mesh, mat, geometric_nonlinear=False,
        config=SolverConfig(
            preconditioner="multigrid", linear_solver="cg", cg_eps=1e-8
        ),
    )
    sys_mg._advance_inc(jnp.asarray(rhs), jnp.asarray(fixed), jnp.asarray(sval))
    assert sys_mg._mg is not None  # the lazy hierarchy was built
    x_mg = np.asarray(sys_mg.dof)

    sys_d = FEMSystem(
        mesh, mat, geometric_nonlinear=False,
        config=SolverConfig(linear_solver="direct"),
    )
    sys_d._advance_inc(jnp.asarray(rhs), jnp.asarray(fixed), jnp.asarray(sval))
    x_d = np.asarray(sys_d.dof)

    scale = np.abs(x_d).max()
    np.testing.assert_allclose(x_mg / scale, x_d / scale, atol=1e-6)

    # the hierarchy is keyed by the fixed mask: same mask -> no rebuild
    mg_before = sys_mg._mg
    sys_mg._advance_inc(jnp.asarray(rhs), jnp.asarray(fixed), jnp.asarray(sval))
    assert sys_mg._mg is mg_before


def test_system_multigrid_requires_structured_mesh():
    from femcy_tpu import FEMesh, FEMSystem, SolverConfig
    from femcy_tpu.meshgen import cantilever_tets

    mesh, _, _ = cantilever_tets(4, 2)
    mesh = FEMesh(mesh.nodes, mesh.elements, mesh.element)  # strips structure
    with pytest.raises(ValueError, match="multigrid"):
        FEMSystem(
            mesh, LinearIsotropic(1000.0, 0.3), geometric_nonlinear=False,
            config=SolverConfig(preconditioner="multigrid"),
        )


def test_system_multigrid_fails_fast_on_uncoarsenable_grid():
    """A structured grid whose dyadic coarsening stalls above the dense-solve
    limit must be rejected at FEMSystem CONSTRUCTION, not mid-solve."""
    from femcy_tpu import FEMSystem, SolverConfig

    mesh = box_tets(17, 17, 17)  # odd: no halving; 3*18^3 dofs >> dense limit
    with pytest.raises(ValueError, match="factors of 2"):
        FEMSystem(
            mesh, LinearIsotropic(1000.0, 0.3), geometric_nonlinear=False,
            config=SolverConfig(preconditioner="multigrid"),
        )


def test_system_multigrid_in_newton_path():
    """The V-cycle (built from the small-strain operator) preconditions the
    Newton tangent solves too: same converged state as Jacobi-CG."""
    import jax.numpy as jnp

    from femcy_tpu import FEMSystem, SolverConfig

    mesh = box_tets(8, 8, 8)
    mat = LinearIsotropic(1000.0, 0.3)
    fixed = np.zeros(mesh.n_dof, bool)
    bottom = np.nonzero(mesh.nodes[:, 2] < 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    top = np.nonzero(mesh.nodes[:, 2] > 1 - 1e-12)[0]
    rhs[top * 3] = 0.05
    sval = np.zeros(mesh.n_dof)

    def run(precond):
        system = FEMSystem(
            mesh, mat, geometric_nonlinear=True,
            config=SolverConfig(
                preconditioner=precond, linear_solver="cg", cg_eps=1e-8
            ),
        )
        ok, iters, res = system._advance_inc(
            jnp.asarray(rhs), jnp.asarray(fixed), jnp.asarray(sval)
        )
        assert ok, (precond, res)
        return np.asarray(system.dof)

    x_mg = run("multigrid")
    x_j = run("jacobi")
    scale = np.abs(x_j).max()
    np.testing.assert_allclose(x_mg / scale, x_j / scale, atol=1e-4)


def test_analytic_values_match_rediscretization():
    """The closed-form uniform-grid DIA values (one cell broadcast through
    corner-existence masks) match device rediscretization to machine
    precision, on a non-cubic box with distinct spacings."""
    from femcy_tpu.solvers.dia import build_structured_dia_pattern
    from femcy_tpu.structured import (
        analytic_structured_dia_values,
        dia_dirichlet_linear_numpy,
    )

    mesh = box_tets(4, 3, 5, 2.0, 1.5, 1.0)
    mat = LinearIsotropic(200.0, 0.3)
    dia = build_structured_dia_pattern(mesh)
    plan = build_structured_plan(mesh, dia)
    dsdx, vol = assembly.gradients_and_volume(
        jnp.asarray(mesh.nodes),
        jnp.asarray(mesh.elements),
        jnp.asarray(mesh.element.dshape_at_gp),
        jnp.asarray(mesh.element.gauss_weights),
    )
    ref = np.asarray(structured_assemble(dsdx, vol, jnp.asarray(mat.C), plan))
    ana = analytic_structured_dia_values(mesh, mat.C, dia)
    np.testing.assert_allclose(ana, ref, rtol=0, atol=1e-11 * np.abs(ref).max())

    # the host elimination twin matches the device one exactly
    rng = np.random.default_rng(0)
    fixed = rng.random(dia.n_dof) < 0.2
    dev, _ = dia_dirichlet_linear(
        jnp.asarray(ref), dia.offsets, dia.diag_idx,
        jnp.zeros(dia.n_dof), jnp.asarray(fixed), jnp.zeros(dia.n_dof),
    )
    host = dia_dirichlet_linear_numpy(ref.copy(), dia.offsets, dia.diag_idx, fixed)
    np.testing.assert_array_equal(np.asarray(dev), host)


def test_newton_schulz_inverse_matches_lapack():
    """The matmul-only dense inverse (a device-side coarsest-level solve
    with no LAPACK custom call) reaches machine precision on an SPD
    operator with cond ~ 1e4."""
    from femcy_tpu.solvers.multigrid import newton_schulz_inverse

    rng = np.random.default_rng(7)
    q, _ = np.linalg.qr(rng.standard_normal((300, 300)))
    A = jnp.asarray(q @ np.diag(np.geomspace(1.0, 1e4, 300)) @ q.T)
    X = jax.jit(newton_schulz_inverse)(A)
    err = float(jnp.max(jnp.abs(A @ X - jnp.eye(300))))
    assert err < 1e-10, err


def test_device_analytic_values_match_host():
    """The on-device cell-tensor broadcast (a multigrid setup that uploads
    only the ~11 KB cell tensor) equals the numpy oracle, and
    the DIA->dense helper round-trips through scipy exactly."""
    from femcy_tpu.solvers.dia import build_structured_dia_pattern
    from femcy_tpu.structured import (
        analytic_cell_tensor,
        analytic_dia_values_device,
        analytic_structured_dia_values,
        dia_dirichlet_linear_numpy,
        dia_to_dense_device,
    )

    mesh = box_tets(4, 3, 5, 2.0, 1.5, 1.0)
    mat = LinearIsotropic(200.0, 0.3)
    dia = build_structured_dia_pattern(mesh)
    rng = np.random.default_rng(3)
    fixed = rng.random(dia.n_dof) < 0.2

    host = dia_dirichlet_linear_numpy(
        analytic_structured_dia_values(mesh, mat.C, dia),
        dia.offsets, dia.diag_idx, fixed,
    )
    c = analytic_cell_tensor(mesh, mat.C, dia)
    grid = (4, 3, 5)
    dev = np.asarray(
        jax.jit(
            lambda cc, m: analytic_dia_values_device(
                cc, grid, dia.offsets, dia.diag_idx, m
            )
        )(c, jnp.asarray(fixed))
    )
    np.testing.assert_allclose(dev, host, rtol=0, atol=1e-12 * np.abs(host).max())

    dense = np.asarray(dia_to_dense_device(jnp.asarray(host), dia.offsets))
    np.testing.assert_array_equal(dense, dia.to_scipy(host).toarray())


def test_multigrid_level_values_match_rediscretization():
    """Every coarse level the V-cycle smooths against equals the
    BC-eliminated rediscretized operator of that level's mesh."""
    from femcy_tpu.solvers.dia import dia_spmv

    mesh, mat, fixed, dia, values_bc, b = _problem(8)
    mg = StructuredMultigrid(mesh, mat, fixed, dia=dia, coarsest_max_dof=400)
    assert len(mg.levels) >= 2
    for lv in mg.levels[1:]:
        mesh_l = box_tets(*lv.grid)
        plan_l = build_structured_plan(mesh_l, lv.dia)
        dsdx, vol = assembly.gradients_and_volume(
            jnp.asarray(mesh_l.nodes),
            jnp.asarray(mesh_l.elements),
            jnp.asarray(mesh_l.element.dshape_at_gp),
            jnp.asarray(mesh_l.element.gauss_weights),
        )
        vals = structured_assemble(dsdx, vol, jnp.asarray(mat.C), plan_l)
        vals, _ = dia_dirichlet_linear(
            vals, lv.dia.offsets, lv.dia.diag_idx,
            jnp.zeros(lv.dia.n_dof), lv.fixed, jnp.zeros(lv.dia.n_dof),
        )
        ref = np.asarray(vals)
        np.testing.assert_allclose(
            np.asarray(lv.values), ref, rtol=0, atol=1e-11 * np.abs(ref).max()
        )


def test_chebyshev_smoother_converges():
    """smoother='chebyshev' (degree-N polynomial in D^-1 A with Gershgorin
    bounds) is a correct drop-in for the damped-Jacobi sweeps.  At 1M
    elements it does NOT beat Jacobi on iteration count (8-9 vs 7 CG
    iterations) with a pricier cycle, so jacobi stays the default; this
    pins correctness."""
    import jax.numpy as jnp

    from femcy_tpu import structured as st
    from femcy_tpu.solvers.dia import dia_spmv

    from femcy_tpu.solvers.dia import build_structured_dia_pattern

    mesh = box_tets(16, 16, 16)
    dia = build_structured_dia_pattern(mesh)
    mat = LinearIsotropic(1000.0, 0.3)
    fixed = np.zeros(mesh.n_dof, bool)
    bottom = np.nonzero(mesh.nodes[:, 2] < 1e-12)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    vals = jnp.asarray(
        st.dia_dirichlet_linear_numpy(
            st.analytic_structured_dia_values(mesh, np.asarray(mat.C), dia),
            dia.offsets, dia.diag_idx, fixed,
        )
    )
    rng = np.random.default_rng(0)
    b = jnp.asarray(np.where(fixed, 0.0, rng.standard_normal(mesh.n_dof)))
    mg = StructuredMultigrid(mesh, mat, fixed, dia=dia, smoother="chebyshev")
    assert len(mg._lmax) == len(mg.levels)
    x, it, _ = mg.pcg_solve(vals, b, eps=1e-8)
    r = float(jnp.max(jnp.abs(b - dia_spmv(vals, dia.offsets, x))))
    assert r < 1e-7 * float(jnp.max(jnp.abs(b)))
    assert int(it) < 40


def test_coarse_pallas_spmv_parity():
    """coarse_spmv="interpret" routes the coarse-level operator applications
    through the Triton DIA SpMV kernel (the GPU f32 path picks it
    automatically); the preconditioned solve must match the XLA
    shifted-slice cycle to roundoff."""
    mesh, mat, fixed, dia, values_bc, b = _problem(16)
    kw = dict(dia=dia, coarsest_max_dof=400)
    mg_ref = StructuredMultigrid(mesh, mat, fixed, **kw)
    mg_pal = StructuredMultigrid(mesh, mat, fixed, coarse_spmv="interpret", **kw)
    # three levels (16 -> 8 -> 4): the 8^3 middle level gets a kernel plan
    assert len(mg_pal.levels) == 3
    assert mg_pal._plans[1] is not None and mg_pal._values_t[0] is not None
    x_ref, it_ref, _ = mg_ref.pcg_solve(values_bc, b, eps=1e-8)
    x_pal, it_pal, _ = mg_pal.pcg_solve(values_bc, b, eps=1e-8)
    assert int(it_pal) == int(it_ref)
    scale = np.abs(np.asarray(x_ref)).max()
    np.testing.assert_allclose(
        np.asarray(x_pal) / scale, np.asarray(x_ref) / scale, atol=1e-10
    )
