"""Slab-sharded structured solve: gather-free multi-chip assembly + DIA CG.

The general sharded path (parallel/sharded.py) is correctness-first: its SpMV
gathers x rows through the ELL column index -- the pattern the
single-device structured path replaced with DIA shifted slices.  For structured box_tets meshes this module shards the SAME
gather-free design over the device mesh:

* **Slab decomposition.**  The box's cells are split into D equal x-slabs,
  one per device; device d owns the node planes [d*nxl, (d+1)*nxl) (the last
  device also owns the final plane).  Each device's row block additionally
  CARRIES the shared boundary plane of its right neighbour, kept bitwise
  consistent on both owners, so every local array has the same static shape.

* **Assembly.**  Each device runs the dense scatter-free structured assembly
  (structured.structured_assemble) on its own slab -- elements of one
  orientation are a dense cell grid, so the slab's DIA rows are statically
  padded adds, no scatter.  The only cross-device coupling is the shared
  node plane: one ppermute each way adds the neighbour's partial plane
  (a (plane_rows, K) buffer over ICI).

* **CG.**  DIA SpMV on the local rows needs x on [start - pad_lo,
  end + pad_hi): two boundary planes from each neighbour (pad_lo < 2 planes
  always, asserted), fetched with two static-slice ppermutes per iteration.
  Dot products mask the duplicated plane by an ownership weight and psum.
  The whole loop lives in one shard_map'd lax.while_loop: no gather
  instruction anywhere in the program, collectives ride the ICI.

The reference has no distributed execution at all (SURVEY.md §2.5); this is
the beyond-parity scaling layer for meshes past one chip's HBM.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from femcy_tpu.materials import Material
from femcy_tpu.mesh import FEMesh
from femcy_tpu.meshgen import box_tets
from femcy_tpu.solvers.dia import build_structured_dia_pattern
from femcy_tpu.structured import build_structured_plan, structured_assemble

AXIS = "fem_mesh"

#: halo depth in node planes; pad_lo = 3*(sx+sy+1)+2 < 2*3*sx = 2 planes
#: for every grid with ny >= nz (asserted in the plan)
HALO_PLANES = 2


@dataclasses.dataclass(frozen=True)
class StructuredShardPlan:
    n_devices: int
    nx: int
    ny: int
    nz: int
    nxl: int  # cell planes per device
    ps: int  # dof rows per node plane = 3*(ny+1)*(nz+1)
    local_rows: int  # (nxl + 1) * ps, incl. the shared right plane
    offsets: tuple
    diag_idx: int
    n_dof: int


def build_structured_shard_plan(mesh: FEMesh, n_devices: int) -> StructuredShardPlan:
    info = mesh.structure
    assert info is not None and info["kind"] == "box_tets"
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    D = n_devices
    if nx % D != 0 or nx // D < HALO_PLANES:
        raise ValueError(
            f"slab sharding needs nx divisible by n_devices with at least "
            f"{HALO_PLANES} cell planes per device (nx={nx}, D={D})"
        )
    dia = build_structured_dia_pattern(mesh)
    ps = 3 * (ny + 1) * (nz + 1)
    assert dia.pad_lo <= HALO_PLANES * ps and dia.pad_hi <= HALO_PLANES * ps
    nxl = nx // D
    return StructuredShardPlan(
        n_devices=D, nx=nx, ny=ny, nz=nz, nxl=nxl, ps=ps,
        local_rows=(nxl + 1) * ps, offsets=dia.offsets,
        diag_idx=dia.diag_idx, n_dof=mesh.n_dof,
    )


def stack_rows(plan: StructuredShardPlan, v: np.ndarray) -> np.ndarray:
    """Global (n_dof, ...) row vector -> (D, local_rows, ...) overlapping
    stacked blocks (the shared plane is duplicated)."""
    blocks = [
        v[d * plan.nxl * plan.ps : (d * plan.nxl + plan.nxl + 1) * plan.ps]
        for d in range(plan.n_devices)
    ]
    return np.stack(blocks)


def unstack_rows(plan: StructuredShardPlan, blocks: np.ndarray) -> np.ndarray:
    """(D, local_rows) stacked blocks -> global (n_dof,) (owned rows only)."""
    own = [blocks[d, : plan.nxl * plan.ps] for d in range(plan.n_devices)]
    own.append(blocks[-1, plan.nxl * plan.ps :])
    return np.concatenate(own)


# --------------------------------------------------------------------------- #
# device-side pieces (run under shard_map; every array is one device's block)
# --------------------------------------------------------------------------- #
def _fetch_halos(plan: StructuredShardPlan, x_local):
    """x_ext = [2 planes from the left | x_local | 2 planes from the right].

    Global rows of device d start at d*nxl*ps, so its left halo lives on
    device d-1 at local planes [nxl-2, nxl) and its right halo on device
    d+1 at local planes [1, 3) (plane 0 duplicates our own last plane).
    Edge devices receive zeros -- correct, because boundary rows have no
    stencil entries beyond the domain.
    """
    D, ps, nxl = plan.n_devices, plan.ps, plan.nxl
    H = HALO_PLANES * ps
    from_left = jax.lax.ppermute(
        x_local[(nxl - HALO_PLANES) * ps : nxl * ps],
        AXIS, perm=[(i, i + 1) for i in range(D - 1)],
    )
    from_right = jax.lax.ppermute(
        x_local[ps : ps + H],
        AXIS, perm=[(i + 1, i) for i in range(D - 1)],
    )
    return jnp.concatenate([from_left, x_local, from_right])


def _spmv_local(plan: StructuredShardPlan, values_local, x_local):
    """y_local = (A x)|rows via static shifted slices of the halo-extended x."""
    H = HALO_PLANES * plan.ps
    x_ext = _fetch_halos(plan, x_local)
    y = jnp.zeros_like(x_local)
    for k, off in enumerate(plan.offsets):
        y = y + values_local[:, k] * jax.lax.dynamic_slice_in_dim(
            x_ext, H + off, plan.local_rows
        )
    return y


def _halo_add(plan: StructuredShardPlan, v):
    """Add the neighbours' partial sums of the shared node planes.

    Works on any (local_rows, ...) per-device array (DIA values, force
    vectors): my first plane's partial belongs also to the left neighbour's
    last plane, and vice versa -- exchange and add, keeping the duplicated
    plane bitwise consistent on both owners.
    """
    D, ps = plan.n_devices, plan.ps
    to_left = jax.lax.ppermute(
        v[:ps], AXIS, perm=[(i + 1, i) for i in range(D - 1)]
    )
    to_right = jax.lax.ppermute(
        v[-ps:], AXIS, perm=[(i, i + 1) for i in range(D - 1)]
    )
    v = v.at[-ps:].add(to_left)
    return v.at[:ps].add(to_right)


def _dirichlet_local(plan: StructuredShardPlan, values_local, rhs_local,
                     fixed_local, sval_local):
    """Symmetric zero-one elimination on the local rows; column masks come
    from the halo-extended fixed/sval vectors (same shifts as the SpMV)."""
    H = HALO_PLANES * plan.ps
    fixed_ext = _fetch_halos(plan, fixed_local.astype(values_local.dtype))
    sval_ext = _fetch_halos(plan, sval_local)
    col_fixed = jnp.stack(
        [
            jax.lax.dynamic_slice_in_dim(fixed_ext, H + off, plan.local_rows)
            for off in plan.offsets
        ],
        axis=1,
    ) > 0.5
    col_sval = jnp.stack(
        [
            jax.lax.dynamic_slice_in_dim(sval_ext, H + off, plan.local_rows)
            for off in plan.offsets
        ],
        axis=1,
    )
    rhs_local = rhs_local - jnp.sum(
        jnp.where(col_fixed, values_local * col_sval, 0.0), axis=1
    )
    rhs_local = jnp.where(fixed_local, sval_local, rhs_local)
    values_local = jnp.where(
        col_fixed | fixed_local[:, None], 0.0, values_local
    )
    diag = jnp.where(fixed_local, 1.0, values_local[:, plan.diag_idx])
    values_local = values_local.at[:, plan.diag_idx].set(diag)
    return values_local, rhs_local


def _pcg_local(plan: StructuredShardPlan, values_local, b_local, own,
               eps: float, max_iters: int, apply_m=None):
    """Row-parallel PCG, DIA halo SpMV, ownership-masked reductions.

    apply_m: optional preconditioner callback z = M^-1 r on local rows (must
    leave the duplicated shared plane consistent on both owners); defaults
    to Jacobi."""
    diag = values_local[:, plan.diag_idx]
    minv = jnp.where(diag != 0.0, 1.0 / diag, 0.0)
    if apply_m is None:
        apply_m = lambda r: minv * r  # noqa: E731

    def pdot(a, b):
        return jax.lax.psum(jnp.dot(own * a, b), AXIS)

    r0 = b_local
    d0 = apply_m(r0)
    x0 = jnp.zeros_like(b_local)
    rmax0 = jax.lax.pmax(jnp.max(jnp.abs(own * r0)), AXIS)

    def cond(state):
        _, _, _, _, k, rmax = state
        return (k < max_iters) & (rmax >= eps * rmax0) & (rmax0 > 0.0)

    def body(state):
        x, r, d, rmr, k, _ = state
        Ad = _spmv_local(plan, values_local, d)
        alpha = rmr / pdot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = apply_m(r)
        rmr_new = pdot(r, z)
        d = z + (rmr_new / rmr) * d
        rmax = jax.lax.pmax(jnp.max(jnp.abs(own * r)), AXIS)
        return x, r, d, rmr_new, k + 1, rmax

    rmr0 = pdot(r0, d0)
    x, r, _, _, k, rmax = jax.lax.while_loop(
        cond, body, (x0, r0, d0, rmr0, jnp.int32(0), rmax0)
    )
    return x, k, rmax


# --------------------------------------------------------------------------- #
# slab-sharded multigrid V-cycle (fine level sharded, coarse levels
# replicated -- after one 8x coarsening the problem is small enough that
# sharding it would be all halo, so every device runs the identical inner
# V-cycle on an all-reduced coarse residual: one psum of n/8 floats down,
# zero communication back up)
# --------------------------------------------------------------------------- #
def _restrict_x_local(plan: StructuredShardPlan, r_local):
    """Fine local slab -> this device's coarse x-planes [0 .. nxl/2].

    Full-weighting along x only (y/z restriction is slab-local and reuses
    the single-device operator): coarse plane jj centred on local fine
    plane 2jj takes 0.5 of both odd neighbours; the left neighbour's last
    interior plane arrives via the standard 2-plane halo fetch, and edge
    devices receive zeros there -- exactly the zero-padding of
    solvers.multigrid._restrict_axis.
    """
    ps, nxl = plan.ps, plan.nxl
    F = _fetch_halos(plan, r_local).reshape(nxl + 5, ps)
    even = F[2 : nxl + 3 : 2]
    odd_lo = F[1 : nxl + 2 : 2]
    odd_hi = F[3 : nxl + 4 : 2]
    return even + 0.5 * (odd_lo + odd_hi)  # (nxl//2 + 1, ps)


def _prolong_x_local(plan: StructuredShardPlan, c_slab):
    """This device's coarse x-planes (nxl/2 + 1, ps) -> fine local planes
    (nxl + 1, ps) by linear interpolation (the exact transpose of
    _restrict_x_local on the owned range)."""
    nxl = plan.nxl
    out = jnp.zeros((nxl + 1, c_slab.shape[1]), dtype=c_slab.dtype)
    out = out.at[0 : nxl + 1 : 2].set(c_slab)
    return out.at[1 : nxl + 1 : 2].set(0.5 * (c_slab[:-1] + c_slab[1:]))


def _sharded_vcycle(plan: StructuredShardPlan, inner_mg, values_local,
                    minv_local, fixed_local, fixed_coarse, values_coarse,
                    inner_ops, r_local, omega: float, smooth_steps: int):
    """One V-cycle M^-1 r on the slab-sharded fine level.

    Fine smoothing/residuals are halo-exchange local ops; the restricted
    residual is assembled into the full coarse vector with one psum of
    disjoint slabs and every device then runs the IDENTICAL single-device
    V-cycle (solvers.multigrid.StructuredMultigrid.precondition) on it, so
    the upward transfer needs no communication at all.
    """
    from femcy_tpu.solvers.multigrid import _interp_axis, _restrict_axis

    D, ps, nxl = plan.n_devices, plan.ps, plan.nxl
    nyc, nzc = plan.ny // 2, plan.nz // 2
    nxc = plan.nx // 2

    def smooth(x, b, steps):
        for _ in range(steps):
            x = x + omega * minv_local * (
                b - _spmv_local(plan, values_local, x)
            )
        return x

    x = smooth(jnp.zeros_like(r_local), r_local, smooth_steps)
    r1 = r_local - _spmv_local(plan, values_local, x)

    # restrict (x locally with halo, then y/z slab-local), fixed dofs masked
    # out of the transfer so BC rows stay exact (cf. multigrid._vcycle)
    r1 = jnp.where(fixed_local, 0.0, r1)
    c = _restrict_x_local(plan, r1).reshape(
        nxl // 2 + 1, plan.ny + 1, plan.nz + 1, 3
    )
    c = _restrict_axis(c, 1)
    c = _restrict_axis(c, 2)  # (nxl/2 + 1, nyc + 1, nzc + 1, 3)

    # disjoint-slab assembly of the full coarse residual: device d owns
    # coarse planes [d*nxl/2, (d+1)*nxl/2), the last one also the final
    # plane (both owners compute the shared plane identically; mask one)
    d_idx = jax.lax.axis_index(AXIS)
    keep_last = (d_idx == D - 1)
    mask = jnp.concatenate(
        [jnp.ones(nxl // 2, dtype=c.dtype),
         jnp.where(keep_last, 1.0, 0.0)[None].astype(c.dtype)]
    )
    full = jnp.zeros((nxc + 1, nyc + 1, nzc + 1, 3), dtype=c.dtype)
    zero = jnp.zeros((), d_idx.dtype)
    full = jax.lax.dynamic_update_slice(
        full, c * mask[:, None, None, None],
        (d_idx * (nxl // 2), zero, zero, zero),
    )
    rc = jax.lax.psum(full.reshape(-1), AXIS)
    rc = jnp.where(fixed_coarse, 0.0, rc)

    # replicated inner V-cycle on the coarse problem (no collectives inside)
    ec = inner_mg.precondition(values_coarse, rc, ops=inner_ops)
    ec = jnp.where(fixed_coarse, 0.0, ec)

    # prolong: slice my coarse x-range from the replicated correction,
    # interpolate x locally, then y/z with the single-device operator
    ec_grid = ec.reshape(nxc + 1, nyc + 1, nzc + 1, 3)
    c_slab = jax.lax.dynamic_slice(
        ec_grid, (d_idx * (nxl // 2), zero, zero, zero),
        (nxl // 2 + 1, nyc + 1, nzc + 1, 3),
    )
    e = _interp_axis(c_slab, 1)
    e = _interp_axis(e, 2)  # (nxl/2 + 1, ny + 1, nz + 1, 3)
    e = _prolong_x_local(plan, e.reshape(nxl // 2 + 1, ps))
    e = jnp.where(fixed_local, 0.0, e.reshape(-1))
    return smooth(x + e, r_local, smooth_steps)


def _assemble_local(plan: StructuredShardPlan, slab_plan, dsdx_cell,
                    vol_cell, C):
    """Dense structured assembly of this device's slab + one-plane halo-add.

    Every cell of an orientation has identical kinematics on the uniform
    grid, so one cell's host-computed gradients are broadcast over the slab
    (structured.cell_gradients) -- the program never gathers coordinates;
    only the halo-add couples the devices.
    """
    nc = plan.nxl * plan.ny * plan.nz
    E = nc * 6
    dsdx = jnp.broadcast_to(
        dsdx_cell[None], (nc, *dsdx_cell.shape)
    ).reshape(E, *dsdx_cell.shape[1:])
    vol = jnp.broadcast_to(
        vol_cell[None], (nc, *vol_cell.shape)
    ).reshape(E, vol_cell.shape[1])
    v = structured_assemble(dsdx, vol, C, slab_plan)  # (local_rows, K)
    return _halo_add(plan, v)


def _make_apply_m(plan, mg_bundle, values_local, fixed_local, mg_arrs):
    """The CG preconditioner callback: slab-sharded V-cycle when mg_bundle
    is set, Jacobi (the _pcg_local default) otherwise."""
    if mg_bundle is None:
        return None
    inner_mg, omega, smooth_steps = mg_bundle
    diag = values_local[:, plan.diag_idx]
    minv = jnp.where(diag != 0.0, 1.0 / diag, 0.0)
    return lambda r: _sharded_vcycle(
        plan, inner_mg, values_local, minv,
        fixed_local, mg_arrs["fixed_coarse"], mg_arrs["values_coarse"],
        mg_arrs["inner_ops"], r, omega, smooth_steps,
    )


def _shard_solve(plan, slab_plan, eps, max_iters, mg_bundle,
                 dsdx_cell, vol_cell, C,
                 rhs_local, fixed_local, sval_local, own, mg_arrs):
    rhs_local = rhs_local[0]
    fixed_local = fixed_local[0]
    sval_local = sval_local[0]
    own = own[0]
    values = _assemble_local(plan, slab_plan, dsdx_cell, vol_cell, C)
    values, b = _dirichlet_local(plan, values, rhs_local, fixed_local, sval_local)
    apply_m = _make_apply_m(plan, mg_bundle, values, fixed_local, mg_arrs)
    x, k, rmax = _pcg_local(plan, values, b, own, eps, max_iters, apply_m)
    return x[None], k, rmax


def _dirichlet_newton_local(plan: StructuredShardPlan, values_local,
                            residual_local, fixed_local):
    """Newton-path Dirichlet treatment on the local rows (same math as
    solvers.dia.dia_dirichlet_newton, halo shifts instead of pads)."""
    H = HALO_PLANES * plan.ps
    fixed_ext = _fetch_halos(plan, fixed_local.astype(values_local.dtype))
    col_fixed = jnp.stack(
        [
            jax.lax.dynamic_slice_in_dim(fixed_ext, H + off, plan.local_rows)
            for off in plan.offsets
        ],
        axis=1,
    ) > 0.5
    residual_local = jnp.where(fixed_local, 0.0, residual_local)
    values_local = jnp.where(
        col_fixed | fixed_local[:, None], 0.0, values_local
    )
    diag = jnp.where(fixed_local, 1.0, values_local[:, plan.diag_idx])
    values_local = values_local.at[:, plan.diag_idx].set(diag)
    return values_local, residual_local


def _shard_newton_eval(plan, slab, slab_plan, material, geometric_stiffness,
                       tangent, n_gp,
                       x0_e, dsdx_cell0, dN, w, C,
                       dof_local, rhs_local, fixed_local, sval_local, own,
                       stab_diag=None, stab_ref=None, stab_scale=None):
    """One full Newton residual/Jacobian evaluation on this device's slab.

    The sharded twin of FEMSystem._newton_eval_impl (which mirrors the
    reference's per-iteration work, stiffnessMtrx.py:609-644 + 756-758 +
    310-341): pin the prescribed dofs, deformation gradients from the
    uniform-grid initial gradients (broadcast, no gather), Cauchy stress,
    internal force + secant (+ geometric) tangent on the current
    configuration, one plane halo-add each, Newton Dirichlet treatment,
    ownership-masked rms.  No gather/scatter instruction anywhere.
    """
    from femcy_tpu import assembly
    from femcy_tpu.structured import (
        structured_dia_scatter,
        structured_element_nodes,
        structured_force_scatter,
    )

    dof_local = dof_local[0]
    rhs_local = rhs_local[0]
    fixed_local = fixed_local[0]
    sval_local = sval_local[0]
    own = own[0]

    dof_local = jnp.where(fixed_local, sval_local, dof_local)
    u = dof_local.reshape(-1, 3)
    u_e = structured_element_nodes(u, slab)  # (E_loc, 4, 3), static slices
    nc = u_e.shape[0] // 6
    dsdX0 = jnp.broadcast_to(
        dsdx_cell0[None], (nc, 6, n_gp, 4, 3)
    ).reshape(u_e.shape[0], n_gp, 4, 3)
    F = assembly.deformation_gradient_u(u_e, dsdX0)
    sigma = assembly.gp_stress(F, material, large=True)
    x_e = x0_e + u_e
    dsdx, vol = assembly.gradients_and_volume_x(x_e, dN, w)

    f_elem = jnp.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)
    f_int = _halo_add(plan, structured_force_scatter(f_elem, slab_plan, slab))

    # tangent on this slab's elements: secant (+ geometric), or the exact
    # consistent tangent (scanned JVPs of the per-element internal force;
    # elements belong wholly to one slab, so no boundary weighting is
    # needed -- only the shared node PLANE is duplicated, handled by the
    # halo-add after the scatter, same as the secant path)
    if tangent == "consistent":
        Ke = assembly.consistent_tangent_elems(u_e, x0_e, dN, w, material)
    else:
        Ke = assembly.element_stiffness(dsdx, vol, C)
        if geometric_stiffness:
            Ke = Ke + assembly.geometric_stiffness(dsdx, sigma, vol)
    values = _halo_add(plan, structured_dia_scatter(Ke, slab_plan))

    if stab_diag is not None:
        # static stabilization / Newmark inertia hook (the sharded twin of
        # FEMSystem._newton_eval_impl's stab_diag contract): viscous force
        # scale*M*(dof - ref) on the local rows + the matching tangent
        # diagonal, BEFORE the Dirichlet treatment.  Elementwise on local
        # rows, so the duplicated shared plane stays consistent on both
        # owners; gather-free.
        d = stab_scale[0] * stab_diag[0]
        f_int = f_int + d * (dof_local - stab_ref[0])
        values = values.at[:, plan.diag_idx].add(d)

    residual = f_int - rhs_local
    values, residual = _dirichlet_newton_local(plan, values, residual,
                                               fixed_local)
    rms = jnp.sqrt(
        jax.lax.psum(jnp.sum(own * residual * residual), AXIS) / plan.n_dof
    )
    return dof_local[None], values[None], residual[None], rms


def _shard_cg(plan, eps, max_iters, mg_bundle,
              values_local, b_local, fixed_local, own, mg_arrs):
    """Standalone sharded PCG on an already-assembled local operator (the
    Newton linear solve; assembly+BC+CG stay fused in _shard_solve for the
    linear path)."""
    values_local = values_local[0]
    b_local = b_local[0]
    fixed_local = fixed_local[0]
    own = own[0]
    apply_m = _make_apply_m(plan, mg_bundle, values_local, fixed_local,
                            mg_arrs)
    x, k, rmax = _pcg_local(plan, values_local, b_local, own, eps, max_iters,
                            apply_m)
    return x[None], k, rmax


class ShardedStructuredSolver:
    """K x = rhs on a structured box, slab-sharded over the device mesh.

    One jitted shard_map program: slab assembly, plane halo-add, Dirichlet
    elimination, halo-exchange DIA CG -- gather-free end to end.
    """

    def __init__(
        self,
        fe_mesh: FEMesh,
        material: Material,
        devices: Optional[list] = None,
        cg_eps: float = 1.0e-6,
        cg_iters: int = 0,
        preconditioner: str = "jacobi",
        mg_omega: float = 0.7,
        mg_smooth_steps: int = 2,
        geometric_stiffness: bool = True,
        tangent: str = "secant",
    ):
        if tangent not in ("secant", "consistent"):
            raise ValueError(
                f"slab tangent must be 'secant' or 'consistent', got "
                f"{tangent!r}"
            )
        self._tangent = tangent
        devices = devices if devices is not None else jax.devices()
        D = len(devices)
        self.device_mesh = Mesh(np.asarray(devices), (AXIS,))
        plan = build_structured_shard_plan(fe_mesh, D)
        self.plan = plan
        if cg_iters <= 0:
            cg_iters = plan.n_dof

        info = fe_mesh.structure
        lx = fe_mesh.nodes[:, 0].max()
        ly = fe_mesh.nodes[:, 1].max()
        lz = fe_mesh.nodes[:, 2].max()
        slab = box_tets(plan.nxl, plan.ny, plan.nz,
                        lx * plan.nxl / plan.nx, ly, lz)
        slab_dia = build_structured_dia_pattern(slab)
        assert slab_dia.offsets == plan.offsets, (
            "slab offsets must equal the global ones (needs >= 2 cell "
            "planes per device)"
        )
        self._slab_plan = build_structured_plan(slab, slab_dia)

        # ownership mask: each device owns its first nxl planes; the last
        # device also owns the final (shared-representation) plane
        own = np.ones((D, plan.local_rows))
        own[:-1, plan.nxl * plan.ps :] = 0.0
        self._own = own

        repl = NamedSharding(self.device_mesh, P())
        shard = NamedSharding(self.device_mesh, P(AXIS))
        from femcy_tpu.structured import cell_gradients, structured_element_nodes

        dsdx_cell, vol_cell = cell_gradients(slab)
        self._dsdx_cell = jax.device_put(jnp.asarray(dsdx_cell), repl)
        self._vol_cell = jax.device_put(jnp.asarray(vol_cell), repl)
        self._C = jax.device_put(jnp.asarray(material.C), repl)
        self._own_d = jax.device_put(jnp.asarray(own), shard)
        self._shard = shard
        self._repl = repl

        # Newton-path operands: every device's slab has identical initial
        # geometry up to a translation (gradients see only differences), so
        # the per-element initial coordinates and quadrature tables are
        # replicated once
        self._slab = slab
        self._material = material
        self._geometric_stiffness = bool(geometric_stiffness)
        self._x0_e = jax.device_put(
            jnp.asarray(
                np.asarray(structured_element_nodes(jnp.asarray(slab.nodes), slab))
            ),
            repl,
        )
        self._dN = jax.device_put(jnp.asarray(slab.element.dshape_at_gp), repl)
        self._w = jax.device_put(jnp.asarray(slab.element.gauss_weights), repl)
        self._n_gp = int(slab.element.dshape_at_gp.shape[0])

        # slab-sharded multigrid: fine level sharded here; everything from
        # the first coarsening down is the REPLICATED single-device
        # hierarchy (n/8 dofs -- sharding it would be all halo).  The inner
        # level-0 operator is the analytic uniform-grid matrix with the
        # coarsened Dirichlet mask, host-built like multigrid setup.
        self._mg_arrs = {"_": jnp.zeros(())}  # non-empty pytree placeholder
        if preconditioner == "multigrid":
            if (
                any(d % 2 for d in (plan.nx, plan.ny, plan.nz))
                or plan.nxl % 2
            ):
                raise ValueError(
                    "sharded multigrid needs even grid dims and an even "
                    f"slab width (got grid {plan.nx}x{plan.ny}x{plan.nz}, "
                    f"slab {plan.nxl})"
                )
            coarse = box_tets(
                plan.nx // 2, plan.ny // 2, plan.nz // 2, lx, ly, lz
            )
            # the hierarchy depends on the fixed mask, which arrives at
            # solve() -- built lazily there (and rebuilt if the mask changes)
            self._mg_setup = (coarse, material, mg_omega, mg_smooth_steps)
        self._preconditioner = preconditioner
        self._cg = (cg_eps, cg_iters)
        self._mg_mask = None
        self._mg_bundle = None
        self._step = None  # compiled lazily (multigrid needs the fixed mask)
        self._newton_step = None
        self._newton_step_stab = None
        self._cg_step = None

    def _compile_step(self, mg_bundle, mg_arrs_spec):
        from jax import shard_map

        fn = partial(
            _shard_solve, self.plan, self._slab_plan, *self._cg, mg_bundle
        )
        return jax.jit(
            shard_map(
                fn,
                mesh=self.device_mesh,
                in_specs=(
                    P(), P(), P(),  # cell gradients + C
                    P(AXIS), P(AXIS), P(AXIS), P(AXIS),  # rhs/fixed/sval/own
                    mg_arrs_spec,  # replicated multigrid operands (or dummy)
                ),
                out_specs=(P(AXIS), P(), P()),
                check_vma=False,
            )
        )

    def _ensure_mg_operands(self, fixed: np.ndarray):
        """Build (or refresh, on a mask change) the replicated coarse
        hierarchy operands for this fixed mask; no program compilation."""
        if self._preconditioner != "multigrid":
            return
        fixed = np.asarray(fixed, bool)
        if self._mg_bundle is not None and np.array_equal(self._mg_mask, fixed):
            return
        self._mg_mask = fixed.copy()
        from femcy_tpu.solvers.multigrid import StructuredMultigrid

        coarse, material, omega, steps = self._mg_setup

        m = fixed.reshape(
            self.plan.nx + 1, self.plan.ny + 1, self.plan.nz + 1, 3
        )
        fixed_c = np.ascontiguousarray(m[::2, ::2, ::2, :]).reshape(-1)
        # the replicated inner hierarchy keeps XLA's shifted slices: the
        # Triton SpMV was measured on the single-device path only
        inner_mg = StructuredMultigrid(
            coarse, material, fixed_c, omega=omega, smooth_steps=steps,
            coarse_spmv="slices",
        )
        dia_c = inner_mg.levels[0].dia
        vc = inner_mg._assemble_level_host(coarse, dia_c, fixed_c)
        dtype = jnp.zeros((), dtype=float).dtype
        repl = self._repl
        self._mg_arrs = {
            "fixed_coarse": jax.device_put(jnp.asarray(fixed_c), repl),
            "values_coarse": jax.device_put(
                jnp.asarray(vc.astype(dtype)), repl
            ),
            "inner_ops": jax.device_put(inner_mg.operands(), repl),
        }
        # compiled programs' structure is mask-independent (the mask enters
        # only through traced arrays and the inner hierarchy's static
        # grids/offsets), so a mask change rebuilds only the operands, not
        # the compiled programs.
        # Programs compiled against an earlier bundle keep working: only the
        # static level shapes are baked in, and those never change.
        self._mg_bundle = (inner_mg, omega, steps)

    def _ensure_multigrid(self, fixed: np.ndarray):
        """Build the hierarchy operands and compile the fused linear-solve
        program (jacobi mode compiles with a dummy)."""
        self._ensure_mg_operands(fixed)
        if self._step is None:
            self._step = self._compile_step(self._mg_bundle, P())

    def solve(self, rhs: np.ndarray, fixed: np.ndarray, sval: np.ndarray):
        plan = self.plan
        self._ensure_multigrid(fixed)
        x_blocks, iters, rmax = self._step(
            self._dsdx_cell, self._vol_cell, self._C,
            self.stack(rhs), self.stack(fixed), self.stack(sval),
            self._own_d,
            self._mg_arrs,
        )
        return unstack_rows(plan, np.asarray(x_blocks)), int(iters)

    # ------------------------------------------------------------------ #
    # Newton path (used by FEMSystem when SolverConfig.sharding="slab"):
    # the host state machine drives these two sharded programs per
    # iteration -- a full residual/Jacobian evaluation and the linear solve.
    # ------------------------------------------------------------------ #
    def stack(self, v) -> jax.Array:
        """Global (n_dof,) host/device vector -> slab-sharded (D, local_rows)
        device blocks (the shared plane duplicated on both owners)."""
        return jax.device_put(
            jnp.asarray(stack_rows(self.plan, np.asarray(v))), self._shard
        )

    def unstack(self, blocks) -> np.ndarray:
        """(D, local_rows) sharded blocks -> global (n_dof,) numpy."""
        return unstack_rows(self.plan, np.asarray(blocks))

    def newton_eval(self, dof_s, rhs_s, fixed_s, sval_s, stab_s=None):
        """(stacked dof, rhs, fixed, sval) -> (pinned dof, BC'd tangent
        blocks, BC'd residual blocks, rms residual) -- one sharded program.

        ``stab_s``: optional (stab_diag_s, stab_ref_s, scale) stabilization
        operands -- stacked diagonal/reference blocks + a replicated (1,)
        scale (config.stabilize_factor under sharding)."""
        base_specs = (
            P(), P(), P(), P(), P(),  # x0_e, dsdx_cell, dN, w, C
            P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
        )
        from jax import shard_map

        fn = partial(
            _shard_newton_eval, self.plan, self._slab, self._slab_plan,
            self._material, self._geometric_stiffness, self._tangent,
            self._n_gp,
        )
        if stab_s is None:
            if self._newton_step is None:
                self._newton_step = jax.jit(
                    shard_map(
                        fn,
                        mesh=self.device_mesh,
                        in_specs=base_specs,
                        out_specs=(P(AXIS), P(AXIS), P(AXIS), P()),
                        check_vma=False,
                    )
                )
            return self._newton_step(
                self._x0_e, self._dsdx_cell, self._dN, self._w, self._C,
                dof_s, rhs_s, fixed_s, sval_s, self._own_d,
            )
        if self._newton_step_stab is None:
            self._newton_step_stab = jax.jit(
                shard_map(
                    fn,
                    mesh=self.device_mesh,
                    in_specs=base_specs + (P(AXIS), P(AXIS), P()),
                    out_specs=(P(AXIS), P(AXIS), P(AXIS), P()),
                    check_vma=False,
                )
            )
        diag_s, ref_s, scale = stab_s
        return self._newton_step_stab(
            self._x0_e, self._dsdx_cell, self._dN, self._w, self._C,
            dof_s, rhs_s, fixed_s, sval_s, self._own_d,
            diag_s, ref_s, scale,
        )

    def cg(self, values_s, b_s, fixed: np.ndarray, fixed_s):
        """Sharded PCG on stacked operator/rhs blocks (the Newton linear
        solve).  ``fixed`` (global, host) keys the multigrid operand cache;
        ``fixed_s`` (stacked, device) feeds the V-cycle's transfer masks."""
        self._ensure_mg_operands(fixed)
        if self._cg_step is None:
            from jax import shard_map

            fn = partial(_shard_cg, self.plan, *self._cg, self._mg_bundle)
            self._cg_step = jax.jit(
                shard_map(
                    fn,
                    mesh=self.device_mesh,
                    in_specs=(P(AXIS), P(AXIS), P(AXIS), P(AXIS), P()),
                    out_specs=(P(AXIS), P(), P()),
                    check_vma=False,
                )
            )
        return self._cg_step(values_s, b_s, fixed_s, self._own_d, self._mg_arrs)
