"""Multi-chip execution: sharded assembly + row-parallel CG over a device mesh.

Scaling design (SURVEY.md §2.5: the reference is strictly
single-device; this layer is the "beyond parity" distributed path):

* **Assembly — data-parallel over elements.**  Elements are partitioned into
  equal shards, one per device.  Each device computes its elements' Ke and
  segment-sums them into a full-height ELL values buffer, then one
  ``psum_scatter`` over the ICI mesh both reduces the partial sums and leaves
  each device holding its own row block — the only collective in assembly.

* **CG — row-parallel SpMV.**  The ELL values/colidx live row-sharded; the
  search direction is ``all_gather``ed once per iteration (the x-vector is
  tiny next to the matrix), dot products are local + ``psum``.  The entire CG
  loop, collectives included, sits inside one jitted ``shard_map``ed
  ``lax.while_loop``: zero host round trips, XLA schedules the collectives on
  ICI.

All per-shard index maps (scatter permutations, local diagonal slots) are
precomputed host-side in numpy and stacked on a leading device axis, so the
device program is static-shape and search-free.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from femcy_tpu import assembly
from femcy_tpu.materials import Material
from femcy_tpu.mesh import FEMesh
from femcy_tpu.topology import build_pattern

AXIS = "fem_mesh"


@dataclasses.dataclass
class ShardedOperands:
    """Host-built static data for a sharded solve on D devices."""

    n_devices: int
    n_dof: int  # true dof count
    n_dof_pad: int  # padded to a multiple of D
    width: int
    rows_per_dev: int
    # stacked per-device arrays (leading axis = device)
    elements: np.ndarray  # (D, E_s, n) padded element shards
    ele_weight: np.ndarray  # (D, E_s) 1 for real elements, 0 for padding
    scatter_targets: np.ndarray  # (D, E_s*edof*edof) into n_dof_pad*width
    force_targets: np.ndarray  # (D, E_s*edof) global dof per force entry
    colidx: np.ndarray  # (n_dof_pad, W) global columns (row-sharded at run)
    diag_local: np.ndarray  # (n_dof_pad,) flat local slot of each row's diagonal
    nodes: np.ndarray  # (N, dm) replicated
    dshape_gp: np.ndarray
    weights_gp: np.ndarray
    C: np.ndarray


def build_sharded_operands(
    mesh: FEMesh, material: Material, n_devices: int
) -> ShardedOperands:
    pattern = build_pattern(mesh)
    D = n_devices
    n_dof = pattern.n_dof
    n_dof_pad = -(-n_dof // D) * D
    rows_per_dev = n_dof_pad // D
    width = pattern.width

    # pad colidx rows; padded rows point their first slot at THEMSELVES so
    # the Dirichlet diag write makes them true identity rows (pointing them
    # at column 0 would add a spurious x[0] coupling when dof 0 is free)
    colidx = np.zeros((n_dof_pad, width), dtype=np.int32)
    colidx[:n_dof] = pattern.colidx
    colidx[n_dof:, 0] = np.arange(n_dof, n_dof_pad)

    # local flat slot of each row's diagonal within its device block
    diag_local = np.zeros(n_dof_pad, dtype=np.int64)
    diag_local[:n_dof] = pattern.diag_slot - (
        (np.arange(n_dof) // rows_per_dev) * rows_per_dev * width
    )
    # padded rows: point their "diagonal" at their local slot 0
    for r in range(n_dof, n_dof_pad):
        diag_local[r] = (r % rows_per_dev) * width

    # --- element shards -------------------------------------------------
    E = mesh.n_elements
    E_s = -(-E // D)
    edof = mesh.element.edof
    dm = mesh.dm
    elements_pad = np.zeros((D * E_s, mesh.element.n_nodes), dtype=np.int32)
    elements_pad[:E] = mesh.elements
    elements_pad[E:] = mesh.elements[0]  # valid geometry, zero-weighted
    weight = np.zeros(D * E_s)
    weight[:E] = 1.0
    elements_sh = elements_pad.reshape(D, E_s, -1)
    weight_sh = weight.reshape(D, E_s)

    # per-shard scatter maps: the single-device pattern's element-ordered
    # slot map (flat slot = row*width + slot, rows unchanged by the row
    # padding) sliced per element shard -- no per-device recomputation (the
    # old per-shard argmax materialised an (E_s*edof^2, width) comparison,
    # ~1 GB/device at the 1M-element scale).  Padded elements reuse element
    # 0's targets; their Ke is zero (zero-weighted volume), so the adds are
    # no-ops.
    tgt = pattern.ensure_scatter_targets().reshape(E, edof * edof).astype(np.int64)
    pad_e = D * E_s - E
    if pad_e:
        tgt = np.concatenate(
            [tgt, np.broadcast_to(tgt[0], (pad_e, edof * edof))], axis=0
        )
    targets_sh = np.ascontiguousarray(tgt.reshape(D, E_s * edof * edof))
    edofs_pad = (
        elements_pad.astype(np.int64)[:, :, None] * dm + np.arange(dm)
    ).reshape(D * E_s, edof)
    force_sh = edofs_pad.reshape(D, E_s * edof).astype(np.int32)

    return ShardedOperands(
        n_devices=D,
        n_dof=n_dof,
        n_dof_pad=n_dof_pad,
        width=width,
        rows_per_dev=rows_per_dev,
        elements=elements_sh,
        ele_weight=weight_sh,
        scatter_targets=targets_sh,
        force_targets=force_sh,
        colidx=colidx,
        diag_local=diag_local,
        nodes=mesh.nodes,
        dshape_gp=mesh.element.dshape_at_gp,
        weights_gp=mesh.element.gauss_weights,
        C=material.C,
    )


# --------------------------------------------------------------------------- #
def _shard_step(
    elements,
    ele_weight,
    scatter_targets,
    colidx_local,
    diag_local,
    rhs_local,
    fixed_local,
    sval_full,
    fixed_full,
    nodes,
    dshape_gp,
    weights_gp,
    C,
    dof_full,
    *,
    n_dof: int,
    n_dof_pad: int,
    width: int,
    rows_per_dev: int,
    cg_eps: float,
    cg_iters: int,
):
    """Per-device body (runs under shard_map): assemble + BC + CG.

    Leading device axis of the stacked inputs is already consumed: every
    array here is this device's block.
    """
    elements = elements[0]
    ele_weight = ele_weight[0]
    scatter_targets = scatter_targets[0]

    # ---- assembly: local elements -> full partial values -> reduce-scatter
    coords = nodes + dof_full[:n_dof].reshape(nodes.shape)
    dsdx, vol = assembly.gradients_and_volume(coords, elements, dshape_gp, weights_gp)
    vol = vol * ele_weight[:, None]  # zero out padded elements
    Ke = assembly.element_stiffness(dsdx, vol, C)
    partial_flat = jax.ops.segment_sum(
        Ke.reshape(-1), scatter_targets, num_segments=n_dof_pad * width
    )
    # reduce + scatter rows across the mesh in one collective (rides ICI)
    values_local = jax.lax.psum_scatter(
        partial_flat.reshape(n_dof_pad, width), AXIS, scatter_dimension=0, tiled=True
    )  # (rows_per_dev, W)

    # ---- Dirichlet: symmetric zero-one elimination on the local row block
    col_fixed = fixed_full[colidx_local]
    rhs_local = rhs_local - jnp.sum(
        jnp.where(col_fixed, values_local * sval_full[colidx_local], 0.0), axis=1
    )
    rhs_local = jnp.where(fixed_local, sval_full[_local_rows(rows_per_dev)], rhs_local)
    values_local = _zero_one_local(
        values_local, colidx_local, diag_local, fixed_local, fixed_full
    )

    x, k = _row_parallel_pcg(
        values_local, colidx_local, diag_local, rhs_local, cg_eps, cg_iters
    )
    return jax.lax.all_gather(x, AXIS, tiled=True), k


def _row_parallel_pcg(values_local, colidx_local, diag_local, b_local,
                      cg_eps, cg_iters):
    """Row-parallel Jacobi-PCG: local rows, all_gather'd direction, psum dots;
    the whole iteration inside one while_loop (collectives ride the ICI)."""
    diag = values_local.reshape(-1)[diag_local]
    minv = jnp.where(diag != 0.0, 1.0 / diag, 0.0)

    def spmv_local(d_full):
        return jnp.sum(values_local * d_full[colidx_local], axis=1)

    r0 = b_local
    d0 = minv * r0
    x0 = jnp.zeros_like(r0)
    rmax0 = jax.lax.pmax(jnp.max(jnp.abs(r0)), AXIS)

    # rmax is carried in the state so the while condition stays collective-free
    def cond(state):
        _, _, _, k, rmax = state
        return (k < cg_iters) & (rmax >= cg_eps * rmax0) & (rmax0 > 0.0)

    def body(state):
        x, r, d, k, _ = state
        d_full = jax.lax.all_gather(d, AXIS, tiled=True)
        Ad = spmv_local(d_full)
        rmr = jax.lax.psum(jnp.dot(r, minv * r), AXIS)
        dAd = jax.lax.psum(jnp.dot(d, Ad), AXIS)
        alpha = rmr / dAd
        x = x + alpha * d
        r = r - alpha * Ad
        rmr_new = jax.lax.psum(jnp.dot(r, minv * r), AXIS)
        d = minv * r + (rmr_new / rmr) * d
        rmax = jax.lax.pmax(jnp.max(jnp.abs(r)), AXIS)
        return x, r, d, k + 1, rmax

    x, r, _, k, _ = jax.lax.while_loop(cond, body, (x0, r0, d0, jnp.int32(0), rmax0))
    return x, k


def _zero_one_local(values_local, colidx_local, diag_local, fixed_local,
                    fixed_full):
    """Zero fixed rows and columns of the local row block, unit diagonal."""
    col_fixed = fixed_full[colidx_local]
    values_local = jnp.where(col_fixed | fixed_local[:, None], 0.0, values_local)
    flat = values_local.reshape(-1)
    diag_vals = jnp.where(fixed_local, 1.0, flat[diag_local])
    return flat.at[diag_local].set(diag_vals).reshape(values_local.shape)


def _local_rows(rows_per_dev: int):
    """Global row ids of this device's block."""
    base = jax.lax.axis_index(AXIS) * rows_per_dev
    return base + jnp.arange(rows_per_dev)


def _put_operands(device_mesh, ops):
    """device_put the stacked/replicated operand arrays with their shardings;
    shared by the linear solver and the Newton stepper."""
    shard = NamedSharding(device_mesh, P(AXIS))
    repl = NamedSharding(device_mesh, P())

    def put(x, sharding):
        return jax.device_put(jnp.asarray(x), sharding)

    return {
        "elements": put(ops.elements, shard),
        "ele_weight": put(ops.ele_weight, shard),
        "targets": put(ops.scatter_targets, shard),
        "force_targets": put(ops.force_targets, shard),
        "colidx": put(ops.colidx, shard),
        "diag_local": put(ops.diag_local, shard),
        "nodes": put(ops.nodes, repl),
        "dN": put(ops.dshape_gp, repl),
        "w": put(ops.weights_gp, repl),
        "C": put(ops.C, repl),
    }


class ShardedLinearSolver:
    """K(dof) x = rhs with Dirichlet elimination, sharded over a device mesh.

    The full step (assembly -> reduce-scatter -> BC -> CG) is one jitted
    shard_map program; calling it is one XLA execution per solve.
    """

    def __init__(
        self,
        fe_mesh: FEMesh,
        material: Material,
        devices: Optional[list] = None,
        cg_eps: float = 1.0e-6,
        cg_iters: int = 0,
    ):
        devices = devices if devices is not None else jax.devices()
        self.device_mesh = Mesh(np.asarray(devices), (AXIS,))
        D = len(devices)
        ops = build_sharded_operands(fe_mesh, material, D)
        self.ops = ops
        if cg_iters <= 0:
            cg_iters = ops.n_dof

        d = _put_operands(self.device_mesh, ops)
        self._elements = d["elements"]
        self._ele_weight = d["ele_weight"]
        self._targets = d["targets"]
        self._colidx = d["colidx"]
        self._diag_local = d["diag_local"]
        self._nodes = d["nodes"]
        self._dN = d["dN"]
        self._w = d["w"]
        self._C = d["C"]

        from jax import shard_map

        fn = partial(
            _shard_step,
            n_dof=ops.n_dof,
            n_dof_pad=ops.n_dof_pad,
            width=ops.width,
            rows_per_dev=ops.rows_per_dev,
            cg_eps=cg_eps,
            cg_iters=cg_iters,
        )
        self._step = jax.jit(
            shard_map(
                fn,
                mesh=self.device_mesh,
                in_specs=(
                    P(AXIS),  # elements
                    P(AXIS),  # ele_weight
                    P(AXIS),  # scatter targets
                    P(AXIS, None),  # colidx rows
                    P(AXIS),  # diag_local
                    P(AXIS),  # rhs rows
                    P(AXIS),  # fixed rows
                    P(),  # sval full
                    P(),  # fixed full
                    P(),  # nodes
                    P(),  # dN
                    P(),  # w
                    P(),  # C
                    P(),  # dof full
                ),
                out_specs=(P(), P()),
                check_vma=False,
            )
        )

    def solve(self, rhs: np.ndarray, fixed: np.ndarray, sval: np.ndarray, dof=None):
        """Assemble K(dof), apply Dirichlet BCs and solve K x = rhs."""
        ops = self.ops
        pad = ops.n_dof_pad - ops.n_dof
        rhs_p = jnp.concatenate([jnp.asarray(rhs), jnp.zeros(pad)])
        fixed_p = jnp.concatenate(
            [jnp.asarray(fixed), jnp.ones(pad, dtype=bool)]
        )  # padded rows behave as pinned-to-zero identity rows
        sval_p = jnp.concatenate([jnp.asarray(sval), jnp.zeros(pad)])
        dof_p = (
            jnp.zeros(ops.n_dof_pad)
            if dof is None
            else jnp.concatenate([jnp.asarray(dof), jnp.zeros(pad)])
        )
        x, iters = self._step(
            self._elements,
            self._ele_weight,
            self._targets,
            self._colidx,
            self._diag_local,
            rhs_p,
            fixed_p,
            sval_p,
            fixed_p,
            self._nodes,
            self._dN,
            self._w,
            self._C,
            dof_p,
        )
        return x[: ops.n_dof], int(iters)


# --------------------------------------------------------------------------- #
# Sharded geometric-nonlinear Newton step
# --------------------------------------------------------------------------- #
def _shard_newton_step(
    elements,
    ele_weight,
    scatter_targets,
    force_targets,
    dsdX0,
    colidx_local,
    diag_local,
    rhs_local,
    fixed_local,
    sval_full,
    fixed_full,
    nodes,
    dshape_gp,
    weights_gp,
    C,
    dof_full,
    *,
    material,
    n_dof: int,
    n_dof_pad: int,
    width: int,
    rows_per_dev: int,
    cg_eps: float,
    cg_iters: int,
):
    """One full Newton step, element-data-parallel + row-parallel.

    Per device: pin Dirichlet dofs; deformation gradients, Cauchy stress and
    internal force on the local element shard; secant+geometric tangent;
    one psum_scatter each for the force and the matrix rows; Newton-BC the
    local row block; row-parallel CG; return (dof - du, rms residual).
    """
    elements = elements[0]
    ele_weight = ele_weight[0]
    scatter_targets = scatter_targets[0]
    force_targets = force_targets[0]

    dsdX = dsdX0[0]
    dof_full = jnp.where(fixed_full, sval_full, dof_full)
    u = dof_full[:n_dof].reshape(nodes.shape)

    # deformation gradient w.r.t. the initial configuration (precomputed)
    F = jnp.einsum("enU,egnX->egUX", u[elements], dsdX) + jnp.eye(
        nodes.shape[1], dtype=dof_full.dtype
    )
    sigma = assembly.gp_stress(F, material, large=True)

    # current configuration
    coords = nodes + u
    dsdx, vol = assembly.gradients_and_volume(coords, elements, dshape_gp, weights_gp)
    vol = vol * ele_weight[:, None]

    # internal force -> row-sharded
    f_elem = jnp.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)
    f_partial = jax.ops.segment_sum(
        f_elem.reshape(-1), force_targets, num_segments=n_dof_pad
    )
    f_local = jax.lax.psum_scatter(
        f_partial.reshape(-1, 1), AXIS, scatter_dimension=0, tiled=True
    ).reshape(-1)

    # tangent (secant + geometric stress stiffening) -> row-sharded
    Ke = assembly.element_stiffness(dsdx, vol, C)
    Ke = Ke + assembly.geometric_stiffness(dsdx, sigma, vol)
    partial_flat = jax.ops.segment_sum(
        Ke.reshape(-1), scatter_targets, num_segments=n_dof_pad * width
    )
    values_local = jax.lax.psum_scatter(
        partial_flat.reshape(n_dof_pad, width), AXIS, scatter_dimension=0, tiled=True
    )

    # Newton Dirichlet treatment on the local rows
    residual_local = jnp.where(fixed_local, 0.0, f_local - rhs_local)
    values_local = _zero_one_local(
        values_local, colidx_local, diag_local, fixed_local, fixed_full
    )

    rms = jnp.sqrt(
        jax.lax.psum(jnp.sum(residual_local**2), AXIS) / n_dof
    )

    du_local, k = _row_parallel_pcg(
        values_local, colidx_local, diag_local, residual_local, cg_eps, cg_iters
    )
    du_full = jax.lax.all_gather(du_local, AXIS, tiled=True)
    return dof_full - du_full, rms, k


class ShardedNewtonStep:
    """The full geometric-nonlinear Newton step as ONE sharded XLA program.

    Elements are data-parallel across the device mesh, matrix/force rows are
    sharded after a psum_scatter reduction, and the CG runs row-parallel --
    the FEM analogue of a sharded training step.
    """

    def __init__(
        self,
        fe_mesh: FEMesh,
        material: Material,
        devices: Optional[list] = None,
        cg_eps: float = 1.0e-3,
        cg_iters: int = 0,
    ):
        devices = devices if devices is not None else jax.devices()
        self.device_mesh = Mesh(np.asarray(devices), (AXIS,))
        D = len(devices)
        ops = build_sharded_operands(fe_mesh, material, D)
        self.ops = ops
        self.material = material
        if cg_iters <= 0:
            cg_iters = ops.n_dof

        d = _put_operands(self.device_mesh, ops)
        self._elements = d["elements"]
        self._ele_weight = d["ele_weight"]
        self._targets = d["targets"]
        self._force_targets = d["force_targets"]
        self._colidx = d["colidx"]
        self._diag_local = d["diag_local"]
        self._nodes = d["nodes"]
        self._dN = d["dN"]
        self._w = d["w"]
        self._C = d["C"]
        # initial-configuration gradients per element shard, computed once
        dsdX0, _ = assembly.gradients_and_volume(
            d["nodes"], jnp.asarray(ops.elements.reshape(-1, ops.elements.shape[-1])),
            d["dN"], d["w"],
        )
        shard = NamedSharding(self.device_mesh, P(AXIS))
        self._dsdX0 = jax.device_put(
            np.asarray(dsdX0).reshape(ops.elements.shape[0],
                                      ops.elements.shape[1], *dsdX0.shape[1:]),
            shard,
        )

        from jax import shard_map

        fn = partial(
            _shard_newton_step,
            material=material,
            n_dof=ops.n_dof,
            n_dof_pad=ops.n_dof_pad,
            width=ops.width,
            rows_per_dev=ops.rows_per_dev,
            cg_eps=cg_eps,
            cg_iters=cg_iters,
        )
        self._step = jax.jit(
            shard_map(
                fn,
                mesh=self.device_mesh,
                in_specs=(
                    P(AXIS),  # elements
                    P(AXIS),  # ele_weight
                    P(AXIS),  # stiffness scatter targets
                    P(AXIS),  # force targets
                    P(AXIS),  # dsdX0 per element shard
                    P(AXIS, None),  # colidx rows
                    P(AXIS),  # diag_local
                    P(AXIS),  # rhs rows
                    P(AXIS),  # fixed rows
                    P(),  # sval full
                    P(),  # fixed full
                    P(),  # nodes
                    P(),  # dN
                    P(),  # w
                    P(),  # C
                    P(),  # dof full
                ),
                out_specs=(P(), P(), P()),
                check_vma=False,
            )
        )

    def step(self, dof, rhs, fixed, sval):
        """dof -> (dof - K^-1 r, rms residual, CG iterations), padded I/O
        handled internally."""
        ops = self.ops
        pad = ops.n_dof_pad - ops.n_dof
        dof_p = jnp.concatenate([jnp.asarray(dof), jnp.zeros(pad)])
        rhs_p = jnp.concatenate([jnp.asarray(rhs), jnp.zeros(pad)])
        fixed_p = jnp.concatenate([jnp.asarray(fixed), jnp.ones(pad, dtype=bool)])
        sval_p = jnp.concatenate([jnp.asarray(sval), jnp.zeros(pad)])
        new_dof, rms, k = self._step(
            self._elements,
            self._ele_weight,
            self._targets,
            self._force_targets,
            self._dsdX0,
            self._colidx,
            self._diag_local,
            rhs_p,
            fixed_p,
            sval_p,
            fixed_p,
            self._nodes,
            self._dN,
            self._w,
            self._C,
            dof_p,
        )
        return new_dof[: ops.n_dof], rms, int(k)
