"""The equation system: assembly + BCs + linear/Newton solves + time stepping.

Counterpart of the reference ``System_of_equations``
(stiffnessMtrx.py:19-844).  Every device step (assembly, BC application,
residual evaluation, CG) is a jitted pure function with static shapes, so each
compiles exactly once per mesh; the data-dependent outer control flow --
adaptive load stepping, Newton iteration, the boost/relax line-search
heuristics -- runs in host Python exactly like the reference's state machine
(stiffnessMtrx.py:647-822), which is load-bearing for which benchmarks
converge (SURVEY.md §5, "failure detection").
"""

from __future__ import annotations

import dataclasses
import logging
import math
import time as _time
from functools import partial
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from femcy_tpu import assembly, bc as bc_mod
from femcy_tpu.config import SolverConfig
from femcy_tpu.io.inp import InpModel
from femcy_tpu.materials import Material
from femcy_tpu.mesh import FEMesh
from femcy_tpu.solvers.cg import pcg_solve
from femcy_tpu.solvers.dia import (
    build_dia_pattern,
    dia_dirichlet_linear,
    dia_dirichlet_newton,
    dia_pcg_solve,
    dia_scatter,
)
from femcy_tpu.solvers.direct import direct_solve
from femcy_tpu.topology import ELLPattern, build_pattern
from femcy_tpu.utils.timing import Timer

logger = logging.getLogger("femcy_tpu")


@dataclasses.dataclass
class IncrementRecord:
    kinc: int
    time: float
    dt: float
    newton_iters: int
    residual: float
    converged: bool


@dataclasses.dataclass
class SolveReport:
    success: bool
    increments: List[IncrementRecord]
    wall_time: float
    message: str = ""
    #: energy dissipated by static stabilization (config.stabilize_factor);
    #: 0 when stabilization is off
    stabilization_energy: float = 0.0

    @property
    def n_increments(self) -> int:
        return len(self.increments)


def _rms(x):
    """Reference residual norm: sqrt(sum(x^2)/N) (ref: tiGadgets.py:28-37)."""
    return jnp.sqrt(jnp.sum(x * x) / x.shape[0])


#: module-level jit so every FEMSystem ctor shares one compiled program per
#: shape -- run EAGERLY this computation is ~30 op-by-op dispatches
_gradients_jit = jax.jit(assembly.gradients_and_volume)


def run_newton(dof0, evaluate, lin_solve, finish, cfg, ini_residual):
    """The Newton-Raphson state machine with boost/relax line search
    (ref: stiffnessMtrx.py:756-822), abstracted over three callables so every
    solver configuration (single-device, fused, sharded, multi-block) drives
    the exact same heuristics:

    evaluate(dof) -> (dof, values, residual, rms)
        pin prescribed dofs, assemble residual + tangent
    lin_solve(values, residual, reuse=None) -> du
        the Newton linear solve
    finish(dof)
        persist the working dof into the owning system

    ``ini_residual`` is the caller's process-lifetime initial-residual cache
    (the reference quirk, stiffnessMtrx.py:760-762); pass the current value
    (or None) and store the returned one.

    Returns (converged, newton_loops, final_residual, ini_residual).
    """
    dof, values, residual, pre_residual = evaluate(dof0)
    if ini_residual is None:
        # cached for the whole analysis (parity with the reference's
        # process-lifetime cache, stiffnessMtrx.py:760-762)
        ini_residual = pre_residual
    if cfg.newton_residual_ref == "increment":
        # sane default: measure convergence against THIS increment's
        # initial unbalance (the reference's global cache lets later
        # increments skip Newton entirely and accumulate error)
        ini = pre_residual
    else:
        ini = ini_residual
    if cfg.verbose:
        logger.info("initial residual = %.6e (ini=%.6e)", pre_residual, ini)

    newton_loop = 0
    residual_val = pre_residual
    # modified Newton: one LU per increment, refreshed on stall
    # (config.newton_jacobian_reuse; the dict is threaded through
    # _solve_linear_system's direct path)
    reuse = {} if cfg.newton_jacobian_reuse == "increment" else None
    if ini >= cfg.newton_abs_tol:
        newton_loop = -1
        while pre_residual / (ini + 1.0e-30) >= cfg.newton_rel_tol:
            newton_loop += 1
            if newton_loop >= cfg.newton_max_iters:
                finish(dof)
                return False, newton_loop, pre_residual, ini_residual

            du = lin_solve(values, residual, reuse=reuse)
            dof = dof - du
            dof, values, residual, residual_val = evaluate(dof)
            if np.isnan(residual_val):
                logger.warning("NaN residual; cutting back time step")
                finish(dof)
                return False, newton_loop, residual_val, ini_residual
            if cfg.verbose:
                logger.info(
                    "newton %d residual=%.6e", newton_loop, residual_val
                )

            # boost: keep stepping while the residual declines
            # (ref: stiffnessMtrx.py:792-807)
            boost_loop = -1
            relaxation = 1.0
            while 0.1 * pre_residual < residual_val < pre_residual:
                new_residual = residual_val
                boost_loop += 1
                if boost_loop >= cfg.newton_boost_max:
                    break
                dof = dof - relaxation * du
                dof, values, residual, residual_val = evaluate(dof)
                if residual_val > new_residual:
                    dof = dof + relaxation * du
                    dof, values, residual, residual_val = evaluate(dof)
                    relaxation *= 0.5

            # relaxation: back off when the residual grows
            # (ref: stiffnessMtrx.py:809-819)
            relax_loop = -1
            relaxation = 0.5
            while residual_val > pre_residual:
                relax_loop += 1
                if relax_loop >= cfg.newton_relax_max:
                    break
                dof = dof + (1.0 - relaxation) * du
                du = relaxation * du
                dof, values, residual, residual_val = evaluate(dof)

            if (
                reuse is not None
                and residual_val > cfg.newton_reuse_stall * pre_residual
            ):
                # stale-Jacobian convergence stalled: refactorize with
                # the freshly assembled tangent on the next solve
                reuse["refresh"] = True
            pre_residual = residual_val
        newton_loop = max(newton_loop, 0)

    finish(dof)
    return True, newton_loop, residual_val, ini_residual


class FEMSystem:
    """Assemble and solve one body with one material.

    Parameters mirror the reference constructor (stiffnessMtrx.py:26):
    a mesh (``Body``), a material, and the geometric-nonlinearity flag.
    """

    def __init__(
        self,
        mesh: FEMesh,
        material: Material,
        geometric_nonlinear: bool = False,
        config: SolverConfig = SolverConfig(),
    ):
        self.mesh = mesh
        self.material = material
        self.geometric_nonlinear = bool(geometric_nonlinear)
        self.config = config

        # near-incompressible models condition the operator like
        # E/(1-2*nu) ~ 1e4*E: f32 (eps ~ 6e-8) loses ~4% of the stress on the
        # nu=0.4999 Cook fixture (measured; see tests/test_precision.py),
        # while f64 matches the literature anchor.  f64 per-system is not
        # representable while x64 is globally off, so warn loudly instead.
        nu = getattr(material, "poisson_ratio", 0.0)
        # refinement engages on the linear path (_refine_linear_solve) and
        # the standard Newton path (_newton_refine); fused_newton has no
        # host residual hook, so the warning stays live there
        if (
            nu >= 0.495
            and not jax.config.jax_enable_x64
            and (
                not config.mixed_precision_refine
                or (self.geometric_nonlinear and config.fused_newton)
            )
        ):
            logger.warning(
                "near-incompressible material (nu=%.4f) in f32 mode: "
                "expect O(1%%) stress error; set "
                "SolverConfig(mixed_precision_refine=True) to recover f64 "
                "accuracy with f32 bulk work (linear and standard-Newton "
                "analyses%s), or enable x64 (FEMCY_TPU_X64=1)",
                nu,
                " -- NOT the fused_newton path used here"
                if self.geometric_nonlinear and config.fused_newton
                else "",
            )

        structured = (
            config.sparse_format in ("auto", "dia")
            and mesh.structure is not None
            and mesh.structure.get("kind") == "box_tets"
        )
        self.pattern: Optional[ELLPattern] = None
        self.dia = None
        self._structured_plan = None
        #: host-setup phase walls (seconds) for benchmark attribution
        init_s = {}
        self._init_seconds = init_s
        if structured:
            # analytic pattern + dense scatter-free assembly: no ELL pattern
            # or scatter maps at all (O(1) host setup instead of minutes at
            # the 1M-element scale)
            from femcy_tpu.solvers.dia import build_structured_dia_pattern
            from femcy_tpu.structured import build_structured_plan

            self.dia = build_structured_dia_pattern(mesh)
            self._structured_plan = build_structured_plan(mesh, self.dia)
        else:
            _t = _time.time()
            self.pattern = build_pattern(mesh)
            init_s["pattern"] = round(_time.time() - _t, 1)
            # gather-free DIA layout when the offset structure allows it.
            # The AMG branch (_ensure_amg / _solve_linear_system) is built
            # for the dof-ELL layout -- its block-ELL gather plan indexes
            # ``values`` as (n_dof, ell_width) -- so a DIA-layout values
            # array would feed it garbage (both operator and
            # preconditioner); force the ELL layout under 'amg'.
            if config.preconditioner == "amg":
                if config.sparse_format == "dia":
                    raise ValueError(
                        "preconditioner='amg' requires the ELL layout; "
                        "sparse_format='dia' is incompatible"
                    )
            elif config.sparse_format in ("auto", "dia"):
                dia = build_dia_pattern(
                    mesh, max_offsets=config.dia_max_offsets, ell=self.pattern
                )
                dense_enough = (
                    dia is not None
                    and dia.n_offsets * self.pattern.n_dof <= 4 * self.pattern.nnz
                )
                if dia is not None and (config.sparse_format == "dia" or dense_enough):
                    self.dia = dia
                elif config.sparse_format == "dia":
                    raise ValueError(
                        "sparse_format='dia' but the mesh has no bounded offset "
                        "structure (try a bandwidth-reducing node ordering)"
                    )

        elem = mesh.element
        # --- static device arrays, passed as jit ARGUMENTS ------------------
        # (never closed over inside jit: captured arrays are baked into the
        # compiled module as constants, which bloats/serialises the HLO at
        # the 1M-element scale)
        p = self.pattern
        arrs = {
            "nodes": jnp.asarray(mesh.nodes),
            "elements": jnp.asarray(mesh.elements),
            "dN": jnp.asarray(elem.dshape_at_gp),
            "w": jnp.asarray(elem.gauss_weights),
            "C": jnp.asarray(material.C),
        }
        if p is not None:
            # the structured path writes by diagonal offset and never
            # gathers/scatters, so these (large) maps exist only otherwise
            arrs["colidx"] = jnp.asarray(p.colidx)
            arrs["diag_slot"] = jnp.asarray(p.diag_slot)
            if self.dia is not None:
                arrs["scatter_targets"] = jnp.asarray(self.dia.scatter_targets)
            else:
                # compact node-block map; the dof expansion happens
                # in-program (assembly.scatter_stiffness_blocks) -- dm^2 x
                # less host export + H2D traffic than the dof-level map
                arrs["block_targets"] = jnp.asarray(p.block_targets)
            # force segment ids are computed in-program from the
            # connectivity (_internal_force_parts): no dof-level export
        _t = _time.time()
        jax.block_until_ready(list(arrs.values()))
        init_s["upload"] = round(_time.time() - _t, 1)
        # initial-configuration gradients are constant: precompute once
        _t = _time.time()
        dsdX0, vol0 = _gradients_jit(
            arrs["nodes"], arrs["elements"], arrs["dN"], arrs["w"]
        )
        jax.block_until_ready(vol0)
        init_s["gradients"] = round(_time.time() - _t, 1)
        arrs["dsdX0"] = dsdX0
        arrs["vol0"] = vol0
        self._arrs = arrs

        # --- state ----------------------------------------------------------
        self.dof = jnp.zeros(mesh.n_dof)
        self._last_vol = vol0  # volume of the most recent assembly
        self.time0 = 0.0
        self.time1 = 0.0
        self.dt = 0.0
        self._ini_residual: Optional[float] = None
        #: PCG iteration count of the most recent _solve_linear_system call
        #: (0 until a CG path has run; direct solves leave it untouched) --
        #: observability for benchmarks and preconditioner diagnostics
        self._last_cg_iters: int = 0
        self.timer = Timer(verbose=config.verbose)
        # mixed-precision refinement state (config.mixed_precision_refine)
        self._host_bc = None
        self._refine_K = None
        self._refine_reuse: Optional[dict] = None
        self._suppress_cg_warn = False
        # last Dirichlet (fixed, sval) arrays applied by solve(), kept for
        # post-hoc diagnostics (tangent_min_eigenvalue)
        self._last_dirichlet = None
        # cached one-program analysis (config.device_loop)
        self._device_loop_prog = None
        # lazily-jitted post-processing programs
        self._jit_strain_stress = None
        self._jit_refine_eval = None  # lazy consistent-tangent eval (_newton_refine)
        #: f64 master state written by _newton_refine (mixed-precision
        #: Newton): the certified-equilibrium solution, exact beyond the
        #: f32 representation floor of ``self.dof``
        self.dof_refined: Optional[np.ndarray] = None
        self._jit_energy = None

        # --- jitted steps ---------------------------------------------------
        self._jit_linear_system = jax.jit(self._linear_system_impl)
        self._jit_newton_eval = jax.jit(self._newton_eval_impl)
        self._jit_fused_step = jax.jit(self._fused_step_impl)
        self._jit_cg = jax.jit(
            partial(
                pcg_solve,
                eps=config.cg_eps,
                max_iters=config.cg_max_iters,
            )
        )
        # small-model dense CG (config.dense_operator_max_dof): the solve
        # scatters the BC'd operator to (n, n) in-program and runs a
        # gather-free dense-matvec CG -- the device-resident answer for
        # models too small to amortise the ELL row-gather SpMV
        self._use_dense_cg = (
            0 < config.dense_operator_max_dof
            and mesh.n_dof <= config.dense_operator_max_dof
        )
        self._jit_dense_cg = jax.jit(self._dense_cg_core)
        self._jit_F = jax.jit(self._deformation_gradient_impl)
        self._spmv = None
        if self.dia is not None:
            dia = self.dia

            # Triton DIA SpMV (kernels/dia_spmv.py) on a GPU in f32, the
            # XLA shifted slices elsewhere; spmv="triton" raises off-GPU
            from femcy_tpu.kernels import dia_spmv as spmv_kernel

            dtype = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
            if config.spmv == "triton" or (
                config.spmv == "auto" and spmv_kernel.kernel_available(dtype)
            ):
                self._spmv = spmv_kernel.make_spmv(mesh.n_dof, dia.offsets)
            elif config.spmv not in ("auto", "slices"):
                raise ValueError(f"unknown spmv {config.spmv!r}")

            block_dm = self.mesh.dm if config.preconditioner == "block_jacobi" else 0
            spmv_pair = self._spmv

            def _dia_cg(values, b):
                return dia_pcg_solve(
                    values,
                    dia.offsets,
                    dia.diag_idx,
                    b,
                    eps=config.cg_eps,
                    max_iters=config.cg_max_iters,
                    block_dm=block_dm,
                    spmv=spmv_pair,
                )

            self._jit_dia_cg = jax.jit(_dia_cg)

        # geometric multigrid preconditioner (lazy: needs the fixed-dof mask,
        # known only at solve time)
        self._mg = None
        self._mg_fixed_key: Optional[bytes] = None
        self._mg_fixed_obj = None
        self._jit_mg_cg = None
        if config.preconditioner == "multigrid":
            if self._structured_plan is None:
                raise ValueError(
                    "preconditioner='multigrid' needs a structured box_tets "
                    "mesh with the DIA layout (e.g. meshgen.box_tets)"
                )
            # fail fast (before any compile time is spent) if the grid
            # cannot be dyadically coarsened
            from femcy_tpu.solvers.multigrid import coarsen_grids

            info = mesh.structure
            coarsen_grids((info["nx"], info["ny"], info["nz"]))
        # algebraic multigrid (lazy like _mg: needs the fixed mask)
        self._amg = None
        self._amg_fixed_key: Optional[bytes] = None
        self._amg_fixed_obj = None
        self._amg_raw_csr = None  # cached no-BC f64 host operator
        self._jit_amg_cg = None
        if config.preconditioner == "amg" and self.pattern is None:
            raise ValueError(
                "preconditioner='amg' runs on the general ELL path; this "
                "structured mesh already has the geometric 'multigrid'"
            )

        # --- multi-chip slab sharding (config.sharding="slab") --------------
        # The reference is strictly single-device (SURVEY.md §2.5).  With
        # sharding="slab" the SAME host state machine (adaptive stepping +
        # Newton + boost/relax) drives gather-free slab-sharded device
        # programs instead of the single-device jits: see
        # parallel/structured.py and _advance_inc.
        self._shard_sys = None
        if config.sharding == "slab":
            if self._structured_plan is None:
                raise ValueError(
                    "sharding='slab' needs a structured box_tets mesh "
                    "(e.g. meshgen.box_tets); unstructured meshes use "
                    "sharding='banded'"
                )
            from femcy_tpu.parallel.structured import ShardedStructuredSolver

            devs = jax.devices()
            n = config.sharding_devices or len(devs)
            self._shard_sys = ShardedStructuredSolver(
                mesh,
                material,
                devices=devs[:n],
                cg_eps=config.cg_eps,
                cg_iters=config.cg_max_iters,
                preconditioner=(
                    "multigrid"
                    if config.preconditioner == "multigrid"
                    else "jacobi"
                ),
                geometric_stiffness=config.geometric_stiffness,
                tangent=config.tangent,
            )
        elif config.sharding == "banded":
            # general (unstructured) meshes: RCM + block-tridiagonal row
            # shards (parallel/banded.py) behind the SAME host state machine
            # -- any .inp mesh can now run the full analysis multi-chip,
            # with either tangent (the consistent tangent evaluates per
            # element shard, so it shards exactly like the secant one)
            from femcy_tpu.parallel.banded import BandedShardedSolver

            devs = jax.devices()
            n = config.sharding_devices or len(devs)
            self._shard_sys = BandedShardedSolver(
                mesh,
                material,
                devices=devs[:n],
                cg_eps=config.cg_eps,
                cg_iters=config.cg_max_iters,
                geometric_stiffness=config.geometric_stiffness,
                pattern=self.pattern,  # reuse; don't rebuild the ELL maps
                tangent=config.tangent,
            )
        elif config.sharding != "none":
            raise ValueError(f"unknown sharding mode {config.sharding!r}")

    # ------------------------------------------------------------------ #
    # jitted implementations (pure functions of device state)
    # ------------------------------------------------------------------ #
    def _assemble_values(self, a, dsdx, vol, coords=None):
        """Gradients -> global sparse values, via the structured dense path
        when available (Ke computed per orientation to bound live memory).
        With ``coords`` on a structured mesh where the Triton kernel path
        applies (GPU/f32/C3D4), the whole assembly reroutes through
        structured_assemble_coords, recomputing the gradients in the
        kernel's padded cell space; otherwise the precomputed dsdx/vol are
        used directly (the coords reroute's XLA fallback would recompute
        them for nothing)."""
        if self._structured_plan is not None:
            from femcy_tpu.structured import (
                kernel_assembly_eligible,
                structured_assemble,
                structured_assemble_coords,
            )

            if coords is not None and kernel_assembly_eligible(
                self.mesh, coords.dtype
            ):
                return structured_assemble_coords(
                    coords, self.mesh, a["dN"], a["w"], a["C"],
                    self._structured_plan,
                    C_host=np.asarray(self.material.C),
                )
            return structured_assemble(dsdx, vol, a["C"], self._structured_plan)
        if self.dia is None and dsdx.shape[0] > self._assembly_chunk:
            # general ELL path at scale: CHUNK the element pipeline.  A
            # fori_loop over fixed-size chunks bounds every element-sized
            # temp (Ke, expanded targets) to chunk size while the
            # segment-sum accumulates into the final flat values array.
            return self._chunked_block_scatter(a, dsdx, vol)
        Ke = assembly.element_stiffness(dsdx, vol, a["C"])
        return self._scatter(a, Ke)

    #: elements per chunk of the large-mesh general-ELL assembly.  Read
    #: from compiled.memory_analysis() for the 1,053,696-element C3D4
    #: unstructured box in f32 on an H100: chunked, 213 MB of temps and
    #: 5.24 ms per assembly + BC; unchunked, 1.21 GB and 5.35 ms (PERF.md).
    #: Both fit; the chunked program is the faster one.
    _assembly_chunk: int = 131072

    def _chunked_block_scatter(self, a, dsdx, vol):
        P = self.pattern
        E = dsdx.shape[0]
        dm = self.mesh.dm
        npe = self.mesh.element.n_nodes
        bt = a["block_targets"].reshape(E, npe * npe)
        nseg = P.n_dof * P.width
        C = a["C"]

        def add_chunk(flat, ds, vl, btc):
            Ke = assembly.element_stiffness(ds, vl, C)
            tg = assembly.expand_block_targets(
                btc.reshape(-1), P.node_width, dm, P.width, npe
            )
            return flat + jax.ops.segment_sum(
                Ke.reshape(-1), tg, num_segments=nseg
            )

        flat = jnp.zeros(nseg, dtype=dsdx.dtype)
        chunk = self._assembly_chunk
        n_main = E // chunk
        if n_main:
            def body(i, fl):
                def sl(x):
                    return jax.lax.dynamic_slice_in_dim(
                        x, i * chunk, chunk, 0
                    )

                return add_chunk(fl, sl(dsdx), sl(vol), sl(bt))

            flat = jax.lax.fori_loop(0, n_main, body, flat)
        rem = E % chunk
        if rem:
            flat = add_chunk(
                flat, dsdx[E - rem:], vol[E - rem:], bt[E - rem:]
            )
        return flat.reshape(P.n_dof, P.width)

    def _scatter(self, a, Ke):
        """Element matrices -> global sparse values (ELL or DIA layout)."""
        if self._structured_plan is not None:
            from femcy_tpu.structured import structured_dia_scatter

            return structured_dia_scatter(Ke, self._structured_plan)
        if self.dia is not None:
            return dia_scatter(
                Ke, a["scatter_targets"], self.dia.n_dof, self.dia.n_offsets
            )
        return assembly.scatter_stiffness_blocks(
            Ke, a["block_targets"], self.pattern.n_dof, self.pattern.width,
            self.pattern.node_width, self.mesh.dm,
        )

    def _dirichlet_linear(self, a, values, rhs, fixed, sval):
        if self.dia is not None:
            return dia_dirichlet_linear(
                values, self.dia.offsets, self.dia.diag_idx, rhs, fixed, sval
            )
        return bc_mod.apply_dirichlet_linear(
            values, a["colidx"], a["diag_slot"], rhs, fixed, sval
        )

    def _dirichlet_newton(self, a, values, residual, fixed):
        if self.dia is not None:
            return dia_dirichlet_newton(
                values, self.dia.offsets, self.dia.diag_idx, residual, fixed
            )
        return bc_mod.apply_dirichlet_newton(
            values, a["colidx"], a["diag_slot"], residual, fixed
        )

    def _linear_system_impl(self, a, rhs, fixed, sval):
        """Assemble + Dirichlet-eliminate for the linear path.

        Always on the *initial* configuration: in the reference the linear
        branch rebinds ``self.dof = self.du`` (stiffnessMtrx.py:246) after the
        assembly kernel has already captured the original, forever-zero dof
        field via ``ti.static`` (stiffnessMtrx.py:135-136), so its linear
        assembly never sees the deformed geometry either.
        """
        values = self._assemble_values(a, a["dsdX0"], a["vol0"],
                                       coords=a["nodes"])
        values, rhs = self._dirichlet_linear(a, values, rhs, fixed, sval)
        return values, rhs, a["vol0"]

    def _deformation_gradient_impl(self, a, dof):
        return assembly.deformation_gradient(dof, a["elements"], a["dsdX0"])

    def _internal_force_parts(self, a, dof, fixed, sval):
        """Shared first half of every Newton evaluation: pin prescribed
        dofs, compute current-configuration kinematics, Cauchy stress and
        the internal nodal force (ref: stiffnessMtrx.py:609-644).  Returns
        (pinned dof, coords, dsdx, vol, sigma, f_int) -- the stabilization
        term (``stab_diag`` hook) is already folded into ``f_int``."""
        dof = bc_mod.pin_dof(dof, fixed, sval)
        coords = a["nodes"] + dof.reshape(-1, self.mesh.dm)
        if self._structured_plan is not None:
            # gather-free: element node values by static grid slices
            from femcy_tpu.structured import structured_element_nodes

            u_e = structured_element_nodes(
                dof.reshape(-1, self.mesh.dm), self.mesh
            )
            F = assembly.deformation_gradient_u(u_e, a["dsdX0"])
            x_e = structured_element_nodes(coords, self.mesh)
            dsdx, vol = assembly.gradients_and_volume_x(x_e, a["dN"], a["w"])
        else:
            F = assembly.deformation_gradient(dof, a["elements"], a["dsdX0"])
            dsdx, vol = assembly.gradients_and_volume(
                coords, a["elements"], a["dN"], a["w"]
            )
        sigma = assembly.gp_stress(F, self.material, large=True)
        if self._structured_plan is not None:
            from femcy_tpu.structured import structured_force_scatter

            f_elem = jnp.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)
            f_int = structured_force_scatter(
                f_elem, self._structured_plan, self.mesh
            )
        else:
            # segment ids are pure arithmetic on the connectivity: computing
            # them in-program (XLA fuses the multiply-add into the scatter)
            # drops a 4*E*edof-byte host export + H2D transfer (~50 MB at
            # the 1M-element scale)
            dm = self.mesh.dm
            ft = (
                a["elements"].astype(jnp.int32)[:, :, None] * dm
                + jnp.arange(dm, dtype=jnp.int32)
            ).reshape(-1)
            f_int = assembly.internal_force(
                dsdx, sigma, vol, ft, self.pattern.n_dof
            )
        if "stab_diag" in a:
            # static stabilization (config.stabilize_factor): viscous force.
            # Applied BEFORE the Dirichlet treatment so constrained rows stay
            # zero-one; the matching tangent add happens in _newton_eval_impl.
            d = a["stab_scale"] * a["stab_diag"]
            f_int = f_int + d * (dof - a["stab_ref"])
        return dof, coords, dsdx, vol, sigma, f_int

    def _residual_rms_impl(self, a, dof, rhs, fixed, sval):
        """RMS of the BC-zeroed Newton residual at ``dof`` WITHOUT
        assembling a tangent: the cheap line-search/convergence probe of the
        device-resident analysis loop (device_loop.py).  With the consistent
        tangent (edof JVPs per element) this costs ~1/edof of a full
        ``_newton_eval_impl``."""
        dof, _, _, _, _, f_int = self._internal_force_parts(
            a, dof, fixed, sval
        )
        residual = jnp.where(fixed, 0.0, f_int - rhs)
        return dof, _rms(residual)

    def _newton_eval_impl(self, a, dof, rhs, fixed, sval):
        """One full residual/Jacobian evaluation of the Newton method.

        Pins the prescribed dofs, computes internal force and stiffness on
        the current configuration, applies the Newton Dirichlet treatment and
        returns (pinned dof, K_bc, residual_bc, rms residual)
        (ref: stiffnessMtrx.py:609-644 + 756-758 + 310-341).
        """
        dof, coords, dsdx, vol, sigma, f_int = self._internal_force_parts(
            a, dof, fixed, sval
        )
        if self.config.tangent == "consistent":
            Ke = assembly.consistent_tangent(
                dof, a["elements"], a["nodes"], a["dN"], a["w"], self.material
            )
            values = self._scatter(a, Ke)
        elif (
            self._structured_plan is None or self.config.geometric_stiffness
        ):
            Ke = assembly.element_stiffness(dsdx, vol, a["C"])
            if self.config.geometric_stiffness:
                Ke = Ke + assembly.geometric_stiffness(dsdx, sigma, vol)
            values = self._scatter(a, Ke)
        else:
            values = self._assemble_values(a, dsdx, vol, coords=coords)
        if "stab_diag" in a:
            # static stabilization (config.stabilize_factor): the tangent
            # regularization matching the viscous force already folded into
            # f_int by _internal_force_parts.
            d = a["stab_scale"] * a["stab_diag"]
            if self.dia is not None:
                values = values.at[:, self.dia.diag_idx].add(d)
            else:
                flat = values.reshape(-1)
                values = flat.at[a["diag_slot"]].add(d).reshape(values.shape)
        residual = f_int - rhs
        values, residual = self._dirichlet_newton(a, values, residual, fixed)
        return dof, values, residual, _rms(residual), vol

    def _fused_step_impl(self, a, dof, rhs, fixed, sval):
        """One FUSED Newton iteration: residual/tangent evaluation + the CG
        linear solve in a single program (config.fused_newton).

        Returns (pinned dof, du, rms residual at dof, vol): the host applies
        ``dof - du`` itself, so this one program is both the evaluator (for
        convergence checks and line-search probes) and the solver.
        """
        cfg = self.config
        dof, values, residual, res, vol = self._newton_eval_impl(
            a, dof, rhs, fixed, sval
        )
        if self._use_dense_cg:
            du, _, _ = self._dense_cg_core(
                values, residual, None if self.dia is not None else a["colidx"]
            )
        elif self.dia is not None:
            du, _, _ = dia_pcg_solve(
                values, self.dia.offsets, self.dia.diag_idx, residual,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
                block_dm=(
                    self.mesh.dm if cfg.preconditioner == "block_jacobi" else 0
                ),
                spmv=self._spmv,
            )
        else:
            du, _, _ = pcg_solve(
                values, a["colidx"], a["diag_slot"], residual,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
            )
        return dof, du, res, vol

    def _dense_cg_core(self, values, b, colidx):
        """Small-model dense CG: BC'd sparse values -> dense (n, n) operator
        (one in-program scatter) -> gather-free dense-matvec Jacobi-PCG.
        ``colidx`` is the ELL column table (None on the DIA layout)."""
        from femcy_tpu.solvers.cg import dense_pcg_solve, ell_to_dense

        cfg = self.config
        if self.dia is not None:
            from femcy_tpu.structured import dia_to_dense_device

            A = dia_to_dense_device(values, self.dia.offsets)
        else:
            A = ell_to_dense(values, colidx, self.mesh.n_dof)
        return dense_pcg_solve(
            A, b, eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
            block_dm=(
                self.mesh.dm if cfg.preconditioner == "block_jacobi" else 0
            ),
        )

    # ------------------------------------------------------------------ #
    # linear solve dispatch (ref: stiffnessMtrx.py:272-276)
    # ------------------------------------------------------------------ #
    def _solve_linear_system(self, values, b, fixed=None, reuse=None):
        """``reuse``: optional dict carrying a cached LU across Newton
        iterations (modified Newton, config.newton_jacobian_reuse); callers
        set reuse["refresh"]=True to force refactorization."""
        cfg = self.config
        use_direct = cfg.linear_solver == "direct" or (
            cfg.linear_solver == "auto" and self.mesh.n_dof < cfg.direct_solve_max_dof
        )
        if use_direct:
            pat = self.dia if self.dia is not None else self.pattern
            if reuse is not None:
                from femcy_tpu.solvers.direct import factorize

                if reuse.get("lu") is None or reuse.pop("refresh", False):
                    reuse["lu"] = factorize(pat, np.asarray(values))
                return jnp.asarray(reuse["lu"].solve(np.asarray(b)))
            return jnp.asarray(direct_solve(pat, values, b))
        if cfg.preconditioner == "multigrid" and fixed is not None:
            self._ensure_multigrid(fixed)
            x, iters, rmax = self._jit_mg_cg(values, b, self._mg_ops)
            if cfg.verbose:
                logger.info(
                    "MG-CG: %d iters, ||r||_inf=%.3e", int(iters), float(rmax)
                )
            self._warn_cg_cap(iters, rmax, b)
            self._last_cg_iters = int(iters)
            return x
        if cfg.preconditioner == "amg" and fixed is not None:
            self._ensure_amg(fixed, values=values)
            x, iters, rmax = self._jit_amg_cg(
                values, self._bell_arrs, b, self._amg_ops
            )
            if cfg.verbose:
                logger.info(
                    "AMG-CG: %d iters, ||r||_inf=%.3e", int(iters), float(rmax)
                )
            self._warn_cg_cap(iters, rmax, b)
            self._last_cg_iters = int(iters)
            return x
        if self._use_dense_cg:
            x, iters, rmax = self._jit_dense_cg(
                values, b,
                None if self.dia is not None else self._arrs["colidx"],
            )
        elif self.dia is not None:
            x, iters, rmax = self._jit_dia_cg(values, b)
        else:
            x, iters, rmax = self._jit_cg(
                values, self._arrs["colidx"], self._arrs["diag_slot"], b
            )
        if cfg.verbose:
            logger.info("CG: %d iters, ||r||_inf=%.3e", int(iters), float(rmax))
        self._warn_cg_cap(iters, rmax, b)
        self._last_cg_iters = int(iters)
        return x

    def _refine_linear_solve(self, rhs_np, fixed_np, sval_np, fixed_d, sval_d):
        """Mixed-precision iterative refinement (config.mixed_precision_refine).

        x_{k+1} = x_k + solve_f32(b - K_f64 x_k): the f64 residual is
        evaluated on the host against the exactly-assembled CSR operator
        (assembly_host.py); every inner solve runs the regular device path
        (f32 CG/multigrid, or the direct solver with one cached LU).  Each
        outer iteration contracts the error by ~kappa(K)*eps_f32 -- the
        nu=0.4999 Cook (f32 alone: 4.2%% off) lands at f64 accuracy in a few
        iterations with all bulk work in f32 (tests/test_precision.py).
        """
        from femcy_tpu import assembly_host

        cfg = self.config
        if self._refine_K is None:
            pattern = self.pattern
            if pattern is None:
                pattern = build_pattern(self.mesh)
            self._refine_K = assembly_host.assemble_csr_host(
                self.mesh, pattern, self.material.C
            )
            self._refine_reuse = {}
        K_bc, b = assembly_host.dirichlet_csr_host(
            self._refine_K, rhs_np, fixed_np, sval_np
        )
        # the f32 inner operator: BC-eliminated device assembly (constant
        # across increments -- initial configuration, fixed mask only)
        values, _, _ = self._jit_linear_system(
            self._arrs, jnp.zeros(self.mesh.n_dof), fixed_d, sval_d
        )
        x = np.zeros(self.mesh.n_dof)
        bmax = float(np.abs(b).max())
        rmax = bmax
        it = 0
        self._suppress_cg_warn = True  # truncated inner solves are expected
        try:
            for it in range(cfg.refine_max_iters):
                r = b - K_bc @ x
                rmax = float(np.abs(r).max())
                if bmax == 0.0 or rmax <= cfg.refine_tol * bmax:
                    break
                d = self._solve_linear_system(
                    values,
                    jnp.asarray(r, dtype=values.dtype),
                    fixed_d,
                    reuse=self._refine_reuse,
                )
                x = x + np.asarray(d, np.float64)
        finally:
            self._suppress_cg_warn = False
        if bmax > 0.0 and rmax > 1.0e-6 * bmax:
            logger.warning(
                "mixed-precision refinement stalled at ||r||/||b||=%.3e "
                "after %d iterations (kappa*eps_f32 too large?)",
                rmax / bmax, it,
            )
        elif cfg.verbose:
            logger.info(
                "refinement: %d outer iterations, ||r||/||b||=%.3e",
                it, rmax / (bmax + 1e-300),
            )
        return jnp.asarray(x)

    def _newton_refine(self, rhs, fixed, sval):
        """Mixed-precision refinement of a CONVERGED Newton increment
        (config.mixed_precision_refine on the geometric-nonlinear path).

        The f32 Newton loop stops at res/ini < 1e-2 with the residual
        EVALUATED in f32 -- near-incompressible tangents amplify that
        evaluation noise into O(1%) stress error.  This polishes the
        equilibrium with extra modified-Newton iterations whose residual is
        the f64 HOST internal force (assembly_host.internal_force_host, an
        exact twin of the device path) while every linear solve stays in
        the device dtype against the frozen f32 tangent: the nonlinear
        sibling of _refine_linear_solve.  Each iteration contracts the
        error by ~kappa * eps_f32 until the f64 residual bottoms out at the
        f32 solve's noise floor.
        """
        from femcy_tpu import assembly_host

        cfg = self.config
        rhs_np, fixed_np, sval_np = self._host_bc
        fixed_np = np.asarray(fixed_np, bool)
        dof = np.asarray(self.dof, np.float64)
        dof = np.where(fixed_np, np.asarray(sval_np, np.float64), dof)

        # frozen f32 CONSISTENT tangent at the converged state (one device
        # eval); the LU (direct path) is cached across the refinement via
        # ``reuse``.  The secant tangent is NOT contractive here (measured:
        # the modified-Newton residual GROWS 2.5e-3 -> 4.2e-3 with the
        # secant, vs 2.6e-5 -> 2.6e-13 in two steps with the exact
        # tangent), so refinement assembles the consistent one regardless
        # of config.tangent.
        if self._jit_refine_eval is None:
            def _consistent_eval(a, dof_d, rhs_d, fixed_d, sval_d):
                dof_d = bc_mod.pin_dof(dof_d, fixed_d, sval_d)
                Ke = assembly.consistent_tangent(
                    dof_d, a["elements"], a["nodes"], a["dN"], a["w"],
                    self.material,
                )
                values = self._scatter(a, Ke)
                if "stab_diag" in a:
                    # the device Newton converged WITH the stabilization /
                    # Newmark-inertia diagonal (see _newton_eval_impl); the
                    # frozen refinement tangent must carry it too, before
                    # the Dirichlet treatment (rows stay zero-one)
                    d = a["stab_scale"] * a["stab_diag"]
                    if self.dia is not None:
                        values = values.at[:, self.dia.diag_idx].add(d)
                    else:
                        flat = values.reshape(-1)
                        values = flat.at[a["diag_slot"]].add(d).reshape(
                            values.shape
                        )
                zero = jnp.zeros(self.mesh.n_dof, dtype=values.dtype)
                values, _ = self._dirichlet_newton(a, values, zero, fixed_d)
                return values

            self._jit_refine_eval = jax.jit(_consistent_eval)
        values = self._jit_refine_eval(
            self._arrs, jnp.asarray(dof), rhs, fixed, sval
        )
        reuse = {}  # one LU for the whole refinement (modified Newton)

        # stabilization / dynamic-rescue inertia force: the equilibrium the
        # device Newton converged to INCLUDES stab_scale*stab_diag*(d-ref)
        # (see _internal_force_parts); the f64 residual must measure that
        # same system or the refinement drags the state toward the
        # unstabilized static equilibrium, defeating the stabilization.
        stab_scale = 0.0
        stab_d = stab_ref = None
        if "stab_diag" in self._arrs:
            stab_scale = float(self._arrs["stab_scale"])
            if stab_scale != 0.0:
                stab_d = np.asarray(self._arrs["stab_diag"], np.float64)
                stab_ref = np.asarray(self._arrs["stab_ref"], np.float64)

        def f64_residual(d):
            f = assembly_host.internal_force_host(
                self.mesh, self.material, d, large=True
            )
            if stab_d is not None:
                f = f + stab_scale * stab_d * (d - stab_ref)
            r = f - rhs_np
            r[fixed_np] = 0.0
            return r, float(np.sqrt(np.mean(f * f)))

        r, scale = f64_residual(dof)
        rms = float(np.sqrt(np.mean(r * r)))
        floor = cfg.refine_tol * max(scale, 1e-300)
        it = 0
        self._suppress_cg_warn = True
        try:
            for it in range(cfg.refine_max_iters):
                if rms <= floor:
                    break
                du = self._solve_linear_system(
                    values, jnp.asarray(r, dtype=values.dtype), fixed,
                    reuse=reuse,
                )
                dof_new = dof - np.asarray(du, np.float64)
                r_new, _ = f64_residual(dof_new)
                rms_new = float(np.sqrt(np.mean(r_new * r_new)))
                if rms_new >= rms:
                    # no progress: the f32 solve's noise floor
                    break
                contraction = rms_new / max(rms, 1e-300)
                dof, r, rms = dof_new, r_new, rms_new
                if rms > floor and contraction > 0.1:
                    # frozen-tangent contraction is linear once the f32
                    # Newton left a sizable residual; refresh the
                    # consistent tangent at the current state to restore
                    # the quadratic rate (one device eval + one LU)
                    values = self._jit_refine_eval(
                        self._arrs, jnp.asarray(dof), rhs, fixed, sval
                    )
                    reuse["refresh"] = True
        finally:
            self._suppress_cg_warn = False
        if cfg.verbose:
            logger.info(
                "newton refinement: %d iterations, rms(r64)/rms(f)=%.3e",
                it, rms / max(scale, 1e-300),
            )
        self.dof = jnp.asarray(dof)
        # the f32 copy above re-rounds the state to the device dtype, whose
        # representation floor alone measures rms(r64)/rms(f) ~ 6e-5 on the
        # nu=0.4999 Cook; the f64 master state keeps the certified
        # equilibrium (rms ~ 1e-12) for host-side recovery
        self.dof_refined = dof

    def _warn_cg_cap(self, iters, rmax, b):
        """Warn when the CG while_loop exited on its iteration cap with the
        residual still above tolerance -- the returned solution is silently
        truncated otherwise (measured ~12% off on the nu=0.4999 Cook,
        tests/test_precision.py)."""
        if self._suppress_cg_warn:
            return  # refinement inner solves truncate by design
        cap = (
            self.config.cg_max_iters
            if self.config.cg_max_iters > 0
            else self.mesh.n_dof
        )
        if int(iters) < cap:
            return
        rmax0 = float(jnp.max(jnp.abs(b)))
        if rmax0 > 0.0 and float(rmax) >= self.config.cg_eps * rmax0:
            logger.warning(
                "CG exited at the iteration cap (%d) UNCONVERGED: "
                "||r||_inf=%.3e >= eps*||r0||_inf=%.3e -- the solution is "
                "truncated; raise cg_max_iters, loosen cg_eps, or use a "
                "stronger preconditioner",
                cap, float(rmax), self.config.cg_eps * rmax0,
            )

    def _ensure_multigrid(self, fixed):
        """Build (or rebuild, if the fixed-dof mask changed) the V-cycle
        hierarchy and its jitted PCG.  Setup is host/CPU-side and cheap
        relative to one fine-level compile; the hierarchy is reused across
        increments and Newton iterations."""
        # fast path: within one increment the SAME mask object is passed to
        # every Newton iteration -- avoid a device-to-host copy + hash per
        # linear solve
        if self._mg is not None and fixed is self._mg_fixed_obj:
            return
        key = np.asarray(fixed).tobytes()
        if self._mg is not None and self._mg_fixed_key == key:
            self._mg_fixed_obj = fixed
            return
        from femcy_tpu.solvers.multigrid import StructuredMultigrid

        self._mg = StructuredMultigrid(
            self.mesh, self.material, np.asarray(fixed), dia=self.dia,
            coarse_spmv=self.config.spmv,
        )
        self._mg_fixed_key = key
        self._mg_fixed_obj = fixed
        self._mg_ops = self._mg.operands()
        mg = self._mg
        cfg = self.config
        # <=0 means "up to n_dof", like the reference's CG cap and the
        # Jacobi paths (conjugateGradientSolver.py:109)
        max_iters = cfg.cg_max_iters if cfg.cg_max_iters > 0 else self.mesh.n_dof

        spmv_pair = self._spmv

        def _mg_cg(values, b, ops):
            return mg.pcg_solve(
                values, b, eps=cfg.cg_eps, max_iters=max_iters, ops=ops,
                spmv=spmv_pair,
            )

        self._jit_mg_cg = jax.jit(_mg_cg)

    def _ensure_amg(self, fixed, values=None):
        """Build (or rebuild on a changed fixed-dof mask) the smoothed-
        aggregation hierarchy (solvers/amg.py) and its jitted PCG.

        With ``values`` (the caller's ALREADY-BC-ELIMINATED device ELL
        operator) the hierarchy is built from that exact operator pulled
        back once -- one D2H copy + one csr gather, no f64 host-twin
        assembly at all (the twin costs ~25 s at the 1M-element scale; a
        preconditioner does not need f64 entries).  Without ``values`` it
        falls back to the host twin (initial configuration).  Either way
        the hierarchy is kept across increments and Newton iterations; the
        PCG always iterates on the CALLER's exact current device operator,
        so on the nonlinear path this acts as a frozen-hierarchy
        preconditioner (still SPD, still convergent; iteration counts rise
        gradually with tangent drift)."""
        if self.dia is not None:
            # defence in depth: __init__ forces the ELL layout under 'amg';
            # a DIA-layout values array here would corrupt both the CG
            # operator and the hierarchy (block-ELL gather on DIA values)
            raise RuntimeError(
                "internal: preconditioner='amg' with a DIA-layout operator"
            )
        if self._amg is not None and fixed is self._amg_fixed_obj:
            return
        _wall0 = _time.time()
        host_s = {}
        key = np.asarray(fixed).tobytes()
        host_s["fixed_key"] = _time.time() - _wall0
        if self._amg is not None and self._amg_fixed_key == key:
            self._amg_fixed_obj = fixed
            return
        from femcy_tpu.solvers.amg import AlgebraicMultigrid
        from femcy_tpu.solvers.bell import (
            bell_spmv,
            build_bell_plan,
            plan_node_graph as _fine_node_graph,
        )

        fixed_np = np.asarray(fixed, dtype=bool)
        # fine-level block-ELL plan: the eliminated dof-ELL operator is
        # converted ONCE per solve (a pure reshape+transpose, the layout
        # is blockwise by construction); every CG and smoothing iteration
        # then gathers (dm,)-vector rows, 9x fewer than the dof-ELL
        # gather (solvers/bell.py)
        if getattr(self, "_bell_plan", None) is None:
            _t = _time.time()
            self._bell_plan = build_bell_plan(self.pattern, self.mesh.dm)
            host_s["bell_plan"] = _time.time() - _t
            logger.info("amg: bell plan %.1fs", host_s["bell_plan"])
            self._bell_arrs = {
                "valid": jnp.asarray(self._bell_plan.valid),
                "ncol": jnp.asarray(self._bell_plan.ncol),
            }
        plan = self._bell_plan
        if values is not None:
            # the exact operator being solved (BC-eliminated on device),
            # pulled back in BF16: the hierarchy is a preconditioner, not
            # the operator CG iterates on, so 8 significand bits suffice
            # (bf16 keeps f32's exponent range -- stiffness entries reach
            # 1e10+, which overflows f16) and the D2H copy moves half the
            # bytes
            _t = _time.time()
            values_np = np.asarray(
                values.astype(jnp.bfloat16), dtype=np.float32
            )
            host_s["pullback"] = _time.time() - _t
            # direct BSR from the blockwise ELL layout: a reshape +
            # boolean select, no CSR intermediate (the former
            # to_scipy + tobsr pair measured 8.6 s + 0.7 s at 1M elements)
            _t = _time.time()
            import scipy.sparse as sp

            dmn = plan.dm
            blocks = values_np.reshape(
                plan.n_nodes, dmn, plan.width, dmn
            ).transpose(0, 2, 1, 3)[plan.valid]
            counts = plan.valid.sum(axis=1)
            indptr = np.zeros(plan.n_nodes + 1, dtype=np.int64)
            np.cumsum(counts, out=indptr[1:])
            K_bc = sp.bsr_matrix(
                (blocks, plan.ncol[plan.valid].astype(np.int64), indptr),
                shape=(self.mesh.n_dof, self.mesh.n_dof),
            )
            host_s["bsr"] = _time.time() - _t
            logger.info(
                "amg: device-operator pullback %.1fs, bsr build %.1fs",
                host_s["pullback"], host_s["bsr"],
            )
        else:
            from femcy_tpu import assembly_host

            if self._amg_raw_csr is None:
                self._amg_raw_csr = assembly_host.assemble_csr_host(
                    self.mesh, self.pattern, np.asarray(self.material.C)
                )
            zeros = np.zeros(self.mesh.n_dof)
            K_bc, _ = assembly_host.dirichlet_csr_host(
                self._amg_raw_csr, zeros, fixed_np, zeros
            )
        _t = _time.time()
        fine_graph = _fine_node_graph(self._bell_plan, fixed_np)
        host_s["fine_graph"] = _time.time() - _t
        logger.info("amg: fine node graph %.1fs", host_s["fine_graph"])
        self._amg = AlgebraicMultigrid(
            K_bc, self.mesh.dm, self.mesh.nodes, fixed_np,
            # the bell plan already holds the node adjacency: hand the
            # hierarchy its fine node graph (fully-fixed nodes isolated to
            # match the BC-eliminated operator) so it skips a full pass
            # over the fine COO entries (unused when amg_fine_theta > 0:
            # a value-based fine filter needs the real entries)
            fine_graph=fine_graph,
            fine_strength_theta=self.config.amg_fine_theta,
        )
        self._amg_fixed_key = key
        self._amg_fixed_obj = fixed
        self._amg_host_seconds = {k: round(v, 1) for k, v in host_s.items()}
        self._amg_ops = self._amg.operands()
        amg = self._amg
        cfg = self.config
        plan = self._bell_plan
        max_iters = (
            cfg.cg_max_iters if cfg.cg_max_iters > 0 else self.mesh.n_dof
        )

        def _amg_cg(values, bell_a, b, ops):
            bv = values.reshape(
                plan.n_nodes, plan.dm, plan.width, plan.dm
            ).swapaxes(1, 2) * (
                bell_a["valid"].astype(values.dtype)[:, :, None, None]
            )
            return amg.pcg_solve(
                b,
                lambda x: bell_spmv(bv, bell_a["ncol"], x),
                eps=cfg.cg_eps,
                max_iters=max_iters,
                ops=ops,
            )

        self._jit_amg_cg = jax.jit(_amg_cg)

    # ------------------------------------------------------------------ #
    # public API
    # ------------------------------------------------------------------ #
    def solve(
        self,
        inp: InpModel,
        user_dirichlet: Optional[Callable] = None,
        on_increment: Optional[Callable] = None,
        on_newton: Optional[Callable] = None,
        resume: bool = False,
    ) -> SolveReport:
        """Run the full adaptive-load-stepping analysis
        (ref: stiffnessMtrx.py:647-711).

        ``resume=True`` continues from the current (dof, time0, dt) state --
        e.g. right after ``load_checkpoint`` -- instead of restarting at t=0.
        ``on_newton(system, newton_loop, residual)`` is called after every
        Newton evaluation (the reference's ``show_newton_steps`` hook,
        stiffnessMtrx.py:663-666, 788-790).
        """
        t_start = _time.time()
        cfg = self.config
        if cfg.device_loop:
            # whole-analysis device residency: ONE program, one dispatch
            # (device_loop.py); raises on configurations it cannot express
            from femcy_tpu.device_loop import _unsupported, device_solve

            why = _unsupported(cfg, self, on_increment, on_newton)
            if why is not None:
                raise ValueError(f"device_loop: {why}")
            return device_solve(self, inp, user_dirichlet, resume=resume)
        incs = inp.time_incs
        max_time = incs["max_time"]
        min_inc = incs["min_inc"]
        max_inc = incs["max_inc"]
        if not resume:
            self.dt = incs["ini_inc"]
            self.time0 = self.time1 = 0.0
            self.dof = jnp.zeros(self.mesh.n_dof)

        patterns, tractions = bc_mod.build_neumann_patterns(self.mesh, inp.neumann_bcs)
        patterns_d = jnp.asarray(patterns)
        tractions_d = jnp.asarray(tractions)

        # static stabilization setup (config.stabilize_factor): the damping
        # matrix is the volume-lumped diagonal; the coefficient C is
        # calibrated from the first converged increment's elastic energy
        stab_on = cfg.stabilize_factor > 0.0 and self.geometric_nonlinear
        stab_energy = 0.0
        stab_c: Optional[float] = None  # calibrated (C); None until then
        if stab_on:
            if "stab_diag" not in self._arrs:
                self._arrs["stab_diag"] = self._lumped_volume_diag()
                self._arrs["stab_ref"] = self.dof
                self._arrs["stab_scale"] = jnp.zeros((), dtype=self.dof.dtype)
        elif "stab_diag" in self._arrs:
            # stabilization switched off since a previous solve: restore the
            # original jit signature
            for k in ("stab_diag", "stab_ref", "stab_scale"):
                self._arrs.pop(k, None)

        records: List[IncrementRecord] = []
        dof_old = self.dof
        # linear-extrapolation predictor state (config.predictor): the
        # previous converged solution and the time step that produced
        # dof_old from it
        dof_prev: Optional[jax.Array] = None
        dt_prev = 0.0
        kinc = -1
        success = True
        message = "converged"
        rescues = 0

        while self.time1 < max_time:
            kinc += 1
            self.time1 = min(self.time0 + self.dt, max_time)
            load_ratio = self.time1 / max_time
            if (
                cfg.predictor == "extrapolate"
                and self.geometric_nonlinear
                and dof_prev is not None
                and dt_prev > 0.0
            ):
                alpha = (self.time1 - self.time0) / dt_prev
                self.dof = dof_old + alpha * (dof_old - dof_prev)
            if cfg.verbose:
                logger.info(
                    "kinc=%d time0=%.6g dt=%.6g", kinc, self.time0, self.dt
                )

            fixed, sval = bc_mod.build_dirichlet_arrays(
                inp.dirichlet_bcs, self.mesh, self.time1, load_ratio, user_dirichlet
            )
            fixed_d = jnp.asarray(fixed)
            sval_d = jnp.asarray(sval)
            self._last_dirichlet = (fixed_d, sval_d)
            if patterns.shape[0]:
                rhs = jnp.einsum("b,bn->n", tractions_d * load_ratio, patterns_d)
            else:
                rhs = jnp.zeros(self.mesh.n_dof)
            if stab_on:
                self._arrs["stab_ref"] = dof_old
                scale_now = (
                    0.0 if stab_c is None  # calibration increment: undamped
                    else stab_c / (self.time1 - self.time0)
                )
                self._arrs["stab_scale"] = jnp.asarray(
                    scale_now, dtype=self.dof.dtype
                )
            self._host_bc = None
            if cfg.mixed_precision_refine:
                # f64 host copies feed the refinement's exact residual
                # (linear: _refine_linear_solve; nonlinear: _newton_refine)
                rhs_np = (
                    (tractions * load_ratio) @ patterns
                    if patterns.shape[0]
                    else np.zeros(self.mesh.n_dof)
                )
                self._host_bc = (rhs_np, fixed, sval)

            converged, newton_loops, res = self._advance_inc(
                rhs, fixed_d, sval_d, on_newton
            )

            if not converged:
                # cut back (ref: stiffnessMtrx.py:692-701)
                dof_trial = self.dof  # the failed trial state, pre-rollback
                self.time1 = self.time0
                self.dt *= cfg.dt_cutback
                self.dof = dof_old
                kinc -= 1
                records.append(
                    IncrementRecord(kinc + 1, self.time0, self.dt, newton_loops, res, False)
                )
                if self.dt < min_inc:
                    if (
                        cfg.dynamic_rescue
                        and self.geometric_nonlinear
                        and rescues < cfg.dynamic_max_rescues
                    ):
                        # sharded runs ride the same path: the Newmark
                        # inertia term flows through the stab_* operands,
                        # which both sharded newton_evals implement; only
                        # the one-off pseudo-time-scale probe
                        # (_tangent_diag_host) runs single-device
                        # implicit-dynamics traversal (config.dynamic_rescue):
                        # hold the schedule just past the failure point and
                        # integrate the snap in pseudo-time
                        rescues += 1
                        step_dt = (
                            cfg.dynamic_rescue_dt * max_time
                            if cfg.dynamic_rescue_dt > 0.0
                            else incs["ini_inc"]
                        )
                        t_resc = min(self.time0 + step_dt, max_time)
                        lr = t_resc / max_time
                        fixed_r, sval_r = bc_mod.build_dirichlet_arrays(
                            inp.dirichlet_bcs, self.mesh, t_resc, lr,
                            user_dirichlet,
                        )
                        fixed_rd = jnp.asarray(fixed_r)
                        sval_rd = jnp.asarray(sval_r)
                        self._last_dirichlet = (fixed_rd, sval_rd)
                        rhs_r = (
                            jnp.einsum(
                                "b,bn->n", tractions_d * lr, patterns_d
                            )
                            if patterns.shape[0]
                            else jnp.zeros(self.mesh.n_dof)
                        )
                        logger.warning(
                            "static increment failed at t=%.6g; attempting "
                            "implicit-dynamics traversal to t=%.6g "
                            "(rescue %d/%d)",
                            self.time0, t_resc, rescues,
                            cfg.dynamic_max_rescues,
                        )
                        ok, nsteps, detail = self._dynamic_traverse(
                            rhs_r, fixed_rd, sval_rd, on_newton
                        )
                        if ok:
                            logger.warning(
                                "dynamic rescue at t=%.6g -> %.6g: %s; "
                                "resuming statics",
                                self.time0, t_resc, detail,
                            )
                            self.time0 = self.time1 = t_resc
                            self.dt = incs["ini_inc"]
                            dof_old = self.dof
                            dof_prev, dt_prev = None, 0.0
                            kinc += 1
                            records.append(
                                IncrementRecord(
                                    kinc, t_resc, self.dt, nsteps, 0.0, True
                                )
                            )
                            if cfg.checkpoint_path:
                                self._write_checkpoint(
                                    cfg.checkpoint_path, kinc
                                )
                            if on_increment is not None:
                                on_increment(self, records[-1])
                            continue
                        logger.warning("%s", detail)
                        message_extra = "; " + detail
                    else:
                        message_extra = ""
                    success = False
                    message = (
                        "allowable minimum dt reached; Newton's method did not "
                        "converge"
                    )
                    if cfg.diagnose_failure:
                        diag = self._diagnose_failure(dof_trial, fixed_d, sval_d)
                        if diag:
                            message += "; " + diag
                    message += message_extra
                    logger.warning(message)
                    break
                continue

            # grow dt after fast convergence (ref: stiffnessMtrx.py:702-704)
            if newton_loops <= cfg.newton_fast_iters:
                self.dt = min(self.dt * cfg.dt_growth, max_inc)
            if stab_on:
                du_inc = np.asarray(self.dof) - np.asarray(dof_old)
                mduu = float(
                    np.sum(np.asarray(self._arrs["stab_diag"]) * du_inc * du_inc)
                )
                if stab_c is None:
                    # calibrate C so this increment WOULD have dissipated
                    # stabilize_factor x its elastic energy (Abaqus's
                    # dissipated-energy-fraction scheme, constant factor)
                    elas0 = abs(self.elastic_energy())
                    if mduu > 0.0 and elas0 > 0.0:
                        stab_c = (
                            cfg.stabilize_factor * elas0
                            * (self.time1 - self.time0) / mduu
                        )
                        logger.info(
                            "stabilization calibrated: C=%.3e "
                            "(dissipated-energy fraction %.1e)",
                            stab_c, cfg.stabilize_factor,
                        )
                else:
                    # dissipated energy of this increment: f_damp . du
                    stab_energy += float(self._arrs["stab_scale"]) * mduu
            dof_prev, dt_prev = dof_old, self.time1 - self.time0
            dof_old = self.dof
            self.time0 = self.time1
            records.append(
                IncrementRecord(kinc, self.time1, self.dt, newton_loops, res, True)
            )
            if cfg.checkpoint_path:
                self._write_checkpoint(cfg.checkpoint_path, kinc)
            if on_increment is not None:
                on_increment(self, records[-1])

        if stab_on and success and stab_energy > 0.0:
            elas = abs(self.elastic_energy())
            if stab_energy > cfg.stabilize_energy_warn * max(elas, 1e-300):
                logger.warning(
                    "stabilization dissipated %.3e of energy (%.1f%% of the "
                    "elastic energy %.3e) -- the viscous bias is NOT small; "
                    "reduce stabilize_factor",
                    stab_energy, 100.0 * stab_energy / max(elas, 1e-300), elas,
                )
        return SolveReport(
            success=success,
            increments=records,
            wall_time=_time.time() - t_start,
            message=message,
            stabilization_energy=stab_energy,
        )

    # ------------------------------------------------------------------ #
    def _advance_inc(self, rhs, fixed, sval, on_newton=None):
        """One load increment (ref: stiffnessMtrx.py:714-822).

        Returns (converged, newton_loops, final residual).
        """
        cfg = self.config
        sh = self._shard_sys
        if sh is not None and hasattr(sh, "new_increment"):
            # refresh per-increment solver caches (e.g. the banded
            # block-Jacobi preconditioner, parallel/banded.py)
            sh.new_increment()
        if not self.geometric_nonlinear:
            if sh is not None:
                with self.timer.section("sharded_linear"):
                    x, _ = sh.solve(
                        np.asarray(rhs), np.asarray(fixed), np.asarray(sval)
                    )
                self.dof = jnp.asarray(x)
                return True, 0, 0.0
            if cfg.mixed_precision_refine and self._host_bc is not None:
                with self.timer.section("refine_solve"):
                    self.dof = self._refine_linear_solve(
                        *self._host_bc, fixed, sval
                    )
                self._last_vol = self._arrs["vol0"]
                return True, 0, 0.0
            with self.timer.section("assemble+bc"):
                values, rhs_bc, vol = self._jit_linear_system(
                    self._arrs, rhs, fixed, sval
                )
            with self.timer.section("linear_solve"):
                self.dof = self._solve_linear_system(values, rhs_bc, fixed)
            self._last_vol = vol
            return True, 0, 0.0

        # --- Newton-Raphson with boost/relax line search --------------------
        # The loop below drives three mode-dependent callables: evaluate
        # (residual/Jacobian), lin_solve (the Newton linear solve) and
        # finish (persist the working dof into self.dof).  In sharded mode
        # the working dof/values/residual are (D, local_rows[, K]) slab
        # blocks and every device step is a shard_map program; the state
        # machine itself (exact reference heuristics) is identical.
        newton_count = {"n": -1}

        if sh is not None:
            rhs_s = sh.stack(np.asarray(rhs))
            fixed_np = np.asarray(fixed)
            fixed_s = sh.stack(fixed_np)
            sval_s = sh.stack(np.asarray(sval))
            dof0 = sh.stack(np.asarray(self.dof))
            # stabilization under sharding: stack the diagonal/reference
            # blocks per increment (stab_ref changes every increment) and
            # ship the calibrated scale as a replicated (1,) operand
            stab_s = None
            if "stab_diag" in self._arrs:
                stab_s = (
                    sh.stack(np.asarray(self._arrs["stab_diag"])),
                    sh.stack(np.asarray(self._arrs["stab_ref"])),
                    jnp.asarray(
                        [float(self._arrs["stab_scale"])], self.dof.dtype
                    ),
                )

            def evaluate(dof):
                with self.timer.section("newton_eval"):
                    dof, values, residual, res = sh.newton_eval(
                        dof, rhs_s, fixed_s, sval_s, stab_s=stab_s
                    )
                newton_count["n"] += 1
                if on_newton is not None:
                    self.dof = jnp.asarray(sh.unstack(dof))
                    on_newton(self, newton_count["n"], float(res))
                return dof, values, residual, float(res)

            def lin_solve(values, residual, reuse=None):
                with self.timer.section("linear_solve"):
                    du, iters, rmax = sh.cg(values, residual, fixed_np, fixed_s)
                self._warn_cg_cap(iters, rmax, residual)
                return du

            def finish(dof):
                self.dof = jnp.asarray(sh.unstack(dof))

        elif cfg.fused_newton:
            # one program per iteration: the fused step is both the
            # evaluator (res) and the solver (du rides in the "values" slot;
            # lin_solve just unwraps it) -- config.fused_newton
            dof0 = self.dof

            def evaluate(dof):
                with self.timer.section("fused_step"):
                    dof, du, res, vol = self._jit_fused_step(
                        self._arrs, dof, rhs, fixed, sval
                    )
                self._last_vol = vol
                newton_count["n"] += 1
                if on_newton is not None:
                    self.dof = dof
                    on_newton(self, newton_count["n"], float(res))
                return dof, du, None, float(res)

            def lin_solve(du, residual, reuse=None):
                return du

            def finish(dof):
                self.dof = dof

        else:
            dof0 = self.dof

            def evaluate(dof):
                with self.timer.section("newton_eval"):
                    dof, values, residual, res, vol = self._jit_newton_eval(
                        self._arrs, dof, rhs, fixed, sval
                    )
                self._last_vol = vol
                newton_count["n"] += 1
                if on_newton is not None:
                    self.dof = dof  # expose current state to the callback
                    on_newton(self, newton_count["n"], float(res))
                return dof, values, residual, float(res)

            def lin_solve(values, residual, reuse=None):
                with self.timer.section("linear_solve"):
                    return self._solve_linear_system(
                        values, residual, fixed, reuse=reuse
                    )

            def finish(dof):
                self.dof = dof

        converged, newton_loop, residual_val, self._ini_residual = run_newton(
            dof0, evaluate, lin_solve, finish, cfg, self._ini_residual
        )
        if (
            converged
            and cfg.mixed_precision_refine
            and self.geometric_nonlinear
            and sh is None
            and self._host_bc is not None
        ):
            if cfg.fused_newton:
                if not getattr(self, "_warned_fused_refine", False):
                    logger.warning(
                        "mixed_precision_refine is skipped under "
                        "fused_newton (no host residual hook in the fused "
                        "program); use the standard Newton path"
                    )
                    self._warned_fused_refine = True
            else:
                with self.timer.section("newton_refine"):
                    self._newton_refine(rhs, fixed, sval)
        return converged, newton_loop, residual_val

    # ------------------------------------------------------------------ #
    # implicit-dynamics snap traversal (config.dynamic_rescue; no
    # reference counterpart -- the reference can only abort,
    # stiffnessMtrx.py:698-701)
    # ------------------------------------------------------------------ #
    def _lumped_volume_diag(self):
        """Unit-density volume-lumped nodal diagonal, one entry per dof:
        each element spreads its volume equally over its nodes.  Serves as
        the damping matrix of ``stabilize_factor`` and the mass matrix of
        ``dynamic_rescue`` (the absolute scale cancels against the
        respective calibrated coefficient / pseudo-time step)."""
        ev = np.asarray(self._arrs["vol0"]).sum(axis=1)
        nodal = np.zeros(self.mesh.n_nodes)
        np.add.at(
            nodal,
            self.mesh.elements.reshape(-1),
            np.repeat(ev / self.mesh.element.n_nodes,
                      self.mesh.element.n_nodes),
        )
        return jnp.asarray(
            np.repeat(nodal, self.mesh.dm), dtype=self.dof.dtype
        )

    def _tangent_diag_host(self, rhs, fixed_d, sval_d) -> np.ndarray:
        """Diagonal of the BC-treated Newton tangent at the current state
        (host copy).  Used to pick the Newmark pseudo-time scale so the
        inertia term M/(beta h^2) initially matches the stiffness."""
        _, values, _, _, _ = self._jit_newton_eval(
            self._arrs, self.dof, rhs, fixed_d, sval_d
        )
        if self.dia is not None:
            d = values[:, self.dia.diag_idx]
        else:
            d = values.reshape(-1)[self._arrs["diag_slot"]]
        return np.asarray(d)

    def _dynamic_traverse(
        self, rhs, fixed_d, sval_d, on_newton
    ) -> Tuple[bool, int, str]:
        """Traverse a within-increment snap with implicit dynamics.

        Loads and Dirichlet values are HELD at the target time (the caller
        builds ``rhs``/``fixed_d``/``sval_d`` there); the mesh gets a
        unit-density lumped mass and Newmark-beta with numerical
        dissipation (gamma > 1/2, beta = (gamma + 1/2)^2/4) integrates the
        jump in pseudo-time until the kinetic energy decays below
        ``config.dynamic_settle_tol`` of the elastic energy, after which a
        pure static Newton polish confirms the far-side equilibrium.  Each
        Newmark step rides the existing Newton machinery: the effective
        residual/tangent contribution (u - u_pred) * M/(beta h^2) is exactly
        the ``stab_*`` hook of ``_newton_eval_impl``.

        Returns (settled, n_steps, detail).  The system's ``dof`` holds the
        settled state on success and is rolled back to the entry state on
        failure."""
        cfg = self.config
        gamma = cfg.dynamic_gamma
        beta = 0.25 * (gamma + 0.5) ** 2
        u_entry = self.dof

        had_keys = "stab_diag" in self._arrs
        saved = {
            k: self._arrs.get(k)
            for k in ("stab_diag", "stab_ref", "stab_scale")
        }
        if had_keys:
            # a huge leftover stabilization scale (C/dt at dt -> min_inc)
            # would corrupt the stiffness probe below
            self._arrs["stab_scale"] = jnp.zeros((), dtype=self.dof.dtype)
            self._arrs["stab_ref"] = u_entry

        def _restore():
            if had_keys:
                for k, v in saved.items():
                    self._arrs[k] = v
            else:
                for k in ("stab_diag", "stab_ref", "stab_scale"):
                    self._arrs.pop(k, None)

        # pseudo-time scale: M/(beta h0^2) ~ diag(K) at the median free dof,
        # i.e. the first step is strongly inertia-regularized; the adaptive
        # growth below relaxes it as the structure settles
        kdiag = self._tangent_diag_host(rhs, fixed_d, sval_d)
        m = self._lumped_volume_diag()
        m_np = np.asarray(m)
        free = ~np.asarray(fixed_d)
        ratio = kdiag[free] / np.maximum(m_np[free], 1e-300)
        w2 = float(np.median(ratio))
        if not np.isfinite(w2) or w2 <= 0.0:
            _restore()
            return False, 0, "dynamic rescue: degenerate stiffness/mass ratio"
        h0 = 1.0 / math.sqrt(beta * w2)
        h = h0
        self._arrs["stab_diag"] = m

        def _polish(u):
            """Static Newton at the settled state: scale=0 turns the
            Newmark evaluation into pure statics (same jit signature, so
            no recompile).  The TRUE acceptance gate -- kinetic energy
            alone can accept a state outside any static basin."""
            self._arrs["stab_scale"] = jnp.zeros((), dtype=u.dtype)
            self._arrs["stab_ref"] = u
            self.dof = u
            conv, _, _ = self._advance_inc(rhs, fixed_d, sval_d, on_newton)
            return conv

        u = u_entry
        v = jnp.zeros_like(u)
        acc = jnp.zeros_like(u)
        notfix = jnp.asarray(free, dtype=u.dtype)
        steps = 0
        attempts = 0
        settled = 0
        settle_tol = cfg.dynamic_settle_tol
        polish_fails = 0
        e_kin = np.inf
        while steps < cfg.dynamic_max_steps:
            attempts += 1
            if attempts > 4 * cfg.dynamic_max_steps or h < 1e-8 * h0:
                self.dof = u_entry
                _restore()
                return False, steps, (
                    "dynamic rescue: Newmark Newton could not converge "
                    f"(h collapsed to {h:.3e} of h0={h0:.3e})"
                )
            pred = u + h * v + (0.5 - beta) * h * h * acc
            self._arrs["stab_ref"] = pred
            self._arrs["stab_scale"] = jnp.asarray(
                1.0 / (beta * h * h), dtype=u.dtype
            )
            self.dof = u
            converged, loops, _res = self._advance_inc(
                rhs, fixed_d, sval_d, on_newton
            )
            if not converged:
                self.dof = u
                h *= 0.25
                continue
            steps += 1
            u_new = self.dof
            # prescribed dofs move by pin_dof, not by dynamics: their
            # fictitious acceleration must not pollute the energy budget
            a_new = notfix * (u_new - pred) / (beta * h * h)
            v = notfix * (v + h * ((1.0 - gamma) * acc + gamma * a_new))
            acc = a_new
            u = u_new
            e_kin = 0.5 * float(jnp.sum(m * v * v))
            e_el = abs(self.elastic_energy())
            if cfg.verbose or steps % 25 == 0:
                logger.info(
                    "rescue step %d: h/h0=%.2e E_kin/E_elas=%.2e",
                    steps, h / h0, e_kin / max(e_el, 1e-300),
                )
            if e_kin < settle_tol * max(e_el, 1e-300):
                settled += 1
                if settled >= 2:
                    if _polish(u):
                        _restore()
                        return True, steps, (
                            f"settled in {steps} Newmark steps"
                            + (
                                f" ({polish_fails} settle(s) rejected by "
                                "the static polish)"
                                if polish_fails
                                else ""
                            )
                        )
                    # settled kinetically but not statically: tighten the
                    # settle tolerance and keep integrating toward the
                    # attractor (h -> inf is the static limit)
                    polish_fails += 1
                    settle_tol *= 1e-2
                    settled = 0
                    self.dof = u
                    logger.info(
                        "rescue step %d: static polish rejected the "
                        "settled state; tightening settle tol to %.1e",
                        steps, settle_tol,
                    )
            else:
                settled = 0
            if loops <= cfg.newton_fast_iters:
                # no upper cap: h must reach the FUNDAMENTAL period of the
                # snap mode (orders of magnitude above h0, which tracks the
                # median stiffness) for the gamma-dissipation to kill the
                # macroscopic swing; Newton divergence at too-large h is
                # the regulator (h *= 0.25 above)
                h *= 2.0
        self.dof = u_entry
        _restore()
        if polish_fails:
            return False, steps, (
                "dynamic rescue: settled dynamically "
                f"{polish_fails} time(s) but the static polish never "
                "converged (no static equilibrium basin reached within "
                f"{cfg.dynamic_max_steps} steps)"
            )
        return False, steps, (
            "dynamic rescue: kinetic energy did not settle within "
            f"{cfg.dynamic_max_steps} steps (E_kin/E_elas ~ "
            f"{e_kin / max(abs(self.elastic_energy()), 1e-300):.1e})"
        )

    # ------------------------------------------------------------------ #
    # failure diagnostics (config.diagnose_failure; no reference
    # counterpart -- the reference aborts with a bare message,
    # stiffnessMtrx.py:698-701)
    # ------------------------------------------------------------------ #
    def min_element_volume(self, dof=None) -> float:
        """Smallest det(J)·w over all (element, Gauss point) at the given
        configuration (default: the current ``self.dof``).  Non-positive
        means the element is inverted there -- the constitutive evaluation
        is meaningless and no time step is small enough to fix it."""
        dof = self.dof if dof is None else jnp.asarray(dof)
        coords = self._arrs["nodes"] + dof.reshape(-1, self.mesh.dm)
        _, vol = assembly.gradients_and_volume(
            coords, self._arrs["elements"], self._arrs["dN"], self._arrs["w"]
        )
        return float(jnp.min(vol))

    def tangent_min_eigenvalue(self, fixed=None, sval=None):
        """Smallest eigenvalue of the BC-constrained Newton tangent at the
        current ``self.dof`` (host shift-invert Lanczos on the free-dof
        block).  Negative or ~0 at a converged equilibrium state means a
        limit/bifurcation point (e.g. buckling): the static branch is
        unstable and load-stepped Newton cannot advance past it at any dt.
        Returns None when the tangent is numerically singular (the
        factorization itself fails -- the strongest form of the same
        verdict).  ``fixed``/``sval`` default to the last Dirichlet arrays
        applied by ``solve``."""
        import scipy.sparse.linalg as spla

        if fixed is None or sval is None:
            if self._last_dirichlet is None:
                raise ValueError(
                    "no Dirichlet state available: pass fixed/sval or call "
                    "solve() first"
                )
            fixed, sval = self._last_dirichlet
        fixed = jnp.asarray(fixed)
        sval = jnp.asarray(sval)
        zeros = jnp.zeros(self.mesh.n_dof)
        _, values, _, _, _ = self._jit_newton_eval(
            self._arrs, self.dof, zeros, fixed, sval
        )
        layout = self.dia if self.dia is not None else self.pattern
        K = layout.to_scipy(np.asarray(values))
        free = ~np.asarray(fixed, dtype=bool)
        Kf = K[free][:, free].tocsc()
        if Kf.shape[0] == 0:
            return None
        try:
            lam = spla.eigsh(
                Kf, k=1, sigma=0.0, which="LM", return_eigenvectors=False
            )
            return float(lam[0])
        except Exception as exc:  # singular splu / ARPACK breakdown
            logger.info("tangent eigenvalue probe failed: %s", exc)
            return None

    def _diagnose_failure(self, dof_trial, fixed, sval) -> str:
        """Classify WHY Newton could not converge at the minimum time step.

        Two mechanical causes dominate in practice:

        - **element inversion**: det(J) <= 0 at some Gauss point of the
          trial configuration (typically driven there by prescribed
          displacements or a snapped-through trial step) -- re-mesh or
          reduce the load schedule;
        - **loss of positive definiteness** of the constrained tangent at
          the last CONVERGED state: a limit or bifurcation point.  Cutting
          dt is futile; use Riks arc-length (solvers/riks.py) for
          load-driven folds, static stabilization (stabilize_factor) for
          local instabilities, or stop the schedule at the instability.

        A third class reports itself by elimination: the tangent is
        positive definite at the converged state, nothing inverts, yet
        Newton diverges for arbitrarily small dt -- a snap that develops
        WITHIN the increment (e.g. the C3D10 twist plate at 174.55 degrees,
        lambda_min ~ 8e9 at the converged state; measured to survive line
        search, extrapolation and stabilization -- see PARITY.md).  Crossing
        such an event needs inertia (dynamics) or contact.
        """
        parts = []
        try:
            vmin = self.min_element_volume(dof_trial)
            if np.isnan(vmin):
                parts.append("trial state diverged to NaN")
            elif vmin <= 0.0:
                parts.append(
                    "element inversion at the trial configuration "
                    f"(min det(J)w = {vmin:.3e})"
                )
        except Exception as exc:  # diagnostics must never mask the abort
            logger.info("element-volume probe failed: %s", exc)
        if (
            self._shard_sys is None
            and self.mesh.n_dof <= self.config.diagnose_eig_max_dof
        ):
            try:
                lam = self.tangent_min_eigenvalue(fixed, sval)
            except Exception as exc:
                logger.info("tangent eigenvalue probe failed: %s", exc)
                lam = False  # sentinel: skip reporting
            if lam is None:
                parts.append(
                    "tangent stiffness numerically singular at the last "
                    "converged state: limit/bifurcation point -- consider "
                    "Riks arc-length, static stabilization "
                    "(stabilize_factor), or stopping the schedule here"
                )
            elif lam is not False:
                if lam <= 0.0:
                    parts.append(
                        "tangent stiffness not positive definite at the last "
                        f"converged state (lambda_min = {lam:.3e}): "
                        "limit/bifurcation point -- the static branch is "
                        "unstable; consider Riks arc-length, static "
                        "stabilization (stabilize_factor), or stopping the "
                        "schedule here"
                    )
                elif not parts:
                    parts.append(
                        "tangent positive definite at the last converged "
                        f"state (lambda_min = {lam:.3e}); Newton divergence "
                        "without inversion or instability at the converged "
                        "state -- the instability develops WITHIN the "
                        "increment (within-increment snap; see PARITY.md)"
                    )
        return "; ".join(parts)

    # ------------------------------------------------------------------ #
    # post-processing (ref: stiffnessMtrx.py:436-606)
    # ------------------------------------------------------------------ #
    def deformation_gradient(self):
        return self._jit_F(self._arrs, self.dof)

    def _strain_stress_impl(self, a, dof):
        """(strain, stress, mises) as ONE program -- eager, these would be
        ~40 small dispatches."""
        F = self._deformation_gradient_impl(a, dof)
        dm = self.mesh.dm
        eye = jnp.eye(dm)
        if self.geometric_nonlinear:
            strain = (jnp.swapaxes(F, -1, -2) @ F - eye) / 2.0
            stress = assembly.gp_stress(F, self.material, large=True)
        else:
            strain = (F + jnp.swapaxes(F, -1, -2)) / 2.0 - eye
            stress = assembly.gp_stress(F, self.material, large=False)
        mises = mises_stress(stress, self.material)
        return strain, stress, mises

    def compute_strain_stress(self):
        """(strain, cauchy stress, mises) at every (element, GP)."""
        if self._jit_strain_stress is None:
            self._jit_strain_stress = jax.jit(self._strain_stress_impl)
        return self._jit_strain_stress(self._arrs, self.dof)

    def _energy_impl(self, a, dof, vol):
        F = self._deformation_gradient_impl(a, dof)
        dens = assembly.gp_energy_density(F, self.material)
        return jnp.sum(dens * vol)

    def elastic_energy(self):
        """Total elastic energy = sum psi(F) * vol
        (ref: stiffnessMtrx.py:592-606, integrated over the most recently
        assembled configuration's volumes)."""
        vol = self._last_vol
        if self._shard_sys is not None and self.geometric_nonlinear:
            # the sharded path never materialises a global volume array;
            # integrate over the current configuration (what the last
            # sharded evaluation used)
            coords = self._arrs["nodes"] + self.dof.reshape(-1, self.mesh.dm)
            if self._structured_plan is not None:
                from femcy_tpu.structured import structured_element_nodes

                x_e = structured_element_nodes(coords, self.mesh)
                _, vol = assembly.gradients_and_volume_x(
                    x_e, self._arrs["dN"], self._arrs["w"]
                )
            else:  # sharding="banded": general connectivity gather
                _, vol = _gradients_jit(
                    coords, self._arrs["elements"],
                    self._arrs["dN"], self._arrs["w"],
                )
        if self._jit_energy is None:
            self._jit_energy = jax.jit(self._energy_impl)
        return float(self._jit_energy(self._arrs, self.dof, vol))

    def extrapolate(self, gp_vals):
        """GP -> nodal patch extrapolation, (E, G) -> (E, n_nodes)
        (ref: per-element extrapolate kernels)."""
        M = jnp.asarray(self.mesh.element.extrapolation_matrix)
        return gp_vals @ M.T

    # ------------------------------------------------------------------ #
    def _write_checkpoint(self, path: str, kinc: int):
        if not path.endswith(".npz"):
            path = path + ".npz"
        np.savez(
            path,
            dof=np.asarray(self.dof),
            time0=self.time0,
            dt=self.dt,
            kinc=kinc,
            # nan when unset; restored so newton_residual_ref='global' gates
            # identically across a resume (the reference's cache is
            # process-lifetime, stiffnessMtrx.py:760-762)
            ini_residual=(
                np.nan if self._ini_residual is None else self._ini_residual
            ),
        )

    def load_checkpoint(self, path: str):
        if not path.endswith(".npz"):
            path = path + ".npz"
        data = np.load(path)
        self.dof = jnp.asarray(data["dof"])
        self.time0 = self.time1 = float(data["time0"])
        self.dt = float(data["dt"])
        if "ini_residual" in data:
            ini = float(data["ini_residual"])
            self._ini_residual = None if np.isnan(ini) else ini


def mises_stress(stress, material: Material):
    """Von Mises stress per (element, GP), with the material-type-specific
    out-of-plane treatment (ref: stiffnessMtrx.py:457-501)."""
    if material.type == "planeStress":
        s33 = jnp.zeros_like(stress[..., 0, 0])
    elif material.type == "planeStrain":
        s33 = material.poisson_ratio * (stress[..., 0, 0] + stress[..., 1, 1])
    else:
        s = stress
        dev = s - jnp.trace(s, axis1=-2, axis2=-1)[..., None, None] / 3.0 * jnp.eye(3)
        return jnp.sqrt(1.5 * jnp.sum(dev * dev, axis=(-2, -1)))
    s3 = jnp.zeros(stress.shape[:-2] + (3, 3))
    s3 = s3.at[..., :2, :2].set(stress)
    s3 = s3.at[..., 2, 2].set(s33)
    dev = s3 - jnp.trace(s3, axis1=-2, axis2=-1)[..., None, None] / 3.0 * jnp.eye(3)
    return jnp.sqrt(1.5 * jnp.sum(dev * dev, axis=(-2, -1)))
