"""Whole-analysis device residency: the adaptive-stepping Newton analysis
as ONE XLA program (``SolverConfig.device_loop``).

The host state machine (system.py solve/_advance_inc/run_newton, mirroring
the reference stiffnessMtrx.py:647-822) dispatches one device program per
Newton evaluation, so a ~60-evaluation analysis of a small model pays ~60
dispatch latencies.  This module compiles the ENTIRE analysis -- the increment loop,
the adaptive dt cutback/growth machine, the Newton iteration with its
relaxation backtracking, and the inner CG -- into a single jitted function:
one dispatch, one (persistently cacheable) compile, zero host round-trips
until the final state is fetched.

Semantics reproduce the host machine exactly for the supported envelope
(the device program is tested against the host loop increment-for-increment,
tests/test_device_loop.py):

* adaptive stepping: time1 = min(time0+dt, max_time), load_ratio scaling,
  dt*cutback + rollback on failure, abort below min_inc, dt*growth capped
  at max_inc after fast convergence (ref: stiffnessMtrx.py:678-704);
* Newton: relative-residual tolerance against the increment's first
  unbalance (or the process-lifetime reference when
  newton_residual_ref='global', the reference's quirk at
  stiffnessMtrx.py:760-762), iteration cap, NaN abort, the reference's
  BOOST line search (keep stepping du while the residual declines,
  <= newton_boost_max times, backtrack+halve when it worsens; ref:
  stiffnessMtrx.py:792-807) and relaxation backtracking (halve du while
  the residual grows, <= newton_relax_max times; ref:
  stiffnessMtrx.py:809-819) -- i.e. the full reference-parity default
  SolverConfig (secant tangent + boost) is device-resident;
* predictor: 'previous' or the linear-extrapolation predictor
  (dof_old + alpha*(dof_old - dof_prev), config.predictor='extrapolate');
* Dirichlet schedule: non-user values scale with load_ratio; ``user`` BCs
  evaluate the user callable at time1 INSIDE the traced program, so the
  callable must be traceable (jnp ops, no Python branching on time --
  user.make_rotation_dirichlet qualifies).

Unsupported (the host loop remains the general path and raises here):
stabilization, dynamic rescue, sharding, mixed-precision refinement, host
direct solves, and per-increment callbacks/checkpoints.
"""

from __future__ import annotations

import time as _time
from typing import Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from femcy_tpu import bc as bc_mod


def _unsupported(cfg, system, on_increment, on_newton) -> Optional[str]:
    """Why the device loop cannot run this configuration (None if it can)."""
    if not system.geometric_nonlinear:
        return "device_loop covers geometric-nonlinear analyses (the linear path is already a single program)"
    if system._shard_sys is not None:
        return "device_loop is single-device (sharding='none')"
    if cfg.stabilize_factor > 0.0:
        return "device_loop does not support stabilize_factor (calibration is host-side)"
    if cfg.dynamic_rescue:
        return "device_loop does not support dynamic_rescue"
    if cfg.mixed_precision_refine:
        return "device_loop does not support mixed_precision_refine"
    if on_increment is not None or on_newton is not None:
        return "device_loop cannot invoke per-increment/per-Newton host callbacks"
    return None


class DeviceLoopProgram:
    """Builds and caches the one-program analysis for a FEMSystem."""

    def __init__(self, system, inp, user_dirichlet: Optional[Callable]):
        self.system = system
        cfg = system.config
        mesh = system.mesh
        dtype = system.dof.dtype

        # --- Dirichlet schedule (traceable) --------------------------------
        # Non-user BCs: value * load_ratio.  User BCs: callable(nodes, dof,
        # time1) traced in-program.  Application order preserved (later BCs
        # overwrite earlier ones, ref: stiffnessMtrx.py:519-529).
        entries = []
        fixed = np.zeros(mesh.n_dof, dtype=bool)
        for bc in inp.dirichlet_bcs:
            idx = bc_mod.dirichlet_dof_indices(bc, mesh.dm)
            fixed[idx] = True
            if bc.user:
                fn = user_dirichlet
                if fn is None:
                    from femcy_tpu.user import default_user_dirichlet

                    fn = default_user_dirichlet
                nodes_sub = mesh.nodes[np.asarray(bc.node_set, np.int64)]
                entries.append(("user", jnp.asarray(idx), fn, nodes_sub, bc.dof))
            else:
                entries.append(("scale", jnp.asarray(idx), float(bc.value)))
        self._entries = entries
        self.fixed = jnp.asarray(fixed)

        patterns, tractions = bc_mod.build_neumann_patterns(
            mesh, inp.neumann_bcs
        )
        rhs_base = (
            tractions @ patterns if patterns.shape[0] else np.zeros(mesh.n_dof)
        )
        self.rhs_base = jnp.asarray(rhs_base, dtype=dtype)

        incs = inp.time_incs
        self.max_time = float(incs["max_time"])
        self.min_inc = float(incs["min_inc"])
        self.max_inc = float(incs["max_inc"])
        self.ini_inc = float(incs["ini_inc"])
        self.max_records = int(cfg.device_loop_max_records)
        self._jit = jax.jit(self._run_impl)
        self._jit_post = None  # lazily-jitted final (sval, vol) recovery

    # ------------------------------------------------------------------ #
    def _build_sval(self, time1, load_ratio):
        sval = jnp.zeros(self.system.mesh.n_dof, dtype=self.system.dof.dtype)
        for e in self._entries:
            if e[0] == "user":
                _, idx, fn, nodes_sub, dof_dim = e
                vals = fn(nodes_sub, dof_dim, time1)
            else:
                _, idx, value = e
                vals = jnp.full(idx.shape, value) * load_ratio
            sval = sval.at[idx].set(vals.astype(sval.dtype))
        return sval

    def _lin_solve(self, a, values, residual):
        """The in-program Newton linear solve (same dispatch as
        _fused_step_impl: dense CG below dense_operator_max_dof, else the
        DIA or ELL Jacobi-PCG)."""
        sy = self.system
        cfg = sy.config
        if sy._use_dense_cg:
            du, _, _ = sy._dense_cg_core(
                values, residual, None if sy.dia is not None else a["colidx"]
            )
        elif sy.dia is not None:
            from femcy_tpu.solvers.dia import dia_pcg_solve

            du, _, _ = dia_pcg_solve(
                values, sy.dia.offsets, sy.dia.diag_idx, residual,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
                block_dm=(
                    sy.mesh.dm if cfg.preconditioner == "block_jacobi" else 0
                ),
                spmv=sy._spmv,
            )
        else:
            from femcy_tpu.solvers.cg import pcg_solve

            du, _, _ = pcg_solve(
                values, a["colidx"], a["diag_slot"], residual,
                eps=cfg.cg_eps, max_iters=cfg.cg_max_iters,
            )
        return du

    def _newton(self, a, dof0, rhs, fixed, sval, ini_cache):
        """The Newton loop of one increment as a lax.while_loop.

        Matches run_newton (system.py:83-182, ref: stiffnessMtrx.py:756-822):
        evaluate -> solve -> update -> boost line search (keep stepping du
        while the residual declines into (0.1*pre, pre), backtrack + halve
        the step when it worsens) -> relaxation backtracking (halve du
        while the residual grows) -> converge on res/ini < rel_tol.

        ``ini_cache`` is the process-lifetime initial-residual carry (NaN
        until set; the reference quirk at stiffnessMtrx.py:760-762).  With
        newton_residual_ref='global' convergence is measured against it,
        otherwise against this increment's first unbalance.

        Returns (dof, solves, res, converged, ini_cache).
        """
        sy = self.system
        cfg = sy.config
        dof0, res0 = sy._residual_rms_impl(a, dof0, rhs, fixed, sval)
        ini_cache = jnp.where(jnp.isnan(ini_cache), res0, ini_cache)
        ini = ini_cache if cfg.newton_residual_ref == "global" else res0
        tiny = jnp.asarray(1.0e-30, res0.dtype)

        def cond(st):
            dof, pre, k, fail = st
            return (
                (~fail)
                & (pre / (ini + tiny) >= cfg.newton_rel_tol)
                & (k < cfg.newton_max_iters)
                & (ini >= cfg.newton_abs_tol)
            )

        def body(st):
            dof, pre, k, fail = st
            dof, values, residual, _res, _vol = sy._newton_eval_impl(
                a, dof, rhs, fixed, sval
            )
            du = self._lin_solve(a, values, residual)
            dof1 = dof - du
            _, res1 = sy._residual_rms_impl(a, dof1, rhs, fixed, sval)

            # boost line search (ref: stiffnessMtrx.py:792-807): while the
            # residual declined into (0.1*pre, pre), keep stepping
            # relaxation*du; when a step worsens it, undo and halve the
            # relaxation.  The host's undo is dof += relaxation*du followed
            # by a re-evaluation; keeping the pre-step (dof, residual) pair
            # is the same state to fp round-off without the extra probe.
            if cfg.newton_boost_max > 0:

                def bcond(bst):
                    d, relax, r, n = bst
                    return (
                        (0.1 * pre < r)
                        & (r < pre)
                        & (n < cfg.newton_boost_max)
                    )

                def bbody(bst):
                    d, relax, r, n = bst
                    d2 = d - relax * du
                    _, r2 = sy._residual_rms_impl(a, d2, rhs, fixed, sval)
                    worse = r2 > r
                    d = jnp.where(worse, d, d2)
                    r = jnp.where(worse, r, r2)
                    relax = jnp.where(worse, 0.5 * relax, relax)
                    return d, relax, r, n + jnp.int32(1)

                dof1, _, res1, _ = jax.lax.while_loop(
                    bcond,
                    bbody,
                    (
                        dof1,
                        jnp.asarray(1.0, res1.dtype),
                        res1,
                        jnp.int32(0),
                    ),
                )

            # relaxation backtracking (ref: stiffnessMtrx.py:809-819):
            # while the residual grew, undo half the step and retry
            def rcond(rst):
                d, u, r, n = rst
                return (r > pre) & (n < cfg.newton_relax_max)

            def rbody(rst):
                d, u, r, n = rst
                d = d + 0.5 * u
                u = 0.5 * u
                _, r = sy._residual_rms_impl(a, d, rhs, fixed, sval)
                return d, u, r, n + jnp.int32(1)

            dof1, du, res1, _ = jax.lax.while_loop(
                rcond, rbody, (dof1, du, res1, jnp.int32(0))
            )
            fail = ~jnp.isfinite(res1)
            return dof1, res1, k + jnp.int32(1), fail

        dof, res, k, fail = jax.lax.while_loop(
            cond, body, (dof0, res0, jnp.int32(0), jnp.asarray(False))
        )
        converged = (~fail) & (
            (res / (ini + tiny) < cfg.newton_rel_tol)
            | (ini < cfg.newton_abs_tol)
        )
        return dof, k, res, converged, ini_cache

    # ------------------------------------------------------------------ #
    def _run_impl(self, a, dof, time0, dt, ini_res):
        """The full analysis.  Status: 0 running, 1 success, 2 dt-underflow
        failure, 3 record-capacity abort.  ``ini_res`` is the
        process-lifetime initial-residual cache (NaN when unset)."""
        cfg = self.system.config
        fixed = self.fixed
        maxrec = self.max_records
        ftype = dof.dtype
        rec_time = jnp.zeros(maxrec, ftype)
        rec_dt = jnp.zeros(maxrec, ftype)
        rec_iters = jnp.zeros(maxrec, jnp.int32)
        rec_res = jnp.zeros(maxrec, ftype)
        rec_conv = jnp.zeros(maxrec, jnp.bool_)

        state = dict(
            dof=dof, dof_old=dof,
            # linear-extrapolation predictor carries (system.py:1179-1200):
            # the previous converged solution and the dt that produced
            # dof_old from it (0 until two increments have converged)
            dof_prev=dof, dt_prev=jnp.asarray(0.0, ftype),
            ini_res=jnp.asarray(ini_res, ftype),
            time0=jnp.asarray(time0, ftype), dt=jnp.asarray(dt, ftype),
            status=jnp.int32(0), nrec=jnp.int32(0),
            rec_time=rec_time, rec_dt=rec_dt, rec_iters=rec_iters,
            rec_res=rec_res, rec_conv=rec_conv,
        )

        def cond(st):
            return st["status"] == 0

        def body(st):
            time1 = jnp.minimum(st["time0"] + st["dt"], self.max_time)
            load_ratio = time1 / self.max_time
            sval = self._build_sval(time1, load_ratio)
            rhs = load_ratio * self.rhs_base
            dof_start = st["dof"]
            if cfg.predictor == "extrapolate":
                # dof_old + alpha*(dof_old - dof_prev), gated until two
                # converged increments exist (system.py:1193-1200)
                alpha = (time1 - st["time0"]) / jnp.where(
                    st["dt_prev"] > 0, st["dt_prev"], 1.0
                )
                dof_start = jnp.where(
                    st["dt_prev"] > 0,
                    st["dof_old"]
                    + alpha * (st["dof_old"] - st["dof_prev"]),
                    dof_start,
                )
            dof_n, k, res, conv, ini_res_n = self._newton(
                a, dof_start, rhs, fixed, sval, st["ini_res"]
            )
            # run_newton reports #solves-1 on convergence; the dt-growth
            # heuristic compares that count (ref: stiffnessMtrx.py:702-704)
            iters = jnp.maximum(k - 1, 0)
            grow = conv & (iters <= cfg.newton_fast_iters)
            dt_next = jnp.where(
                grow,
                jnp.minimum(st["dt"] * cfg.dt_growth, self.max_inc),
                jnp.where(conv, st["dt"], st["dt"] * cfg.dt_cutback),
            )
            dof_next = jnp.where(conv, dof_n, st["dof_old"])
            dof_old = jnp.where(conv, dof_n, st["dof_old"])
            # predictor state advances only on converged increments
            # (system.py:1363); cutbacks keep the previous pair
            dof_prev = jnp.where(conv, st["dof_old"], st["dof_prev"])
            dt_prev = jnp.where(conv, time1 - st["time0"], st["dt_prev"])
            time_next = jnp.where(conv, time1, st["time0"])
            done = conv & (time1 >= self.max_time)
            failed = (~conv) & (dt_next < self.min_inc)
            i = jnp.minimum(st["nrec"], maxrec - 1)
            nrec = st["nrec"] + 1
            status = jnp.where(
                done,
                jnp.int32(1),
                jnp.where(
                    failed,
                    jnp.int32(2),
                    jnp.where(nrec >= maxrec, jnp.int32(3), jnp.int32(0)),
                ),
            )
            return dict(
                dof=dof_next, dof_old=dof_old,
                dof_prev=dof_prev, dt_prev=dt_prev, ini_res=ini_res_n,
                time0=time_next, dt=dt_next,
                status=status, nrec=nrec,
                rec_time=st["rec_time"].at[i].set(time1),
                rec_dt=st["rec_dt"].at[i].set(dt_next),
                rec_iters=st["rec_iters"].at[i].set(iters),
                rec_res=st["rec_res"].at[i].set(res),
                rec_conv=st["rec_conv"].at[i].set(conv),
            )

        return jax.lax.while_loop(cond, body, state)

    # ------------------------------------------------------------------ #
    def run(self, resume: bool = False):
        """One dispatch; returns a SolveReport and updates the system."""
        from femcy_tpu.system import IncrementRecord, SolveReport

        sy = self.system
        t_start = _time.time()
        if not resume:
            sy.dt = self.ini_inc
            sy.time0 = sy.time1 = 0.0
            sy.dof = jnp.zeros(sy.mesh.n_dof)
        # the process-lifetime initial-residual cache is shared with the
        # host machine (reference quirk, stiffnessMtrx.py:760-762) so a
        # resumed/global-ref analysis measures against the same reference
        ini0 = sy._ini_residual if sy._ini_residual is not None else float("nan")
        out = self._jit(sy._arrs, sy.dof, sy.time0, sy.dt, ini0)
        status = int(out["status"])
        nrec = min(int(out["nrec"]), self.max_records)
        sy.dof = out["dof"]
        sy.time0 = sy.time1 = float(out["time0"])
        sy.dt = float(out["dt"])
        ini_out = float(out["ini_res"])
        if np.isfinite(ini_out):
            sy._ini_residual = ini_out
        # refresh _last_vol (elastic_energy integrates over it) and the
        # Dirichlet state at the final time for post-hoc diagnostics
        lr = sy.time1 / self.max_time if self.max_time else 1.0
        if self._jit_post is None:
            def _post(dof, time1, load_ratio):
                sval = self._build_sval(time1, load_ratio)
                coords = sy._arrs["nodes"] + dof.reshape(-1, sy.mesh.dm)
                from femcy_tpu import assembly

                _, vol = assembly.gradients_and_volume(
                    coords, sy._arrs["elements"], sy._arrs["dN"], sy._arrs["w"]
                )
                return sval, vol

            self._jit_post = jax.jit(_post)
        sval, sy._last_vol = self._jit_post(
            sy.dof,
            jnp.asarray(sy.time1, sy.dof.dtype),
            jnp.asarray(lr, sy.dof.dtype),
        )
        sy._last_dirichlet = (self.fixed, sval)

        records: List[IncrementRecord] = []
        rt = np.asarray(out["rec_time"])
        rdt = np.asarray(out["rec_dt"])
        rit = np.asarray(out["rec_iters"])
        rres = np.asarray(out["rec_res"])
        rconv = np.asarray(out["rec_conv"])
        kinc = -1
        for i in range(nrec):
            if rconv[i]:
                kinc += 1
            records.append(
                IncrementRecord(
                    kinc=max(kinc, 0), time=float(rt[i]), dt=float(rdt[i]),
                    newton_iters=int(rit[i]), residual=float(rres[i]),
                    converged=bool(rconv[i]),
                )
            )
        success = status == 1
        if status == 1:
            message = "converged"
        elif status == 2:
            message = (
                "allowable minimum dt reached; Newton's method did not "
                "converge"
            )
        else:
            message = (
                f"device loop hit its record capacity "
                f"({self.max_records} increments attempted); raise "
                "device_loop_max_records"
            )
        if sy.config.checkpoint_path and success:
            sy._write_checkpoint(sy.config.checkpoint_path, kinc)
        return SolveReport(
            success=success,
            increments=records,
            wall_time=_time.time() - t_start,
            message=message,
        )


def device_solve(
    system,
    inp,
    user_dirichlet: Optional[Callable] = None,
    resume: bool = False,
):
    """Entry point used by FEMSystem.solve when config.device_loop is on."""
    key = (id(inp), id(user_dirichlet))
    prog = system._device_loop_prog
    if prog is None or prog._key != key:
        prog = DeviceLoopProgram(system, inp, user_dirichlet)
        prog._key = key
        system._device_loop_prog = prog
    return prog.run(resume=resume)
