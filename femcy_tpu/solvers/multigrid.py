"""Geometric multigrid preconditioner for structured box_tets meshes.

A V-cycle over dyadically coarsened box grids, used as the preconditioner of
the CG solve.  Everything is gather-free, matching the structured fast path:

* prolongation = separable linear interpolation on the (n+1)^3 node grid
  (static slice assignments per axis), restriction = its exact transpose;
* each level's operator is the rediscretized DIA matrix from the same
  structured dense assembly, with the same Dirichlet zero-one elimination
  (faces coarsen onto faces, so the fixed masks stay consistent);
* damped-Jacobi smoothing (fixed sweep counts) keeps the cycle a fixed
  symmetric linear operator, valid inside plain PCG;
* the coarsest level is solved exactly with a precomputed dense inverse.

The reference has nothing comparable (its only solver is Jacobi-PCG,
conjugateGradientSolver.py); this is a beyond-parity scalability feature.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from femcy_tpu.materials import Material
from femcy_tpu.mesh import FEMesh
from femcy_tpu.meshgen import box_tets
from femcy_tpu.kernels import dia_spmv as spmv_kernel
from femcy_tpu.solvers.dia import (
    DIAPattern,
    build_structured_dia_pattern,
    dia_spmv,
)
from femcy_tpu.structured import (
    analytic_structured_dia_values,
    dia_dirichlet_linear_numpy,
)


def _interp_axis(u, axis: int):
    """Linear interpolation n+1 -> 2n+1 along one axis (even: copy, odd: mean)."""
    n1 = u.shape[axis]
    out_shape = list(u.shape)
    out_shape[axis] = 2 * n1 - 1
    out = jnp.zeros(out_shape, dtype=u.dtype)

    def sl(start, stop, step):
        idx = [slice(None)] * u.ndim
        idx[axis] = slice(start, stop, step)
        return tuple(idx)

    out = out.at[sl(0, None, 2)].set(u)
    lo = u[sl(0, -1, 1)]
    hi = u[sl(1, None, 1)]
    return out.at[sl(1, None, 2)].set(0.5 * (lo + hi))


def _restrict_axis(r, axis: int):
    """Exact transpose of _interp_axis: 2n+1 -> n+1 along one axis."""

    def sl(start, stop, step):
        idx = [slice(None)] * r.ndim
        idx[axis] = slice(start, stop, step)
        return tuple(idx)

    even = r[sl(0, None, 2)]
    odd = r[sl(1, None, 2)]
    pad = [(0, 0)] * r.ndim
    pad_lo = list(pad)
    pad_lo[axis] = (1, 0)
    pad_hi = list(pad)
    pad_hi[axis] = (0, 1)
    return even + 0.5 * (jnp.pad(odd, pad_lo) + jnp.pad(odd, pad_hi))


def prolong(u_coarse, grid_coarse: Tuple[int, int, int]):
    """(prod(nc+1)*3,) coarse dofs -> fine dofs on the doubled grid."""
    ncx, ncy, ncz = grid_coarse
    u = u_coarse.reshape(ncx + 1, ncy + 1, ncz + 1, 3)
    for axis in range(3):
        u = _interp_axis(u, axis)
    return u.reshape(-1)


def restrict(r_fine, grid_fine: Tuple[int, int, int]):
    """Transpose of prolong: fine dofs -> coarse dofs on the halved grid."""
    nfx, nfy, nfz = grid_fine
    r = r_fine.reshape(nfx + 1, nfy + 1, nfz + 1, 3)
    for axis in range(3):
        r = _restrict_axis(r, axis)
    return r.reshape(-1)


def newton_schulz_inverse(A, max_iters: int = 80):
    """Dense inverse by Newton-Schulz iteration X <- X (2I - A X).

    Pure matmuls, no LAPACK-style custom call: the inverse is computed on
    the device from the device operator, with no host round trip.
    Globally convergent from
    X0 = A^T / (||A||_1 ||A||_inf); quadratic once contracting, so
    ~log2(cond^2) + log2(log(1/eps)) iterations -- 80 covers cond ~ 1e9 at
    f64.  The loop exits early once ||AX - I||_max stops improving (it
    bottoms out at the dtype's precision), so well-conditioned operators
    pay only their ~30 matmul pairs.
    """
    n = A.shape[0]
    eye = jnp.eye(n, dtype=A.dtype)
    norm1 = jnp.max(jnp.sum(jnp.abs(A), axis=0))
    norminf = jnp.max(jnp.sum(jnp.abs(A), axis=1))
    X0 = A.T / (norm1 * norminf)
    r0 = jnp.max(jnp.abs(A @ X0 - eye))

    def cond(state):
        _, r, r_prev, k = state
        # the 2-norm residual contracts monotonically for SPD A, but the
        # max-norm proxy can wobble in the first steps -- only trust the
        # "stopped improving" exit once contraction is established
        return (k < max_iters) & ((k < 8) | (r < r_prev))

    def body(state):
        X, r, _, k = state
        X = X @ (2.0 * eye - A @ X)
        return X, jnp.max(jnp.abs(A @ X - eye)), r, k + 1

    X, _, _, _ = jax.lax.while_loop(
        cond, body, (X0, r0, jnp.inf * jnp.ones((), A.dtype), 0)
    )
    return X


def _gershgorin(values_host: np.ndarray, diag_idx: int) -> float:
    """Upper bound on lambda_max(D^-1 A) from the DIA row sums (host)."""
    diag = values_host[:, diag_idx]
    s = np.abs(values_host).sum(axis=1)
    d = np.where(diag > 0.0, diag, 1.0)
    return float((s / d).max())


@dataclasses.dataclass
class _Level:
    grid: Tuple[int, int, int]
    dia: DIAPattern
    values: Optional[jax.Array]  # BC-eliminated DIA operator (None at level 0:
    inv_diag: Optional[jax.Array]  # the fine operator is the caller's)
    fixed: jax.Array  # bool per dof


def coarsen_grids(
    grid: Tuple[int, int, int],
    coarsest_max_dof: int = 3000,
    n_levels: int = 0,
) -> List[Tuple[int, int, int]]:
    """Dyadic level grids fine -> coarse, or raise ValueError when the grid
    cannot be halved down to a dense-solvable coarsest level.  Callers that
    want to validate multigrid feasibility BEFORE paying for setup (e.g. at
    FEMSystem construction) call this directly."""
    grids = [tuple(int(d) for d in grid)]
    while (
        all(d % 2 == 0 and d >= 4 for d in grids[-1])
        and 3 * int(np.prod([d + 1 for d in grids[-1]])) > coarsest_max_dof
        and (n_levels <= 0 or len(grids) < n_levels)
    ):
        grids.append(tuple(d // 2 for d in grids[-1]))
    coarsest_dof = 3 * int(np.prod([d + 1 for d in grids[-1]]))
    if coarsest_dof > 4 * coarsest_max_dof:
        raise ValueError(
            f"cannot coarsen below {grids[-1]} ({coarsest_dof} dofs): "
            "grid dims should contain enough factors of 2 for multigrid"
        )
    return grids


class StructuredMultigrid:
    """V-cycle preconditioner over dyadically coarsened box_tets grids.

    Built for a specific (mesh, material, fixed-dof mask); the resulting
    ``precondition``/``solve`` operate on BC-eliminated residuals.
    """

    def __init__(
        self,
        mesh: FEMesh,
        material: Material,
        fixed: np.ndarray,
        n_levels: int = 0,
        omega: float = 0.7,
        smooth_steps: int = 2,
        coarsest_max_dof: int = 3000,
        dia: Optional[DIAPattern] = None,
        smoother: str = "jacobi",
        cheby_alpha: float = 4.0,
        coarse_spmv: str = "auto",
    ):
        """smoother="chebyshev" replaces the damped-Jacobi sweeps with a
        degree-``smooth_steps`` Chebyshev polynomial in D^-1 A targeting
        [lambda_max/cheby_alpha, lambda_max] -- same SpMV count per cycle,
        much stronger high-frequency damping, so the PCG needs fewer
        V-cycles.  lambda_max per level comes from a host Gershgorin bound
        of the analytic level operator (exact upper bound, no power
        iteration).

        coarse_spmv picks the coarse-level operator application:
        "auto" uses the Triton DIA SpMV kernel (kernels/dia_spmv.py) on a
        GPU with a 4-byte dtype and the XLA shifted-slice SpMV elsewhere;
        "slices" forces the XLA path; "triton" forces the kernel (raises
        off-GPU); "interpret" runs the kernel in interpret mode (CPU
        tests)."""
        info = mesh.structure
        assert info is not None and info["kind"] == "box_tets"
        nx, ny, nz = info["nx"], info["ny"], info["nz"]
        lx = mesh.nodes[:, 0].max()
        ly = mesh.nodes[:, 1].max()
        lz = mesh.nodes[:, 2].max()
        self.omega = omega
        self.smooth_steps = smooth_steps
        self.material = material
        self.smoother = smoother
        self.cheby_alpha = cheby_alpha
        self._lmax: List[float] = []  # per level, Gershgorin of D^-1 A

        grids = coarsen_grids((nx, ny, nz), coarsest_max_dof, n_levels)
        self.grids = grids

        # Build the level hierarchy.  The FINE operator (level 0) is NOT
        # assembled here -- the cycle smooths level 0 with the exact operator
        # the caller hands to pcg_solve/precondition, so setup cost is only
        # the coarse grids.  Coarse operators are built analytically on the
        # host: the uniform-grid operator is translation invariant, so each
        # level is one ~11 KB cell tensor (analytic_cell_tensor) broadcast
        # through corner-existence masks -- O(n_dof * K) numpy
        # (rediscretizing through a backend measured ~8 min at the
        # 1M-element scale).  A device-side build (the
        # analytic_dia_values_device twin) would avoid the upload at the
        # price of one more compiled program.  The values are cast to the
        # active dtype BEFORE upload so f32 runs ship half the bytes.  The
        # coarsest level keeps its host f64 copy for the dense inverse
        # instead of re-downloading what it just uploaded.
        self.levels: List[_Level] = []
        fixed_l = np.asarray(fixed, dtype=bool)
        dtype = jnp.zeros((), dtype=float).dtype  # f32 unless x64 enabled
        values_host = None  # host f64 values of the last built level
        if coarse_spmv not in ("auto", "slices", "triton", "interpret"):
            raise ValueError(f"unknown coarse_spmv {coarse_spmv!r}")
        interp = coarse_spmv == "interpret"
        use_kernel_coarse = coarse_spmv in ("triton", "interpret") or (
            coarse_spmv == "auto" and spmv_kernel.kernel_available(dtype)
        )
        #: per level: kernel plan for the level's operator application, or
        #: None (level 0 uses the caller-supplied spmv; the coarsest level is
        #: a dense inverse).  Static choice -- baked into the traced cycle.
        self._plans = [None]
        #: per coarse level (levels[1:]): host-prepped (K, n_pad) transposed
        #: operand for the kernel, or None
        self._values_t: List[Optional[jax.Array]] = []
        for li, g in enumerate(grids):
            if li == 0:
                dia0 = dia if dia is not None else build_structured_dia_pattern(mesh)
                self.levels.append(
                    _Level(grid=g, dia=dia0, values=None, inv_diag=None,
                           fixed=jnp.asarray(fixed_l))
                )
                if smoother == "chebyshev":
                    # Gershgorin bound of D^-1 A from the analytic fine
                    # operator (the BC'd runtime operator only shrinks it)
                    v0 = analytic_structured_dia_values(
                        mesh, np.asarray(material.C), dia0
                    )
                    self._lmax.append(_gershgorin(v0, dia0.diag_idx))
                continue
            mesh_l = box_tets(*g, lx, ly, lz)
            # coarsen the mask: coarse grid nodes are the even-index fine
            # nodes; a coarse dof is fixed iff its fine image is fixed
            fixed_l = self._coarsen_mask(fixed_l, grids[li - 1])
            dia_l = build_structured_dia_pattern(mesh_l)
            values_host = self._assemble_level_host(mesh_l, dia_l, fixed_l)
            if smoother == "chebyshev":
                self._lmax.append(_gershgorin(values_host, dia_l.diag_idx))
            diag = values_host[:, dia_l.diag_idx]
            self.levels.append(
                _Level(
                    grid=g,
                    dia=dia_l,
                    values=jnp.asarray(values_host.astype(dtype)),
                    inv_diag=jnp.asarray(
                        np.where(diag != 0.0, 1.0 / diag, 0.0).astype(dtype)
                    ),
                    fixed=jnp.asarray(fixed_l),
                )
            )
            plan = vt = None
            if use_kernel_coarse and li < len(grids) - 1:
                plan = spmv_kernel.spmv_plan(
                    dia_l.n_dof, dia_l.offsets, interpret=interp
                )
                vt = jnp.asarray(np.ascontiguousarray(np.pad(
                    values_host.T.astype(dtype),
                    ((0, 0), (0, plan.n_pad - plan.n)),
                )))
            self._plans.append(plan)
            self._values_t.append(vt)

        # coarsest: dense inverse (host LAPACK, f64, once).  With a single
        # level the cycle degenerates to a direct solve of the fine
        # operator, which we then do have to assemble (it is small by
        # construction of the coarsest_max_dof guard above).
        last = self.levels[-1]
        if last.values is None:
            values_host = self._assemble_level_host(mesh, last.dia, fixed)
            last = dataclasses.replace(
                last, values=jnp.asarray(values_host.astype(dtype))
            )
            self.levels[-1] = last
        dense = last.dia.to_scipy(values_host).toarray()
        self._coarse_inv = jnp.asarray(np.linalg.inv(dense).astype(dtype))

    def _assemble_level_host(
        self, mesh_l: FEMesh, dia_l: DIAPattern, fixed_l
    ) -> np.ndarray:
        """One level's BC-eliminated operator, closed-form on the host."""
        values = analytic_structured_dia_values(
            mesh_l, np.asarray(self.material.C), dia_l
        )
        return dia_dirichlet_linear_numpy(
            values, dia_l.offsets, dia_l.diag_idx,
            np.asarray(fixed_l, dtype=bool),
        )

    @staticmethod
    def _coarsen_mask(fixed_fine: np.ndarray, grid_fine) -> np.ndarray:
        nfx, nfy, nfz = grid_fine
        m = fixed_fine.reshape(nfx + 1, nfy + 1, nfz + 1, 3)
        return np.ascontiguousarray(m[::2, ::2, ::2, :]).reshape(-1)

    # ------------------------------------------------------------------ #
    def operands(self):
        """The per-level device arrays as a pytree, to be passed as jit
        ARGUMENTS (closure-captured arrays would be baked into the compiled
        module as constants, which at scale makes the program huge).

        Level 0 slots are None placeholders: the fine operator is supplied
        per-solve (``pcg_solve(values, ...)``) and its Jacobi diagonal is
        derived inside the jitted program (``_full_ops``)."""
        return {
            "values": [lv.values for lv in self.levels[1:]],
            "values_t": list(self._values_t),
            "inv_diag": [lv.inv_diag for lv in self.levels[1:]],
            "fixed": [lv.fixed for lv in self.levels],
            "coarse_inv": self._coarse_inv,
        }

    def _full_ops(self, values, ops):
        """Splice the caller's fine operator into the coarse-level operands."""
        diag = values[:, self.levels[0].dia.diag_idx]
        inv0 = jnp.where(diag != 0.0, 1.0 / diag, 0.0)
        return {
            "values": [values] + list(ops["values"]),
            "values_t": [None] + list(ops.get("values_t", self._values_t)),
            "inv_diag": [inv0] + list(ops["inv_diag"]),
            "fixed": list(ops["fixed"]),
            "coarse_inv": ops["coarse_inv"],
        }

    def _apply(self, ops, li: int, x, apply0=None):
        """One level's operator: level 0 optionally through the caller's fast
        SpMV; coarse levels through their own kernel plan when one was built
        (coarse_spmv), else the XLA shifted-slice path."""
        if li == 0 and apply0 is not None:
            return apply0(x)
        plan = self._plans[li] if li < len(self._plans) else None
        vt = ops.get("values_t", [None] * len(self.levels))[li]
        if plan is not None and vt is not None:
            return spmv_kernel.spmv(plan, vt, x)
        return dia_spmv(ops["values"][li], self.levels[li].dia.offsets, x)

    def _smooth(self, ops, li: int, x, b, steps: int, apply0=None):
        if self.smoother == "chebyshev":
            return self._smooth_cheby(ops, li, x, b, steps, apply0)
        for _ in range(steps):
            r = b - self._apply(ops, li, x, apply0)
            x = x + self.omega * ops["inv_diag"][li] * r
        return x

    def _smooth_cheby(self, ops, li: int, x, b, degree: int, apply0=None):
        """Degree-``degree`` Chebyshev smoothing of D^-1 A on
        [lmax/alpha, lmax] (the standard 3-term MG smoother recurrence);
        one SpMV per degree, like one Jacobi sweep, with far better
        high-frequency damping."""
        lmax = self._lmax[li] * 1.05  # safety over the Gershgorin bound
        lmin = lmax / self.cheby_alpha
        theta = 0.5 * (lmax + lmin)
        delta = 0.5 * (lmax - lmin)
        sigma = theta / delta
        minv = ops["inv_diag"][li]
        r = b - self._apply(ops, li, x, apply0)
        d = (minv * r) / theta
        x = x + d
        rho_old = 1.0 / sigma
        for _ in range(degree - 1):
            rho = 1.0 / (2.0 * sigma - rho_old)
            r = b - self._apply(ops, li, x, apply0)
            d = (rho * rho_old) * d + (2.0 * rho / delta) * (minv * r)
            x = x + d
            rho_old = rho
        return x

    def _vcycle(self, ops, li: int, b, apply0=None):
        level = self.levels[li]
        if li == len(self.levels) - 1:
            return ops["coarse_inv"] @ b
        x = self._smooth(ops, li, jnp.zeros_like(b), b, self.smooth_steps,
                         apply0)
        r = b - self._apply(ops, li, x, apply0)
        # keep transfers out of the fixed dofs so BC rows stay exact
        rc = restrict(jnp.where(ops["fixed"][li], 0.0, r), level.grid)
        rc = jnp.where(ops["fixed"][li + 1], 0.0, rc)
        ec = self._vcycle(ops, li + 1, rc)
        next_grid = self.levels[li + 1].grid
        e = prolong(jnp.where(ops["fixed"][li + 1], 0.0, ec), next_grid)
        x = x + jnp.where(ops["fixed"][li], 0.0, e)
        return self._smooth(ops, li, x, b, self.smooth_steps, apply0)

    def precondition(self, values, r, ops=None, spmv=None):
        """Apply one V-cycle: a fixed symmetric-ish linear operator M^-1 r.

        ``values`` is the BC-eliminated fine DIA operator (smoothed against
        directly -- the hierarchy never stores a fine-level copy)."""
        if ops is None:
            ops = self.operands()
        apply0 = None
        if spmv is not None:
            prep, apply_fn = spmv
            operand = prep(values)
            apply0 = lambda x: apply_fn(operand, x)  # noqa: E731
        return self._vcycle(self._full_ops(values, ops), 0, r, apply0)

    # ------------------------------------------------------------------ #
    def pcg_solve(self, values, b, eps: float = 1.0e-3, max_iters: int = 200,
                  ops=None, spmv=None):
        """PCG on the fine DIA operator with the V-cycle preconditioner.

        ``values`` must be BC-eliminated with the same fixed mask the cycle
        was built with.  Pass ``ops=self.operands()`` explicitly when calling
        under an outer jit so the level arrays are traced arguments.
        spmv: optional (prep, apply) pair (kernels.dia_spmv.make_spmv) for
        every fine-level operator application (CG body + level-0 smoothing).
        """
        dia = self.levels[0].dia
        if ops is None:
            ops = self.operands()
        full = self._full_ops(values, ops)
        if spmv is not None:
            prep, apply_fn = spmv
            operand = prep(values)
            apply0 = lambda x: apply_fn(operand, x)  # noqa: E731
        else:
            apply0 = lambda x: dia_spmv(values, dia.offsets, x)  # noqa: E731

        def apply_m(r):
            return self._vcycle(full, 0, r, apply0)

        r0 = b
        d0 = apply_m(r0)
        x0 = jnp.zeros_like(b)
        rmax0 = jnp.max(jnp.abs(r0))

        def cond(state):
            _, r, _, _, k = state
            rmax = jnp.max(jnp.abs(r))
            return (k < max_iters) & (rmax >= eps * rmax0) & (rmax0 > 0.0)

        def body(state):
            x, r, d, rmr, k = state
            Ad = apply0(d)
            alpha = rmr / jnp.dot(d, Ad)
            x = x + alpha * d
            r = r - alpha * Ad
            z = apply_m(r)
            rmr_new = jnp.dot(r, z)
            d = z + (rmr_new / rmr) * d
            return x, r, d, rmr_new, k + 1

        rmr0 = jnp.dot(r0, d0)
        x, r, _, _, k = jax.lax.while_loop(
            cond, body, (x0, r0, d0, rmr0, jnp.int32(0))
        )
        return x, k, jnp.max(jnp.abs(r))
