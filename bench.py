"""Benchmark: the 1.05M-element C3D4 cells on one NVIDIA GPU.

Cells (each prints one JSON line per metric):

* ``c3d4_<n>k_assemble_pcg`` -- structured box_tets(NX, NX, NX): dense
  scatter-free assembly + Dirichlet elimination + geometric-multigrid PCG;
* ``c3d4_<n>k_unstructured_setup`` / ``_amg`` -- the jittered, renumbered
  unstructured box of the same size: one-time setup (native ELL pattern +
  smoothed-aggregation AMG hierarchy), then steady assembly + AMG-PCG;
* the graded-mesh AMG line logs iteration counts only.

Every JSON line carries the device it ran on::

  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N,
   "platform": "gpu", "device_kind": ..., "device_count": N,
   "gpu": "<nvidia-smi name, power limit>"}

``vs_baseline`` is a 10 s (steady) / 30 s (setup) budget over the value.
A run that finds no GPU exits non-zero: no number here comes from a CPU.
Compiles are excluded from the steady numbers (first call of each program
is logged separately).  Everything runs in this one process.

Environment knobs:
  BENCH_NX          cells per cube edge (default 56 -> 1,053,696 tets;
                    dyadically coarsenable dims enable the multigrid
                    preconditioner, others fall back to Jacobi)
  BENCH_DTYPE       f32 (default: the benchmark's chosen dtype, the one
                    the Triton kernels were measured in; ROADMAP A6
                    compares f64) | f64
  BENCH_REPS        timed repetitions (default 3)
  BENCH_MG          1 (default) preconditions the box CG with the V-cycle
                    when the grid supports it; 0 = scalar Jacobi
  BENCH_BOX         0 skips the structured cell
  BENCH_UNSTRUCT    0 skips the unstructured cells
  BENCH_UNSTRUCT_NX unstructured cube edge (default 56 -> 1.05M elements)
  BENCH_GRADED_NX   graded-mesh AMG size (default 20; < 2 skips)
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import sys
import time
from typing import Any, Callable, Dict, Optional

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import femcy_tpu  # noqa: E402,F401  (sets the x64 / matmul precision config)
from chip_smoke import card, timed  # noqa: E402
from femcy_tpu.kernels.dia_spmv import kernel_available, make_spmv  # noqa: E402
from femcy_tpu.materials import LinearIsotropic  # noqa: E402
from femcy_tpu.meshgen import box_tets  # noqa: E402
from femcy_tpu.solvers.dia import (  # noqa: E402
    build_structured_dia_pattern,
    dia_dirichlet_linear,
    dia_pcg_solve,
)
from femcy_tpu.solvers.multigrid import StructuredMultigrid  # noqa: E402
from femcy_tpu.structured import (  # noqa: E402
    build_structured_plan,
    structured_assemble_coords,
)

#: the CG tolerance of every cell: ||r||_inf < CG_EPS * ||r0||_inf
CG_EPS = 1.0e-3


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def require_gpu():
    """Exit non-zero unless JAX's first device is a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs an NVIDIA GPU; JAX found platform {dev.platform!r}"
        )
    return dev


@functools.lru_cache(maxsize=None)
def device_fields() -> Dict[str, Any]:
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "gpu": card() if dev.platform == "gpu" else "none",
    }


def emit(metric, value, unit, vs_baseline):
    """Print one metric JSON line, with the device it was measured on."""
    print(
        json.dumps(
            {
                "metric": metric,
                "value": value,
                "unit": unit,
                "vs_baseline": vs_baseline,
                **device_fields(),
            }
        ),
        flush=True,
    )


def clamp_shear_bcs(mesh):
    """Clamp the z=0 face; unit x-load on every node of the top face."""
    z = mesh.nodes[:, 2]
    fixed = np.zeros(mesh.n_dof, dtype=bool)
    bottom = np.nonzero(z < 1e-9)[0]
    top = np.nonzero(z > z.max() - 1e-9)[0]
    for d in range(3):
        fixed[bottom * 3 + d] = True
    rhs = np.zeros(mesh.n_dof)
    rhs[top * 3] = 1.0
    return fixed, rhs


# --------------------------------------------------------------------------- #
# structured box cell
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class BoxCell:
    """The structured box problem and its two jitted programs."""

    mesh: Any
    dia: Any
    material: Any
    fixed: np.ndarray
    rhs: np.ndarray
    mg: Optional[StructuredMultigrid]
    arrs: Dict[str, Any]
    #: arrs -> raw DIA values (n_dof, K)
    assemble: Callable
    #: (values, arrs) -> (x, iters, rmax); donates ``values``
    bc_and_solve: Callable

    def run(self):
        return self.bc_and_solve(self.assemble(self.arrs), self.arrs)


def box_cell(nx: int, dtype=jnp.float32, multigrid: bool = True) -> BoxCell:
    """box_tets(nx, nx, nx), E=1000, nu=0.3, clamped bottom, sheared top."""
    mesh = box_tets(nx, nx, nx)
    dia = build_structured_dia_pattern(mesh)
    plan = build_structured_plan(mesh, dia)
    material = LinearIsotropic(modulus=1000.0, poisson_ratio=0.3)
    fixed, rhs = clamp_shear_bcs(mesh)
    arrs = dict(
        nodes=jnp.asarray(mesh.nodes, dtype=dtype),
        dN=jnp.asarray(mesh.element.dshape_at_gp, dtype=dtype),
        w=jnp.asarray(mesh.element.gauss_weights, dtype=dtype),
        C=jnp.asarray(material.C, dtype=dtype),
        rhs=jnp.asarray(rhs, dtype=dtype),
        fixed=jnp.asarray(fixed),
        sval=jnp.zeros(mesh.n_dof, dtype=dtype),
    )
    mg = None
    if multigrid:
        try:
            mg = StructuredMultigrid(mesh, material, fixed, dia=dia)
        except ValueError as e:
            log(f"multigrid unavailable ({e}); using Jacobi")
        else:
            arrs["mg_ops"] = jax.tree.map(
                lambda a: a.astype(dtype)
                if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating)
                else a,
                mg.operands(),
            )

    # the Triton kernels on a GPU in f32 (kernels/), XLA otherwise
    C_host = np.asarray(material.C)
    spmv = (make_spmv(mesh.n_dof, dia.offsets)
            if kernel_available(dtype) else None)

    @jax.jit
    def assemble(a):
        return structured_assemble_coords(
            a["nodes"], mesh, a["dN"], a["w"], a["C"], plan, C_host=C_host
        )

    # BC + CG as a second program; the values array is donated to keep
    # memory flat
    @functools.partial(jax.jit, donate_argnums=(0,))
    def bc_and_solve(values, a):
        values, b = dia_dirichlet_linear(
            values, dia.offsets, dia.diag_idx, a["rhs"], a["fixed"], a["sval"]
        )
        if mg is not None:
            return mg.pcg_solve(values, b, eps=CG_EPS, ops=a["mg_ops"],
                                spmv=spmv)
        return dia_pcg_solve(values, dia.offsets, dia.diag_idx, b, eps=CG_EPS,
                             spmv=spmv)

    return BoxCell(mesh, dia, material, fixed, rhs, mg, arrs, assemble,
                   bc_and_solve)


def bench_box(nx: int, reps: int, dtype):
    t0 = time.perf_counter()
    cell = box_cell(nx, dtype, os.environ.get("BENCH_MG", "1") == "1")
    mesh = cell.mesh
    log(
        f"box: {mesh.n_elements} C3D4 elements, {mesh.n_dof} dofs, "
        f"{cell.dia.n_offsets} DIA offsets, multigrid "
        f"{[lv.grid for lv in cell.mg.levels] if cell.mg else None} "
        f"({time.perf_counter() - t0:.1f}s host setup)"
    )
    _, t = timed(cell.assemble, cell.arrs)
    log(f"assembly compile+run: {t:.1f}s")
    (x, iters, rmax), t = timed(cell.run)
    log(f"assemble+solve compile+run: {t:.1f}s (CG iters={int(iters)}, "
        f"rmax={float(rmax):.3e})")
    assert np.isfinite(np.asarray(x)).all()
    asm = min(timed(cell.assemble, cell.arrs)[1] for _ in range(reps))
    total = min(timed(cell.run)[1] for _ in range(reps))
    log(f"assembly: {asm:.4f}s ({mesh.n_elements / asm / 1e6:.2f} M-elem/s); "
        f"assemble+CG: {total:.4f}s")
    emit(f"c3d4_{mesh.n_elements // 1000}k_assemble_pcg",
         round(total, 4), "s", round(10.0 / total, 3))


# --------------------------------------------------------------------------- #
# unstructured cells
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class SystemCell:
    """A linear FEMSystem cell: clamped bottom, sheared top, driven through
    the system's own jitted assembly and linear-solve calls."""

    mesh: Any
    system: Any
    fixed: np.ndarray
    rhs: np.ndarray
    fixed_d: Any
    rhs_d: Any
    sval_d: Any

    def assemble(self):
        """BC-eliminated operator values and rhs (one jitted program)."""
        values, b, _ = self.system._jit_linear_system(
            self.system._arrs, self.rhs_d, self.fixed_d, self.sval_d
        )
        return values, b

    def setup(self, values):
        """One-time preconditioner setup: the AMG hierarchy from the device
        operator, or the geometric multigrid hierarchy."""
        pre = self.system.config.preconditioner
        if pre == "amg":
            self.system._ensure_amg(self.fixed_d, values=values)
        elif pre == "multigrid":
            self.system._ensure_multigrid(self.fixed_d)

    def solve(self, values, b):
        return self.system._solve_linear_system(values, b, self.fixed_d)

    def run(self):
        return self.solve(*self.assemble())


def system_cell(mesh, **cfg) -> SystemCell:
    """FEMSystem(mesh, E=1000, nu=0.3, linear) with CG to CG_EPS; extra
    SolverConfig fields (the preconditioner above all) via ``cfg``."""
    from femcy_tpu import FEMSystem, SolverConfig

    system = FEMSystem(
        mesh, LinearIsotropic(modulus=1000.0, poisson_ratio=0.3), False,
        SolverConfig(linear_solver="cg", cg_eps=CG_EPS, **cfg),
    )
    fixed, rhs = clamp_shear_bcs(mesh)
    return SystemCell(
        mesh, system, fixed, rhs, jnp.asarray(fixed), jnp.asarray(rhs),
        jnp.zeros(mesh.n_dof),
    )


def unstructured_cell(nx: int, **cfg) -> SystemCell:
    """unstructured_box_tets(nx) with AMG-PCG."""
    from femcy_tpu.meshgen import unstructured_box_tets

    return system_cell(unstructured_box_tets(nx), preconditioner="amg", **cfg)


def bench_unstructured(nx: int, reps: int):
    """Setup inside the fence (pattern + AMG hierarchy), then the steady
    assemble + AMG-PCG; first-run compiles are logged and excluded."""
    t0 = time.perf_counter()
    cell = unstructured_cell(nx)
    t_pattern = time.perf_counter() - t0
    mesh, system = cell.mesh, cell.system
    log(f"unstructured mesh: {mesh.n_elements} C3D4 elements, {mesh.n_dof} "
        f"dofs; mesh + ELL pattern {t_pattern:.1f}s, phases "
        f"{system._init_seconds}")
    (values, b), t = timed(cell.assemble)
    log(f"device assembly compile+run: {t:.1f}s")
    _, t_amg = timed(cell.setup, values)
    amg = system._amg
    log(f"AMG setup from the device operator: {t_amg:.1f}s, levels "
        f"{[lv.n_dof for lv in amg.levels]}, complexity "
        f"{amg.complexity:.2f}, phases "
        f"{ {k: round(v, 1) for k, v in amg.setup_seconds.items()} }, "
        f"host phases {system._amg_host_seconds}")
    setup_total = t_pattern + t_amg
    emit(f"c3d4_{mesh.n_elements // 1000}k_unstructured_setup",
         round(setup_total, 1), "s", round(30.0 / setup_total, 3))

    x, t = timed(cell.run)
    log(f"assemble+AMG-PCG compile+run: {t:.1f}s")
    assert np.isfinite(np.asarray(x)).all()
    total = min(timed(cell.run)[1] for _ in range(reps))
    asm = min(timed(cell.assemble)[1] for _ in range(reps))
    log(f"unstructured assemble+AMG-PCG: {total:.4f}s (assembly {asm:.4f}s, "
        f"{system._last_cg_iters} PCG iters)")
    emit(f"c3d4_{mesh.n_elements // 1000}k_unstructured_amg",
         round(total, 4), "s", round(10.0 / total, 3))


def graded_amg_iters(nx: int):
    """PCG iterations of the AMG path at equal dofs: uniform box, 12:1
    graded box, graded box with the fine-level strength filter
    (config.amg_fine_theta=0.12)."""
    from femcy_tpu.meshgen import graded_box_tets, unstructured_box_tets

    def iters(mesh, **cfg):
        cell = system_cell(mesh, preconditioner="amg", **cfg)
        x = cell.run()
        assert np.isfinite(np.asarray(x)).all()
        return cell.system._last_cg_iters

    gm = graded_box_tets(nx, ratio=12.0)
    return (iters(unstructured_box_tets(nx)), iters(gm),
            iters(gm, amg_fine_theta=0.12))


def main():
    require_gpu()
    log(f"devices: {jax.devices()}; card: {card()}; jax {jax.__version__}; "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    from femcy_tpu.utils.cache import configure_compile_cache

    log(f"compile cache: {configure_compile_cache()}")
    nx = int(os.environ.get("BENCH_NX", "56"))
    reps = int(os.environ.get("BENCH_REPS", "3"))
    f64 = os.environ.get("BENCH_DTYPE", "f32") == "f64"
    # before any array exists: every cell runs in the chosen dtype
    jax.config.update("jax_enable_x64", f64)
    dtype = jnp.float64 if f64 else jnp.float32
    if os.environ.get("BENCH_UNSTRUCT", "1") == "1":
        bench_unstructured(int(os.environ.get("BENCH_UNSTRUCT_NX", "56")),
                           reps)
        gnx = int(os.environ.get("BENCH_GRADED_NX", "20"))
        if gnx >= 2:
            it_u, it_g, it_gf = graded_amg_iters(gnx)
            log(f"graded-mesh AMG (nx={gnx}, 12:1 gradation, equal dofs): "
                f"uniform {it_u} iters, graded {it_g}, graded + "
                f"amg_fine_theta=0.12 {it_gf}")
    if os.environ.get("BENCH_BOX", "1") == "1":
        bench_box(nx, reps, dtype)


if __name__ == "__main__":
    main()
