"""Smoke test of femcy-tpu's solve path on one NVIDIA GPU.

    python chip_smoke.py              # one card: phases 0-4
    python chip_smoke.py --multichip  # four cards: sharded paths only

Phases (one process, f32 solves, full-f32 matmul precision):

0. device: exit non-zero unless JAX's first device is a GPU; print the
   card's name and power limit, the JAX version and XLA_FLAGS.
1. kernels: every kernel of the path at real widths -- the Triton
   structured accumulate and DIA SpMV beside XLA's compilation of the plain
   versions, the XLA general assembly and block-ELL SpMV -- each against a
   host f64 reference, then the ``gpu`` pytest tier (tests/test_gpu.py).
2. structured linear: FEMSystem on box_tets(56)^3, 1,053,696 C3D4
   elements, 555,579 dofs, multigrid PCG (bench.system_cell).
3. unstructured linear: FEMSystem on unstructured_box_tets(56), AMG PCG
   (bench.unstructured_cell).
4. nonlinear: FEMSystem.solve on a force-controlled bending model,
   box_tets(64, 32, 32) (212,355 dofs), multigrid PCG.

Gates: the device operator against the host f64 operator (max |diff| /
max |ref| <= 1e-5: f32 rounding plus the scatter's changing summation
order); the f64 true residual of each linear solve (||K x - b||_inf <=
2 cg_eps ||b||_inf: the CG stops on its own recurrence residual at cg_eps,
the factor allows for f32 drift); the nonlinear state's f64 equilibrium
(rms of the free-dof residual / rms of the external force <=
newton_rel_tol).  Every phase prints its first-call (compile included) and
steady wall times and the device's peak memory.  Any failure exits
non-zero; the last line is a JSON object naming the device.

``--multichip`` runs SolverConfig(sharding="slab") and sharding="banded"
on four cards against the same analyses on one device, in f64: equal
increment and Newton counts, max displacement within 1e-4 relative, and
every device of the mesh holding arrays.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

#: operator gate: f32 rounding + the scatter's summation order
OPERATOR_TOL = 1.0e-5
#: sharded vs single-device max displacement
MULTICHIP_TOL = 1.0e-4

REPO = os.path.dirname(os.path.abspath(__file__))


def log(msg):
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as exc:
        return f"nvidia-smi unavailable ({exc.__class__.__name__})"
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi reported nothing"


# --------------------------------------------------------------------------- #
# gates (host numpy / scipy, f64)
# --------------------------------------------------------------------------- #
class GateFailed(AssertionError):
    pass


def check(name: str, err: float, limit: float) -> float:
    """Print ``err`` beside ``limit``; raise unless finite and within it."""
    import math

    ok = math.isfinite(err) and err <= limit
    log(f"  gate {name}: {err:.3e} <= {limit:.1e} {'OK' if ok else 'FAILED'}")
    if not ok:
        raise GateFailed(f"{name}: {err!r} > {limit!r}")
    return err


def operator_error(dev, ref) -> float:
    """max |dev - ref| / max |ref| for dense arrays or scipy sparse."""
    import numpy as np
    import scipy.sparse as sp

    if sp.issparse(ref):
        diff = (sp.csr_matrix(dev, dtype=np.float64) - ref).tocsr()
        num = np.abs(diff.data).max() if diff.nnz else 0.0
        return float(num / np.abs(ref.data).max())
    dev = np.asarray(dev, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(dev - ref).max() / np.abs(ref).max())


def residual_error(K64, x, b) -> float:
    """||K64 x - b||_inf / ||b||_inf in f64."""
    import numpy as np

    x = np.asarray(x, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(K64 @ x - b).max() / np.abs(b).max())


def equilibrium_error(mesh, material, dof, f_ext, fixed) -> float:
    """rms of the f64 host residual on the free dofs / rms of f_ext there."""
    import numpy as np

    from femcy_tpu.assembly_host import internal_force_host

    free = ~np.asarray(fixed, bool)
    r = internal_force_host(mesh, material, np.asarray(dof, np.float64)) - f_ext

    def rms(v):
        return float(np.sqrt(np.mean(v[free] ** 2)))

    return rms(r) / rms(np.asarray(f_ext, np.float64))


# --------------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------------- #
def peak_bytes() -> int:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def report_phase(name, first_s, steady_s):
    log(f"  {name}: first call {first_s:.3f}s (compile included), steady "
        f"{steady_s:.4f}s, compile ~{max(first_s - steady_s, 0.0):.3f}s, "
        f"peak_bytes_in_use {peak_bytes()}")


def timed(fn, *args):
    """(result, seconds) of one call, blocked until the device is done."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def phase_device(multichip: bool = False):
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs an NVIDIA GPU; JAX found platform "
              f"{devs[0].platform!r}", file=sys.stderr)
        raise SystemExit(2)
    want = 4 if multichip else 1
    if len(devs) < want:
        print(f"chip_smoke: needs {want} GPUs, found {len(devs)}",
              file=sys.stderr)
        raise SystemExit(2)
    log("phase 0: device")
    log(f"  card: {card()}")
    log(f"  jax {jax.__version__}, devices {devs}, "
        f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    from femcy_tpu.utils.cache import configure_compile_cache

    log(f"  compile cache: {configure_compile_cache()}")
    return devs[0]


def structured_reference(mesh, material, dia, fixed, rhs):
    """(raw f64 DIA values, BC-eliminated f64 DIA values, BC-eliminated f64
    CSR, f64 rhs) of the clamped / sheared box, from the closed-form
    uniform-grid operator."""
    import numpy as np

    from femcy_tpu.structured import (
        analytic_structured_dia_values,
        dia_dirichlet_linear_numpy,
    )

    raw = analytic_structured_dia_values(mesh, np.asarray(material.C), dia)
    bc = dia_dirichlet_linear_numpy(raw, dia.offsets, dia.diag_idx, fixed)
    b = np.where(fixed, 0.0, rhs)
    return raw, bc, dia.to_scipy(bc), b


def unstructured_reference(cell):
    """(BC-eliminated f64 CSR, f64 rhs) of an unstructured cell, assembled
    on the host in f64 from the node coordinates the device reads.

    The jittered mesh has sliver elements whose stiffness moves by 4.5e-4
    of max |Ke| when the coordinates alone are rounded to f32 (measured on
    the host at nx=56); the device's own f32 arithmetic on those rounded
    coordinates stays near 1e-6, which is what the gate checks.
    """
    import dataclasses

    import numpy as np

    from femcy_tpu.assembly_host import assemble_csr_host, dirichlet_csr_host

    nodes = np.asarray(cell.system._arrs["nodes"]).astype(np.float64)
    mesh = dataclasses.replace(cell.mesh, nodes=nodes)
    K = assemble_csr_host(mesh, cell.system.pattern,
                          np.asarray(cell.system.material.C))
    zeros = np.zeros(cell.mesh.n_dof)
    return dirichlet_csr_host(K, cell.rhs, cell.fixed, zeros)


def phase_kernels(nx: int = 56, unstructured_nx: int = 56,
                  run_tier: bool = True):
    """Each kernel of the path at real widths: the hand-written Triton
    kernels against XLA's compilation of the plain version on the same
    inputs, and every one against a host f64 reference."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    import bench
    from femcy_tpu.kernels import dia_spmv as spmv_kernel
    from femcy_tpu.solvers.bell import bell_from_ell, bell_spmv, build_bell_plan
    from femcy_tpu.solvers.dia import dia_spmv
    from femcy_tpu.structured import (
        build_structured_plan,
        kernel_assembly_eligible,
        structured_assemble_coords,
    )

    log("phase 1: kernels")
    t0 = time.perf_counter()
    cell = bench.box_cell(nx, jnp.float32, multigrid=False)
    raw = structured_reference(cell.mesh, cell.material, cell.dia,
                               cell.fixed, cell.rhs)[0]
    mesh, a = cell.mesh, cell.arrs
    plan = build_structured_plan(mesh, cell.dia)
    on_gpu = kernel_assembly_eligible(mesh, jnp.float32)
    xla_asm = jax.jit(lambda c: structured_assemble_coords(
        c, mesh, a["dN"], a["w"], a["C"], plan, accumulate="xla"))
    for name, fn in (("kernel path" if on_gpu else "auto path",
                      lambda c: cell.assemble(dict(a, nodes=c))),
                     ("XLA path", xla_asm)):
        vals, t_first = timed(fn, a["nodes"])
        _, t = timed(fn, a["nodes"])
        log(f"  structured assembly, {name}: {t * 1e3:.3f} ms (first "
            f"{t_first:.2f}s)")
        check(f"structured assembly ({name}) vs analytic f64",
              operator_error(vals, raw), OPERATOR_TOL)
        del vals
    rng = np.random.default_rng(0)
    x = rng.standard_normal(mesh.n_dof)
    v32 = jnp.asarray(raw, jnp.float32)
    x32 = jnp.asarray(x, jnp.float32)
    y_ref = cell.dia.to_scipy(raw) @ x
    spmvs = [("XLA shifted slices", v32,
              jax.jit(lambda v, xx: dia_spmv(v, cell.dia.offsets, xx)))]
    if spmv_kernel.kernel_available(jnp.float32):
        prep, apply_fn = spmv_kernel.make_spmv(mesh.n_dof, cell.dia.offsets)
        spmvs.append(("Triton kernel", jax.jit(prep)(v32), jax.jit(apply_fn)))
    reps = 50
    for name, operand, fn in spmvs:
        y, _ = timed(fn, operand, x32)
        check(f"DIA SpMV ({name}) vs scipy f64", operator_error(y, y_ref),
              OPERATOR_TOL)
        # one program of `reps` applications: the time per application
        # excludes the per-call dispatch a single tiny call would measure
        loop = jax.jit(lambda v, xx, fn=fn: jax.lax.fori_loop(
            0, reps, lambda _, z: fn(v, z) / jnp.max(jnp.abs(z)), xx))
        timed(loop, operand, x32)
        _, t = timed(loop, operand, x32)
        log(f"  DIA SpMV, {name}: {t / reps * 1e3:.4f} ms per application "
            f"(incl. one max-normalization)")
    del cell, v32, raw, spmvs

    ucell = bench.unstructured_cell(unstructured_nx)
    (values, _), _ = timed(ucell.assemble)
    _, t_uasm = timed(ucell.assemble)
    log(f"  general assembly + BC (XLA) {t_uasm * 1e3:.3f} ms")
    pattern = ucell.system.pattern
    K_bc, _ = unstructured_reference(ucell)
    A_dev = pattern.to_scipy(np.asarray(values, np.float64))
    check("general assembly vs host f64", operator_error(A_dev, K_bc),
          OPERATOR_TOL)
    bplan = build_bell_plan(pattern, ucell.mesh.dm)
    ncol = jnp.asarray(bplan.ncol)
    bspmv = jax.jit(lambda v, xx: bell_spmv(bell_from_ell(v, bplan), ncol, xx))
    xu = rng.standard_normal(ucell.mesh.n_dof)
    xu32 = jnp.asarray(xu, jnp.float32)
    yb, _ = timed(bspmv, values, xu32)
    _, t_bell = timed(bspmv, values, xu32)
    log(f"  block-ELL SpMV (XLA, layout conversion included) "
        f"{t_bell * 1e3:.3f} ms")
    check("block-ELL SpMV vs scipy f64", operator_error(yb, A_dev @ xu),
          OPERATOR_TOL)
    del ucell, values, A_dev
    if run_tier:
        import pytest

        os.environ["FEMCY_TEST_GPU"] = "1"
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(REPO, "tests", "test_gpu.py")])
        if rc != 0:
            raise GateFailed(f"gpu test tier failed (pytest exit {rc})")
        log("  gpu test tier passed")
    log(f"  phase 1 wall {time.perf_counter() - t0:.1f}s, peak_bytes_in_use "
        f"{peak_bytes()}")


def phase_structured(nx: int = 56):
    import bench
    from femcy_tpu.meshgen import box_tets

    log(f"phase 2: structured linear, FEMSystem(box_tets({nx},{nx},{nx})), "
        f"multigrid PCG")
    t0 = time.perf_counter()
    cell = bench.system_cell(box_tets(nx, nx, nx), preconditioner="multigrid")
    system = cell.system
    log(f"  {cell.mesh.n_elements} elements, {cell.mesh.n_dof} dofs, "
        f"structured plan {system._structured_plan is not None}, Triton SpMV "
        f"{system._spmv is not None} (host setup "
        f"{time.perf_counter() - t0:.1f}s)")
    x, first = timed(cell.run)
    x, steady = timed(cell.run)
    log(f"  multigrid levels {[lv.grid for lv in system._mg.levels]}, PCG "
        f"iterations {system._last_cg_iters}")
    report_phase("assemble + BC + MG-PCG", first, steady)
    _, bc, K64, b64 = structured_reference(
        cell.mesh, system.material, system.dia, cell.fixed, cell.rhs)
    check("operator (device DIA vs analytic f64)",
          operator_error(cell.assemble()[0], bc), OPERATOR_TOL)
    check("linear residual ||Kx-b||/||b||", residual_error(K64, x, b64),
          2 * bench.CG_EPS)


def phase_unstructured(nx: int = 56):
    import numpy as np

    import bench

    log(f"phase 3: unstructured linear, unstructured_box_tets({nx}), AMG PCG")
    t0 = time.perf_counter()
    cell = bench.unstructured_cell(nx)
    log(f"  {cell.mesh.n_elements} elements, {cell.mesh.n_dof} dofs "
        f"(mesh + pattern {time.perf_counter() - t0:.1f}s)")
    (values, b), t_asm = timed(cell.assemble)
    _, t_amg = timed(cell.setup, values)
    log(f"  AMG setup {t_amg:.2f}s, levels "
        f"{[lv.n_dof for lv in cell.system._amg.levels]}")
    x, t_solve = timed(cell.solve, values, b)
    first = t_asm + t_solve
    K_bc, b64 = unstructured_reference(cell)
    check("operator (device ELL vs host f64 CSR)",
          operator_error(cell.system.pattern.to_scipy(
              np.asarray(values, np.float64)), K_bc), OPERATOR_TOL)
    del values, b
    x, steady = timed(cell.run)
    log(f"  PCG iterations {cell.system._last_cg_iters}")
    report_phase("assemble + BC + AMG-PCG", first, steady)
    check("linear residual ||Kx-b||/||b||", residual_error(K_bc, x, b64),
          2 * bench.CG_EPS)


def bending_model(shape=(64, 32, 32), traction: float = 3.0):
    """Force-controlled bending: clamp x=0, transverse traction on x=max,
    geometrically nonlinear, two 0.5 increments."""
    import numpy as np

    from femcy_tpu.io.inp import DirichletBC, InpModel, NeumannBC
    from femcy_tpu.meshgen import box_tets

    mesh = box_tets(*shape)
    x = mesh.nodes[:, 0]
    left = np.nonzero(x < 1e-12)[0]
    right = set(np.nonzero(x > x.max() - 1e-12)[0].tolist())
    faces = [f for f in mesh.boundary if all(n in right for n in f)]
    inp = InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={},
        dirichlet_bcs=[DirichletBC(left, d, 0.0) for d in range(3)],
        neumann_bcs=[NeumannBC(face_set=faces, traction=traction,
                               direction=np.array([0.0, 0.0, 1.0]))],
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.5, max_time=1.0, min_inc=1e-4, max_inc=0.5),
    )
    return mesh, inp


def external_force(mesh, inp):
    import numpy as np

    from femcy_tpu import bc as bc_mod

    patterns, tractions = bc_mod.build_neumann_patterns(mesh, inp.neumann_bcs)
    return np.asarray(tractions @ patterns, np.float64)


def solve_bending(shape, **cfg):
    """(system, report, first-call wall, steady wall) of the bending model."""
    from femcy_tpu import FEMSystem, SolverConfig
    from femcy_tpu.materials import LinearIsotropic

    mesh, inp = bending_model(shape)
    system = FEMSystem(mesh, LinearIsotropic(1000.0, 0.3), True,
                       SolverConfig(newton_boost_max=0, **cfg))
    t0 = time.perf_counter()
    system.solve(inp)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    report = system.solve(inp)
    steady = time.perf_counter() - t0
    return system, inp, report, first, steady


def phase_nonlinear(shape=(64, 32, 32)):
    import numpy as np

    log(f"phase 4: nonlinear bending, box_tets{tuple(shape)}, multigrid PCG")
    system, inp, report, first, steady = solve_bending(
        shape, preconditioner="multigrid", linear_solver="cg")
    newton = sum(r.newton_iters for r in report.increments)
    log(f"  {system.mesh.n_dof} dofs, {report.n_increments} increments, "
        f"{newton} Newton iterations, max|u| "
        f"{float(np.abs(np.asarray(system.dof)).max()):.6e}")
    report_phase("FEMSystem.solve", first, steady)
    if not report.success:
        raise GateFailed(f"nonlinear analysis failed: {report.message}")
    fixed = np.zeros(system.mesh.n_dof, bool)
    for bc in inp.dirichlet_bcs:
        fixed[np.asarray(bc.node_set) * 3 + bc.dof] = True
    check("equilibrium rms(r_free)/rms(f_ext)",
          equilibrium_error(system.mesh, system.material, system.dof,
                            external_force(system.mesh, inp), fixed),
          system.config.newton_rel_tol)


# --------------------------------------------------------------------------- #
# four cards
# --------------------------------------------------------------------------- #
def banded_model(n: int = 150, m: int = 10, traction: float = 0.1):
    """Cantilever tets (about 55k dofs at 150 x 10), clamped end,
    transverse traction on the loaded end, geometrically nonlinear."""
    import numpy as np

    from femcy_tpu.io.inp import DirichletBC, InpModel, NeumannBC
    from femcy_tpu.meshgen import cantilever_tets

    mesh, fixed_nodes, loaded = cantilever_tets(n, m)
    lset = set(loaded.tolist())
    faces = [f for f in mesh.boundary if all(k in lset for k in f)]
    inp = InpModel(
        nodes=mesh.nodes, elements=mesh.elements, element_type="C3D4",
        node_sets={}, ele_sets={}, face_sets={},
        dirichlet_bcs=[DirichletBC(fixed_nodes, d, 0.0) for d in range(3)],
        neumann_bcs=[NeumannBC(face_set=faces, traction=traction,
                               direction=np.array([0.0, 0.0, 1.0]))],
        material_type="Elastic", material_params=[1000.0, 0.3],
        geometric_nonlinear=True,
        time_incs=dict(ini_inc=0.5, max_time=1.0, min_inc=1e-4, max_inc=0.5),
    )
    return mesh, inp


def compare_sharded(name, single, sharded):
    """Equal increment and Newton counts, max |u| within MULTICHIP_TOL."""
    import numpy as np

    out = {}
    for tag, (system, report) in (("single", single), ("sharded", sharded)):
        if not report.success:
            raise GateFailed(f"{name} {tag} analysis failed: {report.message}")
        out[tag] = (report.n_increments,
                    sum(r.newton_iters for r in report.increments),
                    float(np.abs(np.asarray(system.dof)).max()))
    log(f"  {name}: single (increments, newton, max|u|) {out['single']}, "
        f"sharded {out['sharded']}")
    if out["single"][:2] != out["sharded"][:2]:
        raise GateFailed(f"{name}: increment/Newton counts differ {out}")
    u1, u4 = out["single"][2], out["sharded"][2]
    check(f"{name} max|u| sharded vs single", abs(u4 - u1) / abs(u1),
          MULTICHIP_TOL)


def check_spread(n_devices: int):
    """Every device of the mesh held arrays of the sharded run."""
    import jax

    peaks = [int((d.memory_stats() or {}).get("peak_bytes_in_use", 0))
             for d in jax.devices()[:n_devices]]
    log(f"  peak_bytes_in_use per device {peaks}")
    if min(peaks) <= 0:
        raise GateFailed(f"a device held nothing: {peaks}")


def phase_multichip(n_devices: int = 4, slab_shape=(48, 28, 24),
                    banded_shape=(150, 10)):
    from femcy_tpu import FEMSystem, SolverConfig
    from femcy_tpu.materials import LinearIsotropic

    log(f"multichip: slab and banded sharding on {n_devices} devices")
    mat = LinearIsotropic(1000.0, 0.3)
    runs = {}
    for tag, kw in (("single", {}),
                    ("sharded", dict(sharding="slab",
                                     sharding_devices=n_devices))):
        mesh, inp = bending_model(slab_shape)
        system = FEMSystem(mesh, mat, True, SolverConfig(
            preconditioner="multigrid", linear_solver="cg", cg_eps=1e-5,
            newton_boost_max=0, **kw))
        t0 = time.perf_counter()
        runs[tag] = (system, system.solve(inp))
        log(f"  slab[{tag}] wall {time.perf_counter() - t0:.1f}s")
    compare_sharded("slab", runs["single"], runs["sharded"])
    runs = {}
    for tag, kw in (("single", dict(linear_solver="cg")),
                    ("sharded", dict(sharding="banded",
                                     sharding_devices=n_devices))):
        mesh, inp = banded_model(*banded_shape)
        system = FEMSystem(mesh, mat, True, SolverConfig(
            cg_eps=1e-6, newton_boost_max=0, **kw))
        t0 = time.perf_counter()
        runs[tag] = (system, system.solve(inp))
        log(f"  banded[{tag}] {mesh.n_dof} dofs, wall "
            f"{time.perf_counter() - t0:.1f}s")
    compare_sharded("banded", runs["single"], runs["sharded"])
    check_spread(n_devices)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    multichip = "--multichip" in argv
    # the single-card phases run every solve in f32; the multichip
    # comparison keeps the library's f64 default (in f32 the slender
    # beam's secant Newton stalls on its noise floor and never converges)
    os.environ["FEMCY_TPU_X64"] = "1" if multichip else "0"
    sys.path.insert(0, REPO)
    dev = phase_device(multichip)
    t0 = time.perf_counter()
    if multichip:
        phase_multichip()
    else:
        phase_kernels()
        phase_structured()
        phase_unstructured()
        phase_nonlinear()
    import jax

    log(f"all phases passed in {time.perf_counter() - t0:.1f}s; card: {card()}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
