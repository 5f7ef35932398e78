"""Non-interactive CLI: ``python -m femcy_tpu.cli model.inp [options]``.

Replaces the reference's interactive ``main.py`` (input() prompts + GUI
windows, main.py:14-82) with a scriptable entry point printing the same
observables (elastic energy, max Mises at integration points, max nodal
Mises, max displacement) and optional PNG/VTK export.
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np

STRESS_IDS_2D = {0: (0, 0), 1: (1, 1), 2: (0, 1)}
STRESS_IDS_3D = {0: (0, 0), 1: (1, 1), 2: (2, 2), 3: (0, 1), 4: (2, 0), 5: (1, 2)}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="femcy_tpu",
        description="finite-element solver for Abaqus .inp models (JAX)",
    )
    p.add_argument("inp", help="path to the .inp model")
    p.add_argument(
        "--platform",
        default=None,
        help="force a JAX platform (e.g. cpu) before solving",
    )
    p.add_argument(
        "--solver",
        default="auto",
        choices=["auto", "direct", "cg"],
        help="linear solver selection (default: auto crossover like the reference)",
    )
    p.add_argument(
        "--tangent",
        default="secant",
        choices=["secant", "consistent"],
        help="Newton Jacobian (consistent = exact autodiff tangent)",
    )
    p.add_argument(
        "--predictor",
        default="previous",
        choices=["previous", "extrapolate"],
        help="increment initial guess (extrapolate = Abaqus-style linear "
        "extrapolation of the previous solution increment)",
    )
    p.add_argument(
        "--stabilize",
        type=float,
        default=0.0,
        metavar="FRACTION",
        help="static stabilization: volume-proportional viscous damping "
        "calibrated to this dissipated-energy fraction (Abaqus *Static, "
        "stabilize; try 2e-4). Carries nonlinear analyses through local "
        "instabilities. 0 = off",
    )
    p.add_argument(
        "--dynamic-rescue",
        action="store_true",
        help="when a nonlinear increment fails at the minimum dt, traverse "
        "the snap with implicit dynamics (Newmark with numerical "
        "dissipation) and resume statics on the far side",
    )
    p.add_argument("--cg-eps", type=float, default=1.0e-3)
    p.add_argument(
        "--preconditioner",
        default="jacobi",
        choices=["jacobi", "block_jacobi", "multigrid"],
        help="CG preconditioner (multigrid needs a structured box_tets mesh, "
        "so it applies to generated meshes, not .inp models)",
    )
    p.add_argument(
        "--stress",
        type=int,
        default=None,
        help="also report stress component by index "
        "(2D: 0=sxx 1=syy 2=sxy; 3D: 0=sxx 1=syy 2=szz 3=sxy 4=szx 5=syz)",
    )
    p.add_argument("--save-png", default=None, help="write a Mises PNG here")
    p.add_argument(
        "--save-frames",
        default=None,
        help="directory for a per-increment Mises PNG (nonlinear runs)",
    )
    p.add_argument(
        "--save-gif",
        default=None,
        help="assemble the per-increment frames into a GIF here",
    )
    p.add_argument("--save-vtk", default=None, help="write a VTK result file here")
    p.add_argument(
        "--save-html",
        default=None,
        help="write a self-contained interactive HTML viewer here "
        "(drag-rotate/zoom; the reference's GUI equivalent without a display)",
    )
    p.add_argument(
        "--cmap",
        default="turbo",
        help="colormap for PNG export: any matplotlib name (turbo, viridis, "
        "jet, ...) or femcy1..femcy7 — the reference colorBar.py's seven "
        "ramps (femcy4 = its default 4-interval rainbow)",
    )
    p.add_argument("--checkpoint", default=None, help="write .npz checkpoints here")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def _element_types(text: str) -> set:
    """Element type strings of every ``*Element`` block header (the same
    tokenization the beam reader uses, beam.py)."""
    types = set()
    for line in text.splitlines():
        s = line.strip()
        if s[:2] == "**" or not s.startswith("*"):
            continue
        low = s.lower().replace(" ", "")
        if low.split(",")[0] != "*element":
            continue
        for tok in low.split(","):
            if tok.startswith("type="):
                types.add(tok[5:].upper())
    return types


#: optional packages each export flag needs (the solve itself needs none)
_EXPORT_DEPS = {
    "save_png": ("matplotlib", "--save-png"),
    "save_frames": ("matplotlib", "--save-frames"),
    "save_gif": ("PIL", "--save-gif"),
}


def missing_export_deps(args) -> list:
    """Messages for export flags whose optional package is not installed."""
    import importlib.util

    out = []
    for attr, (module, flag) in _EXPORT_DEPS.items():
        if getattr(args, attr, None) and importlib.util.find_spec(module) is None:
            pkg = "Pillow" if module == "PIL" else module
            out.append(f"{flag} needs {pkg}, which is not installed")
    return out


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    missing = missing_export_deps(args)
    if missing:
        parser.error("; ".join(missing))
    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from femcy_tpu.utils.cache import configure_compile_cache

    configure_compile_cache()
    if args.verbose:
        logging.basicConfig(level=logging.INFO, format="%(message)s")

    import jax.numpy as jnp

    from femcy_tpu import FEMesh, FEMSystem, SolverConfig, read_inp
    from femcy_tpu.materials import material_from_inp

    t0 = time.time()
    # B31 beam models route to the dedicated 6-dof/node beam system (the
    # reference parses B31 then crashes, inp_info.py:98-100/118-123).
    # Detection matches *Element header lines with type=B31 -- a bare
    # substring test would misroute continuum models that merely mention
    # 'b31' in a set/material name or comment.
    with open(args.inp, "r") as fh:
        _head = fh.read()
    _types = _element_types(_head)
    if "B31" in _types and len(_types) > 1:
        # beams AND continuum blocks in one model: the 6-dof/node mixed
        # system (femcy_tpu/mixed.py) -- neither pure subsystem can
        # represent a frame-stiffened solid
        return _main_mixed(args, t0)
    if _types == {"B31"}:
        return _main_beam(args, t0)
    # models mixing element types or materials (which the reference's reader
    # rejects, inp_info.py:125-128) route to the multi-block system
    try:
        from femcy_tpu.io.inp import read_inp_multi

        block_model = read_inp_multi(args.inp)
        is_multi = (
            len(block_model.element_blocks) > 1
            or len(block_model.materials) > 1
        )
        for bi in range(len(block_model.element_blocks)):
            block_model.material_of_block(bi)  # raises if unresolvable
    except Exception:
        # odd single-type layouts (or unmapped materials): let read_inp
        # decide -- it keeps the reference's first-material quirk
        is_multi = False
    if is_multi:
        return _main_multiblock(args, block_model, t0)

    inp = read_inp(args.inp)
    material = material_from_inp(
        inp.material_type, inp.material_params, inp.element_type
    )
    mesh = FEMesh(inp.nodes, inp.elements, inp.element)
    config = SolverConfig(
        linear_solver=args.solver,
        cg_eps=args.cg_eps,
        preconditioner=args.preconditioner,
        tangent=args.tangent,
        predictor=args.predictor,
        stabilize_factor=args.stabilize,
        dynamic_rescue=args.dynamic_rescue,
        verbose=args.verbose,
        checkpoint_path=args.checkpoint,
    )
    system = FEMSystem(mesh, material, inp.geometric_nonlinear, config)
    print(
        f"model: {mesh.n_elements} {inp.element_type} elements, "
        f"{mesh.n_nodes} nodes, {mesh.n_dof} dofs, "
        f"geometric_nonlinear={inp.geometric_nonlinear}"
    )

    frames = []

    def _frame_cb(sys_, record):
        import os as _os

        _os.makedirs(args.save_frames, exist_ok=True)
        _, _, mises_f = sys_.compute_strain_stress()
        nodal_f = np.asarray(sys_.extrapolate(mises_f))
        fname = _os.path.join(
            args.save_frames, f"frame_{len(frames):04d}.png"
        )
        from femcy_tpu.io.export import export_png

        export_png(
            mesh,
            np.asarray(sys_.dof),
            nodal_f,
            fname,
            title=f"t={record.time:.4f}",
            cmap=args.cmap,
        )
        frames.append(fname)

    report = system.solve(
        inp, on_increment=_frame_cb if args.save_frames else None
    )
    print(
        f"solve: {'converged' if report.success else 'FAILED'} in "
        f"{report.n_increments} increment(s), {report.wall_time:.2f}s "
        f"(total {time.time() - t0:.2f}s incl. compile)"
    )
    if not report.success:
        print(f"  {report.message}", file=sys.stderr)

    # observables (parity with reference main.py:34-47)
    energy = system.elastic_energy()
    _, stress, mises = system.compute_strain_stress()
    mises_np = np.asarray(mises)
    nodal_mises = np.asarray(system.extrapolate(jnp.asarray(mises_np)))
    dof = np.asarray(system.dof)
    print(f"total elastic energy = {energy:.6g}")
    print(f"max Mises stress at integration points = {mises_np.max():.6g}")
    print(f"max nodal (extrapolated) Mises stress = {nodal_mises.max():.6g}")
    print(f"max |dof| (displacement) = {np.abs(dof).max():.6g}")

    if args.stress is not None:
        ids = STRESS_IDS_2D if mesh.dm == 2 else STRESS_IDS_3D
        i, j = ids[args.stress]
        comp = np.asarray(stress)[:, :, i, j]
        nodal_comp = np.asarray(system.extrapolate(jnp.asarray(comp)))
        print(f"max |stress[{i}{j}]| at integration points = {np.abs(comp).max():.6g}")
        print(f"max nodal stress[{i}{j}] = {nodal_comp.max():.6g}")

    if args.save_gif and frames:
        from femcy_tpu.utils.gif import frames_to_gif

        frames_to_gif(frames, args.save_gif)
        print(f"wrote {args.save_gif} ({len(frames)} frames)")
    if args.save_png:
        from femcy_tpu.io.export import export_png

        export_png(mesh, dof, nodal_mises, args.save_png, title="Mises stress", cmap=args.cmap)
        print(f"wrote {args.save_png}")
    if args.save_vtk:
        from femcy_tpu.io.export import average_nodal_field, export_vtk

        export_vtk(
            mesh,
            args.save_vtk,
            dof=dof,
            point_data={"mises": average_nodal_field(mesh, nodal_mises)},
            cell_data={"mises_max_gp": mises_np.max(axis=1)},
        )
        print(f"wrote {args.save_vtk}")
    if args.save_html:
        from femcy_tpu.io.html import export_html

        export_html(mesh, dof, nodal_mises, args.save_html)
        print(f"wrote {args.save_html}")
    return 0 if report.success else 1


def _main_multiblock(args, model, t0: float) -> int:
    """CLI route for multi-element-type / multi-material models: same
    observables as the single-block path, per-block stress recovery, and
    mixed-cell exports.  Linear and geometric-nonlinear analyses."""
    import jax.numpy as jnp

    from femcy_tpu import SolverConfig
    from femcy_tpu.multiblock import system_from_model

    if args.stabilize > 0.0:
        print(
            "warning: --stabilize is only supported for single-block "
            "models; ignoring it for this multi-block analysis"
        )
    config = SolverConfig(
        linear_solver=args.solver,
        cg_eps=args.cg_eps,
        tangent=args.tangent,
        dynamic_rescue=args.dynamic_rescue,
        verbose=args.verbose,
    )
    system = system_from_model(model, config)
    blocks_txt = ", ".join(
        f"{blk.elements.shape[0]} {etype}[{blk.name or bi}]"
        for bi, ((etype, _, _), blk) in enumerate(
            zip(model.element_blocks, system.blocks)
        )
    )
    print(
        f"model: {blocks_txt}; {model.nodes.shape[0]} nodes, "
        f"{system.n_dof} dofs, {len(model.materials)} material(s), "
        f"geometric_nonlinear={model.geometric_nonlinear}"
    )

    frames = []

    def _frame_cb(sys_, record):
        import os as _os

        _os.makedirs(args.save_frames, exist_ok=True)
        from femcy_tpu.io.export import export_png_blocks

        meshes_f = [sys_.block_mesh(bi) for bi in range(len(sys_.blocks))]
        nodal_f = [
            np.asarray(
                sys_.extrapolate_block(bi, sys_.block_stress(bi)[2])
            )
            for bi in range(len(sys_.blocks))
        ]
        fname = _os.path.join(
            args.save_frames, f"frame_{len(frames):04d}.png"
        )
        export_png_blocks(
            meshes_f, np.asarray(sys_.dof), nodal_f, fname,
            title=f"t={record.time:.4f}", cmap=args.cmap,
        )
        frames.append(fname)

    if model.geometric_nonlinear:
        report = system.solve_nonlinear(
            model, on_increment=_frame_cb if args.save_frames else None
        )
        print(
            f"solve: {'converged' if report.success else 'FAILED'} in "
            f"{report.n_increments} increment(s), {report.wall_time:.2f}s "
            f"(total {time.time() - t0:.2f}s incl. compile)"
        )
        if not report.success:
            print(f"  {report.message}", file=sys.stderr)
    else:
        report = None
        system.solve_model(model)
        print(
            "solve: converged in 1 increment(s) "
            f"(total {time.time() - t0:.2f}s incl. compile)"
        )

    dof = np.asarray(system.dof)
    n_blocks = len(system.blocks)
    stresses, nodal_mises, gp_mises = [], [], []
    for bi in range(n_blocks):
        _, stress, mises = system.block_stress(bi)
        stresses.append(np.asarray(stress))
        gp_mises.append(np.asarray(mises))
        nodal_mises.append(
            np.asarray(system.extrapolate_block(bi, jnp.asarray(mises)))
        )
    print(f"total elastic energy = {system.elastic_energy():.6g}")
    print(
        "max Mises stress at integration points = "
        f"{max(m.max() for m in gp_mises):.6g}"
    )
    print(
        "max nodal (extrapolated) Mises stress = "
        f"{max(m.max() for m in nodal_mises):.6g}"
    )
    print(f"max |dof| (displacement) = {np.abs(dof).max():.6g}")

    if args.stress is not None:
        ids = STRESS_IDS_2D if model.dm == 2 else STRESS_IDS_3D
        i, j = ids[args.stress]
        comp_max = max(np.abs(s[:, :, i, j]).max() for s in stresses)
        nodal_comp_max = max(
            np.asarray(
                system.extrapolate_block(bi, jnp.asarray(s[:, :, i, j]))
            ).max()
            for bi, s in enumerate(stresses)
        )
        print(f"max |stress[{i}{j}]| at integration points = {comp_max:.6g}")
        print(f"max nodal stress[{i}{j}] = {nodal_comp_max:.6g}")

    if (args.save_frames or args.save_gif) and not model.geometric_nonlinear:
        print(
            "frames/GIF apply to nonlinear increments; linear multi-block "
            "solves have one state",
            file=sys.stderr,
        )
    if args.save_gif and frames:
        from femcy_tpu.utils.gif import frames_to_gif

        frames_to_gif(frames, args.save_gif)
        print(f"wrote {args.save_gif} ({len(frames)} frames)")
    meshes = [system.block_mesh(bi) for bi in range(n_blocks)]
    if args.save_png:
        from femcy_tpu.io.export import export_png_blocks

        export_png_blocks(
            meshes, dof, nodal_mises, args.save_png,
            title="Mises stress", cmap=args.cmap,
        )
        print(f"wrote {args.save_png}")
    if args.save_vtk:
        from femcy_tpu.io.export import (
            average_nodal_field_blocks,
            export_vtk_blocks,
        )

        export_vtk_blocks(
            system.nodes,
            [
                (blk.elements, blk.element.name)
                for blk in system.blocks
            ],
            args.save_vtk,
            dof=dof,
            point_data={
                "mises": average_nodal_field_blocks(
                    model.nodes.shape[0], meshes, nodal_mises
                )
            },
            cell_data={
                "mises_max_gp": np.concatenate(
                    [m.max(axis=1) for m in gp_mises]
                )
            },
        )
        print(f"wrote {args.save_vtk}")
    if args.save_html:
        from femcy_tpu.io.html import export_html_blocks

        export_html_blocks(meshes, dof, nodal_mises, args.save_html)
        print(f"wrote {args.save_html}")
    return 0 if report is None or report.success else 1


def _main_beam(args, t0: float) -> int:
    """CLI route for B31 beam lattices (femcy_tpu/beam.py): reports max
    deflection/rotation and peak section forces.  The stress/energy/Mises
    observables of the continuum routes do not apply to beam theory."""
    from femcy_tpu.beam import read_beam_inp, solve_beam

    model = read_beam_inp(args.inp)
    print(
        f"model: {model.elements.shape[0]} B31 elements, "
        f"{model.nodes.shape[0]} nodes, {model.n_dof} dofs (6/node)"
    )
    res = solve_beam(model)
    dt = time.time() - t0
    defl = np.linalg.norm(res.u[:, :3], axis=1)
    rot = np.linalg.norm(res.u[:, 3:], axis=1)
    fe = res.end_forces
    print(f"max deflection |u| = {defl.max():.6e} (node {defl.argmax()})")
    print(f"max rotation |theta| = {rot.max():.6e} (node {rot.argmax()})")
    print(f"max axial force N = {np.abs(fe[:, [0, 6]]).max():.6e}")
    print(f"max bending moment = {np.abs(fe[:, [4, 5, 10, 11]]).max():.6e}")
    print(f"max torque = {np.abs(fe[:, [3, 9]]).max():.6e}")
    print(f"solve time: {dt:.2f}s")
    return 0


def _main_mixed(args, t0: float) -> int:
    """CLI route for mixed beam+solid models (femcy_tpu/mixed.py): one
    6-dof/node system over B31 and continuum blocks."""
    from femcy_tpu.mixed import read_mixed_inp, solve_mixed

    model = read_mixed_inp(args.inp)
    n_beam = sum(b.elements.shape[0] for b in model.beam_blocks)
    n_solid = sum(b.elements.shape[0] for b in model.solid_blocks)
    print(
        f"mixed model: {n_solid} continuum elements in "
        f"{len(model.solid_blocks)} block(s) + {n_beam} B31 elements, "
        f"{model.nodes.shape[0]} nodes (6 dofs/node)"
    )
    res = solve_mixed(model)
    dt = time.time() - t0
    defl = np.linalg.norm(res.u[:, :3], axis=1)
    print(f"max deflection |u| = {defl.max():.6e} (node {defl.argmax()})")
    if res.solid_mises:
        mx = max(float(m.max()) for m in res.solid_mises)
        print(f"max solid Mises = {mx:.6e}")
    if res.beam_end_forces:
        fe = np.concatenate(res.beam_end_forces)
        print(f"max beam axial force N = {np.abs(fe[:, [0, 6]]).max():.6e}")
        print(
            f"max beam bending moment = "
            f"{np.abs(fe[:, [4, 5, 10, 11]]).max():.6e}"
        )
    print(f"auto-constrained rotation dofs: {res.n_auto_fixed}")
    print(f"solve time: {dt:.2f}s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
