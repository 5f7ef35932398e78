"""CLI and exporter tests."""

import numpy as np
import pytest

from femcy_tpu.cli import main as cli_main
from femcy_tpu.io.export import average_nodal_field, export_png, export_vtk
from femcy_tpu.materials import LinearIsotropicPlaneStress
from femcy_tpu.meshgen import rect_tris

ELLIP = "elliptic_membrane/element_linear/ellip_membrane_linEle_localVeryFine.inp"


def test_cli_end_to_end(fixtures_dir, tmp_path, capsys):
    png = tmp_path / "out.png"
    vtk = tmp_path / "out.vtk"
    rc = cli_main(
        [
            str(fixtures_dir / ELLIP),
            "--stress",
            "1",
            "--save-png",
            str(png),
            "--save-vtk",
            str(vtk),
        ]
    )
    assert rc == 0
    out = capsys.readouterr().out
    assert "converged" in out
    assert "max nodal stress[11]" in out
    # the published sigma_yy anchor appears in the CLI output
    syy = float([l for l in out.splitlines() if "max nodal stress[11]" in l][0].split("=")[1])
    assert abs(syy - 93.45) / 93.45 < 0.005
    assert png.exists() and png.stat().st_size > 10_000
    assert vtk.exists()
    text = vtk.read_text()
    assert "UNSTRUCTURED_GRID" in text
    assert "VECTORS displacement" in text
    assert "SCALARS mises" in text


def test_export_roundtrip_vtk(tmp_path):
    mesh = rect_tris(3, 2)
    dof = np.zeros(mesh.n_dof)
    patch = np.ones((mesh.n_elements, 3)) * 2.5
    path = export_vtk(
        mesh,
        str(tmp_path / "m.vtk"),
        dof=dof,
        point_data={"f": average_nodal_field(mesh, patch)},
    )
    lines = open(path).read().splitlines()
    assert lines[0].startswith("# vtk")
    assert f"POINTS {mesh.n_nodes} double" in lines
    # averaged constant patch field stays constant
    nodal = average_nodal_field(mesh, patch)
    np.testing.assert_allclose(nodal, 2.5)


def test_export_png_3d(tmp_path):
    from femcy_tpu.meshgen import box_tets

    mesh = box_tets(2, 2, 2)
    dof = np.zeros(mesh.n_dof)
    patch = np.random.default_rng(0).random((mesh.n_elements, 4))
    p = export_png(mesh, dof, patch, str(tmp_path / "m3d.png"))
    import os

    assert os.path.getsize(p) > 5_000


def test_cli_failure_exit_code(fixtures_dir, tmp_path):
    # the 6.25 MPa Cook case does not converge -> nonzero exit
    rc = cli_main(
        [
            str(fixtures_dir / "cook_membrane/largeDef_quadEl/cook_membrane_2d.inp"),
        ]
    )
    assert rc == 1


def test_gif_helper(tmp_path):
    from femcy_tpu.utils.gif import collect_frames, frames_to_gif

    mesh = rect_tris(3, 2)
    dof = np.zeros(mesh.n_dof)
    patch = np.ones((mesh.n_elements, 3))
    from femcy_tpu.io.export import export_png

    frames = []
    for i in range(3):
        f = str(tmp_path / f"f_{i}.png")
        export_png(mesh, dof, patch * (i + 1), f)
        frames.append(f)
    gif = frames_to_gif(frames, str(tmp_path / "out.gif"))
    import os

    assert os.path.getsize(gif) > 1000
    found = collect_frames(str(tmp_path), r"f_(\d+)\.png$")
    assert found == frames


def test_cli_f32_mode(fixtures_dir):
    """The framework must run in f32 (FEMCY_TPU_X64=0)."""
    import os
    import subprocess
    import sys

    env = dict(os.environ, FEMCY_TPU_X64="0")
    out = subprocess.run(
        [
            sys.executable,
            "-m",
            "femcy_tpu.cli",
            str(fixtures_dir / ELLIP),
            "--platform",
            "cpu",
            "--stress",
            "1",
        ],
        capture_output=True,
        text=True,
        timeout=300,
        env=env,
        cwd="/root/repo",
    )
    assert out.returncode == 0, out.stderr[-1500:]
    syy = float(
        [l for l in out.stdout.splitlines() if "max nodal stress[11]" in l][0]
        .split("=")[1]
    )
    # f32 keeps the elliptic anchor within 0.1%
    assert abs(syy - 93.45) / 93.45 < 1e-3


def test_export_vtk_wedge6_hex20(tmp_path):
    """C3D6/C3D20 are solvable, so --save-vtk must emit their cell types
    (VTK 13 wedge, 25 quadratic hexahedron) instead of KeyError."""
    from femcy_tpu.meshgen import box_hexes20, box_wedges

    for mesh, ct in ((box_wedges(2, 2, 2), 13), (box_hexes20(2, 2, 2), 25)):
        path = export_vtk(mesh, str(tmp_path / f"{mesh.element.name}.vtk"))
        text = open(path).read()
        assert f"CELL_TYPES {mesh.n_elements}" in text
        types = text.split("CELL_TYPES")[1].split("\n")[1 : 1 + mesh.n_elements]
        assert all(int(t) == ct for t in types)


def test_patch_vertex_values_vectorized():
    """The vectorized owner-patch lookup matches a straightforward loop."""
    from femcy_tpu.io.export import _patch_vertex_values
    from femcy_tpu.meshgen import box_tets

    mesh = box_tets(2, 3, 2)
    rng = np.random.default_rng(1)
    nodal_vals = rng.random((mesh.n_elements, mesh.element.n_nodes))
    tris, vals = _patch_vertex_values(mesh, nodal_vals)
    owners = mesh.surface_triangles[1]
    for t in range(tris.shape[0]):
        conn = list(mesh.elements[owners[t]])
        for c in range(3):
            assert vals[t, c] == nodal_vals[owners[t], conn.index(tris[t, c])]


def test_export_html_viewer(tmp_path):
    """Single-file interactive HTML export: valid data payload, all faces
    colored, viewer JS embedded (the reference-GUI stopgap)."""
    import json
    import re

    from femcy_tpu.io.html import export_html
    from femcy_tpu.meshgen import box_tets

    mesh = box_tets(2, 2, 2)
    dof = np.zeros(mesh.n_dof)
    rng = np.random.default_rng(0)
    patch = rng.random((mesh.n_elements, mesh.element.n_nodes))
    p = export_html(mesh, dof, patch, str(tmp_path / "v.html"))
    text = open(p).read()
    assert "<canvas" in text and "onmousedown" in text
    data = json.loads(re.search(r"const D=(\{.*?\});", text).group(1))
    n_tris = len(data["tri"]) // 3
    assert n_tris == mesh.surface_triangles[0].shape[0]
    assert len(data["col"]) == n_tris
    assert all(re.fullmatch(r"#[0-9a-f]{6}", c) for c in data["col"])
    assert data["vmax"] >= data["vmin"]


def test_cli_save_html(fixtures_dir, tmp_path):
    html = tmp_path / "out.html"
    rc = cli_main([str(fixtures_dir / ELLIP), "--save-html", str(html)])
    assert rc == 0
    assert html.exists() and html.stat().st_size > 5_000


@pytest.mark.parametrize(
    "flag,module", [("--save-png", "matplotlib"), ("--save-gif", "PIL")]
)
def test_export_flag_without_its_package_fails_clearly(
    monkeypatch, capsys, flag, module
):
    """An export flag whose optional package is missing stops the CLI
    before any solve, naming the package; the solve path needs neither."""
    import importlib.util

    from femcy_tpu import cli

    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name == module else real(name, *a),
    )
    with pytest.raises(SystemExit) as exc:
        cli.main(["model.inp", flag, "out.file"])
    assert exc.value.code != 0
    err = capsys.readouterr().err
    assert flag in err and "not installed" in err
