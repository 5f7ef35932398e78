"""bench.py's problem builders, device guard and metric lines, on the CPU.

The benchmark itself refuses to run without a GPU; its cells are built and
solved here at tiny sizes through the same builders.
"""

import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit):
        bench.require_gpu()


def test_main_exits_before_any_metric_on_cpu(capsys):
    with pytest.raises(SystemExit):
        bench.main()
    assert capsys.readouterr().out == ""


def test_emit_carries_the_device(capsys):
    bench.emit("demo_metric", 1.5, "s", 2.0)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "demo_metric" and line["value"] == 1.5
    dev = jax.devices()[0]
    assert line["platform"] == dev.platform
    assert line["device_kind"] == dev.device_kind
    assert line["device_count"] == len(jax.devices())
    assert "gpu" in line


def test_clamp_shear_bcs():
    from femcy_tpu.meshgen import box_tets

    mesh = box_tets(2, 2, 2)
    fixed, rhs = bench.clamp_shear_bcs(mesh)
    assert fixed.sum() == 3 * 9  # the 3x3 bottom-face nodes
    assert rhs.sum() == 9.0 and np.all(rhs[1::3] == 0.0)
    assert not np.any(fixed & (rhs != 0.0))


@pytest.mark.parametrize("multigrid", [True, False])
def test_box_cell_solves(multigrid):
    cell = bench.box_cell(4, jnp.float32, multigrid=multigrid)
    assert (cell.mg is not None) == multigrid
    x, iters, rmax = cell.run()
    x = np.asarray(x)
    assert np.isfinite(x).all() and np.abs(x).max() > 0
    assert float(rmax) <= bench.CG_EPS * np.abs(cell.rhs).max()
    assert np.all(x[cell.fixed] == 0.0)


def test_unstructured_cell_solves():
    cell = bench.unstructured_cell(4)
    values, b = cell.assemble()
    cell.setup(values)
    x = np.asarray(cell.solve(values, b))
    assert np.isfinite(x).all() and np.abs(x).max() > 0
    assert cell.system._last_cg_iters > 0


def test_graded_amg_iters():
    it_u, it_g, it_gf = bench.graded_amg_iters(3)
    assert min(it_u, it_g, it_gf) > 0
