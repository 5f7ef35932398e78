"""Native (C++) pattern builder vs the numpy fallback: must agree exactly."""

import numpy as np
import pytest

from femcy_tpu.meshgen import box_tets, rect_quads, rect_tris
from femcy_tpu.native.loader import build_pattern_native, get_lib
from femcy_tpu.topology import build_pattern


@pytest.fixture(scope="module")
def native_available():
    if get_lib() is None:
        pytest.skip("native toolchain unavailable")


@pytest.mark.parametrize(
    "mesh",
    [box_tets(3, 3, 3), rect_tris(5, 4), rect_quads(4, 4)],
    ids=["tets", "tris", "quads"],
)
def test_native_matches_numpy(mesh, native_available, monkeypatch):
    native = build_pattern_native(
        mesh.elements, mesh.dm, mesh.n_dof,
        sorted_exports=True, dof_targets=True,
    )
    assert native is not None
    monkeypatch.setenv("FEMCY_TPU_NATIVE", "0")
    ref = build_pattern(mesh)

    (targets, block_targets, node_width, colidx, row_counts, diag_slot,
     csr_indices, csr_slots, csr_indptr, nnz, width,
     perm_sorted, csr_counts) = native
    assert width == ref.width
    assert nnz == ref.nnz
    assert node_width == ref.node_width
    np.testing.assert_array_equal(colidx, ref.colidx)
    np.testing.assert_array_equal(row_counts, ref.row_counts)
    np.testing.assert_array_equal(diag_slot, ref.diag_slot)
    np.testing.assert_array_equal(targets, ref.ensure_scatter_targets())
    np.testing.assert_array_equal(block_targets, ref.block_targets)
    np.testing.assert_array_equal(csr_indices, ref.csr_indices)
    np.testing.assert_array_equal(csr_indptr, ref.csr_indptr)
    np.testing.assert_array_equal(csr_slots, ref.csr_slots)
    # sorted-order export: must be a permutation whose targets are sorted
    assert np.array_equal(np.sort(perm_sorted), np.arange(perm_sorted.shape[0]))
    assert (np.diff(targets[perm_sorted]) >= 0).all()
    assert csr_counts.sum() == perm_sorted.shape[0]
    ref_perm, ref_counts = ref.ensure_sorted_scatter()
    np.testing.assert_array_equal(csr_counts, ref_counts)


def test_native_used_by_default(native_available):
    mesh = box_tets(2, 2, 2)
    p = build_pattern(mesh)
    # the native path defers the (large) dof-level map; the numpy fallback
    # computes it eagerly
    assert p.scatter_targets is None
    assert p.block_targets.dtype == np.int32
    assert p.ensure_scatter_targets().dtype == np.int32


def test_lazy_scatter_targets_match_block_expansion():
    """ensure_scatter_targets (the lazy dof map) must agree with the
    numpy path's eager dof map."""
    import os

    mesh = box_tets(3, 2, 2)
    p = build_pattern(mesh)
    lazy = p.ensure_scatter_targets()
    os.environ["FEMCY_TPU_NATIVE"] = "0"
    try:
        ref = build_pattern(mesh)
    finally:
        os.environ.pop("FEMCY_TPU_NATIVE")
    np.testing.assert_array_equal(lazy, ref.scatter_targets)


def test_pattern_validate():
    mesh = box_tets(2, 2, 2)
    build_pattern(mesh).validate()


def test_library_is_keyed_on_the_source_hash(tmp_path):
    """A build is reused only under the name carrying its source's hash:
    editing the source (or copying in a foreign library) never loads a
    stale build."""
    import pathlib

    from femcy_tpu.native import loader

    src = tmp_path / "pattern.cpp"
    src.write_text("int f() { return 1; }\n")
    first = loader.library_path(src)
    assert first.parent == tmp_path
    assert first.name.startswith("libfemcy_pattern-") and first.suffix == ".so"
    assert loader.library_path(src) == first
    src.write_text("int f() { return 2; }\n")
    assert loader.library_path(src) != first
    # the shipped source maps to the library the loader actually uses
    lib = loader.get_lib()
    if lib is not None:
        assert pathlib.Path(lib._name) == loader.library_path()
