"""ctypes loader for the native pattern builder.

Compiles femcy_tpu/native/pattern.cpp on first use with g++ into
``libfemcy_pattern-<sha256 of the source>.so`` next to the source (ignored by
git).  A library is reused only when its name carries the hash of the
current source, so a stale or copied-in build is never loaded.  Falls back to
the pure-numpy path in topology.py when a toolchain is unavailable or
FEMCY_TPU_NATIVE=0.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import pathlib
import subprocess
import threading
from typing import Optional

import numpy as np

logger = logging.getLogger("femcy_tpu.native")

_HERE = pathlib.Path(__file__).parent
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def library_path(src: pathlib.Path = _HERE / "pattern.cpp") -> pathlib.Path:
    """Where the build of ``src`` lives: keyed on the source's content."""
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return src.parent / f"libfemcy_pattern-{digest}.so"


def _compile() -> Optional[pathlib.Path]:
    src = _HERE / "pattern.cpp"
    out = library_path(src)
    if out.exists():
        return out
    # build under a process-unique name and rename: concurrent first uses
    # (test workers) never load a half-written library
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++",
        "-O3",
        "-std=c++17",
        "-shared",
        "-fPIC",
        str(src),
        "-o",
        str(tmp),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
        return out
    except Exception as exc:  # toolchain missing / compile error -> numpy path
        logger.warning("native pattern builder unavailable (%s)", exc)
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if os.environ.get("FEMCY_TPU_NATIVE", "1") == "0":
        return None
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        path = _compile()
        if path is None:
            return None
        lib = ctypes.CDLL(str(path))
        lib.pattern_build.restype = ctypes.c_void_p
        lib.pattern_build.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64,
            ctypes.c_int32,
            ctypes.c_int32,
            ctypes.c_int64,
        ]
        lib.pattern_nnz.restype = ctypes.c_int64
        lib.pattern_nnz.argtypes = [ctypes.c_void_p]
        lib.pattern_width.restype = ctypes.c_int32
        lib.pattern_width.argtypes = [ctypes.c_void_p]
        lib.pattern_nwidth.restype = ctypes.c_int32
        lib.pattern_nwidth.argtypes = [ctypes.c_void_p]
        lib.pattern_export_block_targets.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pattern_export.restype = ctypes.c_int32
        lib.pattern_export.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.pattern_export_sorted.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.pattern_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def build_pattern_native(
    elements: np.ndarray,
    dm: int,
    n_dof: int,
    sorted_exports: bool = False,
    dof_targets: bool = False,
):
    """Returns the pattern arrays or None when the native path can't be used.

    (targets, block_targets, node_width, colidx, row_counts, diag_slot,
     csr_indices, csr_slots, csr_indptr, nnz, width, perm_sorted,
     csr_counts)

    ``dof_targets=False`` (default) skips the dof-level scatter-target
    export (None in its place): it is E*edof^2 int32 -- 607 MB of fresh
    pages at the 1M-element scale, ~9 s of page faults on this host --
    and the device assembly expands the dm^2-smaller ``block_targets``
    in-program instead (ELLPattern.ensure_scatter_targets computes the
    dof map lazily for the consumers that still need it).

    ``sorted_exports=False`` (default) likewise skips the (row, col)-sorted
    permutation export and returns (None, None) in its place: nothing on
    the production path consumes it (ELLPattern.ensure_sorted_scatter
    computes it lazily in numpy on demand).
    """
    lib = get_lib()
    if lib is None:
        return None
    E, npe = elements.shape
    edof = npe * dm
    n_contrib = E * edof * edof
    if n_contrib >= 2**31 or n_dof >= 2**31:
        return None  # int32 index space exceeded; numpy int64 path handles it

    elements = np.ascontiguousarray(elements, dtype=np.int32)
    handle = lib.pattern_build(
        elements.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        E,
        npe,
        dm,
        n_dof,
    )
    if not handle:
        return None
    try:
        nnz = lib.pattern_nnz(handle)
        width = lib.pattern_width(handle)
        node_width = lib.pattern_nwidth(handle)
        if n_dof * width >= 2**31:
            return None
        colidx = np.empty((n_dof, width), dtype=np.int32)
        row_counts = np.empty(n_dof, dtype=np.int32)
        diag_slot = np.empty(n_dof, dtype=np.int64)
        csr_indices = np.empty(nnz, dtype=np.int32)
        csr_slots = np.empty(nnz, dtype=np.int64)
        csr_indptr = np.empty(n_dof + 1, dtype=np.int64)

        def p32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        targets = None
        status = lib.pattern_export(
            handle,
            p32(targets) if targets is not None else None,
            p32(colidx),
            p32(row_counts),
            p64(diag_slot),
            p32(csr_indices),
            p64(csr_slots),
            p64(csr_indptr),
        )
        if status != 0:
            raise RuntimeError("mesh has dofs without a diagonal entry")
        block_targets = np.empty(E * npe * npe, dtype=np.int32)
        lib.pattern_export_block_targets(handle, p32(block_targets))
        if dof_targets:
            targets = np.empty(n_contrib, dtype=np.int32)
            lib.pattern_export(
                handle, p32(targets), p32(colidx), p32(row_counts),
                p64(diag_slot), p32(csr_indices), p64(csr_slots),
                p64(csr_indptr),
            )
        perm_sorted = csr_counts = None
        if sorted_exports:
            perm_sorted = np.empty(n_contrib, dtype=np.int32)
            csr_counts = np.empty(nnz, dtype=np.int32)
            lib.pattern_export_sorted(handle, p32(perm_sorted), p32(csr_counts))
        return (
            targets,
            block_targets,
            int(node_width),
            colidx,
            row_counts,
            diag_slot,
            csr_indices,
            csr_slots,
            csr_indptr,
            int(nnz),
            int(width),
            perm_sorted,
            csr_counts,
        )
    finally:
        lib.pattern_free(handle)
