"""DIA (diagonal-offset) sparse format: the gather-free path.

The ELL SpMV gathers x through a column-index array on every CG iteration.
For meshes whose dof graph has a bounded set of distinct (col - row) offsets
(structured grids always, bandwidth-reduced unstructured meshes often), the
matrix can be stored by offset:

    A[r, r + off_k] = values[r, k]        k = 0..K-1, offsets static

and SpMV becomes K *statically shifted* dense slices:

    y = sum_k values[:, k] * xpad[pad + off_k : pad + off_k + n]

-- contiguous reads and multiplies only, no gather at all.  The same
shift trick covers the Dirichlet column operations.  Assembly scatters
directly into the DIA layout by remapping the presorted ELL segment ids
through a static lookup table, so the whole pipeline stays gather-free.

This is the FEM "stencil" decomposition (cf. the matrix-free stencil-scaling
literature) expressed as a sparse-matrix storage choice.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from femcy_tpu.mesh import FEMesh
from femcy_tpu.topology import ELLPattern, build_pattern


@dataclasses.dataclass(frozen=True)
class DIAPattern:
    n_dof: int
    #: static, sorted distinct column offsets (K,)
    offsets: Tuple[int, ...]
    #: index of offset 0 (the diagonal) in ``offsets``
    diag_idx: int
    #: scatter map: contribution (Ke layout order) -> flat (row * K + k) slot.
    #: None for analytically built structured patterns (the dense structured
    #: assembly writes by offset and never scatters).
    scatter_targets: Optional[np.ndarray] = None

    @property
    def n_offsets(self) -> int:
        return len(self.offsets)

    @property
    def pad_lo(self) -> int:
        return max(0, -min(self.offsets))

    @property
    def pad_hi(self) -> int:
        return max(0, max(self.offsets))

    def to_scipy(self, values: np.ndarray):
        """DIA values -> scipy CSR, via scipy's native dia_matrix.

        scipy stores diagonal k by COLUMN (data[k, c] = A[c - off_k, c]);
        ours is by row (values[r, k] = A[r, r + off_k]), so each diagonal is
        one shifted copy -- no index arrays needed at all.
        """
        import scipy.sparse as sp

        vals = np.asarray(values)
        n = self.n_dof
        data = np.zeros((self.n_offsets, n), dtype=vals.dtype)
        for k, off in enumerate(self.offsets):
            if off >= 0:
                data[k, off:] = vals[: n - off, k]
            else:
                data[k, : n + off] = vals[-off:, k]
        return sp.csr_matrix(
            sp.dia_matrix((data, np.asarray(self.offsets)), shape=(n, n))
        )


def build_dia_pattern(
    mesh: FEMesh, max_offsets: int = 1024, ell: Optional[ELLPattern] = None
) -> Optional[DIAPattern]:
    """DIA pattern for a mesh, or None when the offset set is too large."""
    ell = ell if ell is not None else build_pattern(mesh)
    n_dof, width = ell.n_dof, ell.width
    rows = np.repeat(np.arange(n_dof), ell.row_counts)
    rel = ell.csr_indices.astype(np.int64) - rows
    offsets = np.unique(rel)
    if offsets.shape[0] > max_offsets:
        return None
    K = offsets.shape[0]
    diag_idx = int(np.searchsorted(offsets, 0))
    if offsets[diag_idx] != 0:
        return None  # a dof without a diagonal entry; shouldn't happen

    # flat ELL slot -> flat DIA slot lookup
    offidx = np.searchsorted(offsets, rel)
    ell2dia = np.zeros(n_dof * width, dtype=np.int64)
    ell2dia[ell.csr_slots] = rows * K + offidx
    targets = ell2dia[ell.ensure_scatter_targets()]
    seg_dtype = np.int32 if n_dof * K < 2**31 else np.int64
    return DIAPattern(
        n_dof=n_dof,
        offsets=tuple(int(o) for o in offsets),
        diag_idx=diag_idx,
        scatter_targets=targets.astype(seg_dtype),
    )


def build_structured_dia_pattern(mesh: FEMesh) -> DIAPattern:
    """Analytic DIA pattern for a structured box_tets mesh: O(E) numpy with
    no ELL pattern, no 152M-entry scatter maps, no sorting -- the whole
    24M-nnz pattern at 1M elements costs ~1s instead of ~2min.

    The offset SET equals the generic ``build_dia_pattern`` result because
    every node-coordinate delta the Kuhn subdivision produces occurs at some
    interior node (grids >= 2 cells per axis).  The structured dense
    assembly writes by offset, so no scatter map is needed.
    """
    info = mesh.structure
    assert info is not None and info["kind"] == "box_tets"
    ny, nz = info["ny"], info["nz"]
    dm = mesh.dm
    sx, sy = (ny + 1) * (nz + 1), nz + 1

    # distinct node-coordinate deltas, straight from the repeating Kuhn
    # stencil (every element is one of 6 orientations of the same cube
    # subdivision, so O(1) work instead of a pass over all elements)
    corner = np.asarray(info["corner_delta"])  # (8, 3)
    deltas = []
    for corners in info["kuhn"]:
        d = corner[list(corners)]  # (4, 3)
        deltas.append((d[None, :, :] - d[:, None, :]).reshape(-1, 3))
    node_deltas = np.unique(np.concatenate(deltas), axis=0)

    node_off = node_deltas[:, 0] * sx + node_deltas[:, 1] * sy + node_deltas[:, 2]
    comp = np.arange(dm)
    offsets = np.unique(
        (node_off[:, None, None] * dm + (comp[None, None, :] - comp[None, :, None]))
    )
    diag_idx = int(np.searchsorted(offsets, 0))
    assert offsets[diag_idx] == 0
    return DIAPattern(
        n_dof=mesh.n_dof,
        offsets=tuple(int(o) for o in offsets),
        diag_idx=diag_idx,
        scatter_targets=None,
    )


# --------------------------------------------------------------------------- #
def dia_scatter(Ke, scatter_targets, n_dof: int, n_offsets: int):
    """Element stiffness -> DIA values (n_dof, K) via one segment-sum."""
    flat = jax.ops.segment_sum(
        Ke.reshape(-1), scatter_targets, num_segments=n_dof * n_offsets
    )
    return flat.reshape(n_dof, n_offsets)


def _shifted(xpad, off: int, pad_lo: int, n: int):
    return jax.lax.dynamic_slice_in_dim(xpad, pad_lo + off, n)


def dia_spmv(values, offsets: Tuple[int, ...], x):
    """y = A @ x with static shifted slices (no gather)."""
    n = x.shape[0]
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    xpad = jnp.pad(x, (pad_lo, pad_hi))
    y = jnp.zeros_like(x)
    for k, off in enumerate(offsets):
        y = y + values[:, k] * _shifted(xpad, off, pad_lo, n)
    return y


def dia_dirichlet_linear(values, offsets: Tuple[int, ...], diag_idx: int,
                         rhs, fixed, sval):
    """Symmetric zero-one elimination on the DIA layout (jittable).

    Same math as bc.apply_dirichlet_linear, with ``fixed[col]``/``sval[col]``
    realised as static shifts instead of gathers.
    """
    n = rhs.shape[0]
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    fixed_pad = jnp.pad(fixed, (pad_lo, pad_hi))
    sval_pad = jnp.pad(sval, (pad_lo, pad_hi))
    col_fixed = jnp.stack(
        [_shifted(fixed_pad, off, pad_lo, n) for off in offsets], axis=1
    )
    col_sval = jnp.stack(
        [_shifted(sval_pad, off, pad_lo, n) for off in offsets], axis=1
    )
    rhs = rhs - jnp.sum(jnp.where(col_fixed, values * col_sval, 0.0), axis=1)
    rhs = jnp.where(fixed, sval, rhs)
    values = jnp.where(col_fixed | fixed[:, None], 0.0, values)
    diag = jnp.where(fixed, 1.0, values[:, diag_idx])
    values = values.at[:, diag_idx].set(diag)
    return values, rhs


def dia_dirichlet_newton(values, offsets: Tuple[int, ...], diag_idx: int,
                         residual, fixed):
    """Newton-path Dirichlet treatment on the DIA layout
    (same math as bc.apply_dirichlet_newton)."""
    n = residual.shape[0]
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    fixed_pad = jnp.pad(fixed, (pad_lo, pad_hi))
    col_fixed = jnp.stack(
        [_shifted(fixed_pad, off, pad_lo, n) for off in offsets], axis=1
    )
    residual = jnp.where(fixed, 0.0, residual)
    values = jnp.where(col_fixed | fixed[:, None], 0.0, values)
    diag = jnp.where(fixed, 1.0, values[:, diag_idx])
    values = values.at[:, diag_idx].set(diag)
    return values, residual


def block_jacobi_inverse(values, offsets: Tuple[int, ...], dm: int):
    """Inverse of the per-node dm x dm diagonal blocks -> (n_nodes, dm, dm).

    In the DIA layout the (3n+i, 3n+j) block entry sits at column offset
    (j - i), so the whole block diagonal is dm^2 static column picks --
    no gather.  Singular blocks (from Dirichlet-eliminated rows mixing with
    free ones) fall back to their scalar diagonal.
    """
    from femcy_tpu.linalg import det_small, inv_small

    n = values.shape[0]
    off_to_k = {off: k for k, off in enumerate(offsets)}
    rows = values.reshape(n // dm, dm, values.shape[1])
    block = jnp.stack(
        [
            jnp.stack(
                [rows[:, i, off_to_k[j - i]] for j in range(dm)], axis=-1
            )
            for i in range(dm)
        ],
        axis=-2,
    )  # (n_nodes, dm, dm)
    det = det_small(block)
    safe = jnp.abs(det) > 1e-30
    eye = jnp.eye(dm, dtype=values.dtype)
    block_safe = jnp.where(safe[:, None, None], block, eye)
    inv = inv_small(block_safe)
    # fallback: scalar Jacobi on the diagonal
    diag = jnp.einsum("nii->ni", block)
    scalar = jnp.where(diag != 0.0, 1.0 / diag, 0.0)
    inv = jnp.where(
        safe[:, None, None],
        inv,
        scalar[:, :, None] * eye,
    )
    return inv


def dia_pcg_solve(values, offsets: Tuple[int, ...], diag_idx: int, b,
                  eps: float = 1.0e-3, max_iters: int = 0,
                  block_dm: int = 0, spmv=None):
    """Preconditioned CG on the DIA operator, entirely inside lax.while_loop.

    block_dm > 0 uses the block-Jacobi preconditioner with dm x dm node
    blocks (fewer iterations than scalar Jacobi for elasticity); 0 keeps the
    reference's scalar Jacobi (conjugateGradientSolver.py:48-51).

    spmv: optional (prep, apply) pair (kernels.dia_spmv.make_spmv) replacing
    the shifted-slice SpMV in the iteration body (the Triton kernel on a
    GPU; PERF.md has both times).
    """
    n = b.shape[0]
    if max_iters <= 0:
        max_iters = n
    if spmv is not None:
        prep, apply_fn = spmv
        operand = prep(values)
        apply_a = lambda d: apply_fn(operand, d)  # noqa: E731
    else:
        apply_a = lambda d: dia_spmv(values, offsets, d)  # noqa: E731
    if block_dm > 0:
        binv = block_jacobi_inverse(values, offsets, block_dm)

        def apply_m(r):
            return jnp.einsum(
                "nij,nj->ni", binv, r.reshape(-1, block_dm)
            ).reshape(-1)

    else:
        diag = values[:, diag_idx]
        minv = jnp.where(diag != 0.0, 1.0 / diag, 0.0)

        def apply_m(r):
            return minv * r

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
        Ad = apply_a(d)
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
