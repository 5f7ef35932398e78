"""Gather-free general-mesh sharding: RCM + block-tridiagonal row slabs.

The first general (unstructured-mesh) multi-chip design (parallel/sharded.py)
is correctness-first: its SpMV gathers x rows through the ELL column index --
the access pattern the single-device structured path replaced with DIA
shifted slices (solvers/dia.py).  Unstructured meshes
cannot reuse that trick directly: after a bandwidth-reducing reordering the
set of distinct (col - row) offsets fills the whole band (measured: K =
2*bw + 1 on every tet/tri mesh tried), so per-offset shifted slices would
mean thousands of HLO ops per SpMV.

The answer here is one step coarser -- **block-tridiagonal storage**:

* **Host setup.**  Reverse-Cuthill-McKee on the dof graph bounds the
  bandwidth ``bw``; rows are cut into blocks of ``B >= bw`` dofs.  Every
  matrix entry then lands in the block diagonal, the first block
  subdiagonal or the first block superdiagonal: three dense (nb, B, B)
  arrays hold the whole operator.

* **SpMV = three batched matmuls.**  y_I = D_I x_I + L_I x_{I-1} +
  U_I x_{I+1} -- einsums over dense blocks, O(1) HLO ops, no gather,
  no scatter.  The memory overhead vs the exact sparsity (3*B/row_width) is
  the price of regularity: the blocks stream at memory speed.

* **Sharding.**  Each device owns ``nbl`` consecutive row blocks.  Elements
  are assigned to the device that owns their smallest row block; one
  block-row halo-add after assembly and one x-block ppermute per neighbour
  per SpMV are the only collectives.  The CG loop (collectives included)
  lives in one shard_map'd ``lax.while_loop``; its compiled HLO contains no
  gather/scatter instruction (asserted in tests/test_banded.py).

The reference has no distributed execution at all (SURVEY.md §2.5); this
replaces the all_gather + row-gather SpMV of parallel/sharded.py as the
production general-mesh multi-chip path.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from femcy_tpu import assembly
from femcy_tpu.materials import Material
from femcy_tpu.mesh import FEMesh
from femcy_tpu.topology import build_pattern

AXIS = "fem_mesh"


@dataclasses.dataclass
class BandedOperands:
    """Host-built static data for a block-tridiagonal sharded solve."""

    n_devices: int
    n_dof: int
    B: int  # block size (>= RCM bandwidth)
    nb: int  # row blocks covering n_dof
    nbl: int  # row blocks per device (nb padded to D * nbl)
    perm: np.ndarray  # (n_dof,) original dof of permuted slot i
    iperm: np.ndarray  # (n_dof,) permuted slot of original dof j
    # stacked per-device arrays (leading axis = device)
    elements: np.ndarray  # (D, E_s, n) padded element shards
    ele_weight: np.ndarray  # (D, E_s)
    scatter_targets: np.ndarray  # (D, E_s*edof^2) into (nbl+1)*3*B*B
    force_targets: np.ndarray  # (D, E_s*edof) into (nbl+1)*B local rows
    nodes: np.ndarray
    dshape_gp: np.ndarray
    weights_gp: np.ndarray
    C: np.ndarray

    @property
    def rows_local(self) -> int:
        return self.nbl * self.B


def rcm_permutation(pattern) -> np.ndarray:
    """Reverse-Cuthill-McKee ordering of the dof graph (host, scipy)."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    A = sp.csr_matrix(
        (
            np.ones_like(pattern.csr_indices, dtype=np.float32),
            pattern.csr_indices,
            pattern.csr_indptr,
        ),
        shape=(pattern.n_dof, pattern.n_dof),
    )
    return np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))


def build_banded_operands(
    mesh: FEMesh,
    material: Material,
    n_devices: int,
    block: Optional[int] = None,
    pattern=None,
) -> BandedOperands:
    # the ELL pattern build is the dominant host setup cost on large
    # unstructured meshes; callers that already hold one (FEMSystem) pass
    # it in instead of paying it twice
    if pattern is None:
        pattern = build_pattern(mesh)
    n_dof = pattern.n_dof
    D = n_devices
    perm = rcm_permutation(pattern)
    iperm = np.empty(n_dof, dtype=np.int64)
    iperm[perm] = np.arange(n_dof)

    # permuted bandwidth from the ELL structure
    rows = np.repeat(np.arange(n_dof), pattern.row_counts)
    prow = iperm[rows]
    pcol = iperm[pattern.csr_indices.astype(np.int64)]
    bw = int(np.abs(pcol - prow).max())
    if block is None:
        block = max(8, -(-(bw) // 8) * 8)  # round up to a multiple of 8
    if block < bw:
        raise ValueError(f"block {block} smaller than the RCM bandwidth {bw}")
    B = block
    nb = -(-n_dof // B)
    nbl = -(-nb // D)

    # --- element shards by smallest permuted row --------------------------
    dm = mesh.dm
    edof = mesh.element.edof
    E = mesh.n_elements
    ele_dofs = (
        mesh.elements.astype(np.int64)[:, :, None] * dm + np.arange(dm)
    ).reshape(E, edof)
    ele_prows = iperm[ele_dofs]  # (E, edof)
    min_block = ele_prows.min(axis=1) // B
    dev_of_ele = np.minimum(min_block // nbl, D - 1).astype(np.int64)

    counts = np.bincount(dev_of_ele, minlength=D)
    E_s = int(counts.max())
    order = np.argsort(dev_of_ele, kind="stable")

    elements_sh = np.zeros((D, E_s, mesh.element.n_nodes), dtype=np.int32)
    weight_sh = np.zeros((D, E_s))
    targets_sh = np.zeros((D, E_s * edof * edof), dtype=np.int64)
    ftargets_sh = np.zeros((D, E_s * edof), dtype=np.int64)

    # per-entry block-tridiagonal slots: entry (prow r, pcol c) of an element
    # owned by device d lands in local row block Il = r//B - d*nbl in
    # [0, nbl] (min-row assignment + B >= bw guarantee the +1 halo row block
    # suffices), band position J - I + 1 in {0, 1, 2}
    for d in range(D):
        sel = order[counts[:d].sum() : counts[: d + 1].sum()]
        ne = sel.shape[0]
        elements_sh[d, :ne] = mesh.elements[sel]
        # padding uses element 0's (valid) geometry with zero weight: its Ke
        # is exactly zero, and its zeroed targets add 0 to local slot 0
        elements_sh[d, ne:] = mesh.elements[0]
        weight_sh[d, :ne] = 1.0
        pr = ele_prows[sel]  # (ne, edof)
        r = pr[:, :, None]
        c = pr[:, None, :]
        I = r // B
        J = c // B
        Il = I - d * nbl
        band = J - I + 1
        assert (Il >= 0).all() and (Il <= nbl).all()
        assert (band >= 0).all() and (band <= 2).all()
        flat = ((Il * 3 + band) * B + r % B) * B + (c - J * B)
        targets_sh[d, : ne * edof * edof] = flat.reshape(-1)
        # force rows: same local row block + in-block offset, vector layout
        ftargets_sh[d, : ne * edof] = (
            (pr // B - d * nbl) * B + pr % B
        ).reshape(-1)

    return BandedOperands(
        n_devices=D,
        n_dof=n_dof,
        B=B,
        nb=nb,
        nbl=nbl,
        perm=perm,
        iperm=iperm,
        elements=elements_sh,
        ele_weight=weight_sh,
        scatter_targets=targets_sh,
        force_targets=ftargets_sh,
        nodes=mesh.nodes,
        dshape_gp=mesh.element.dshape_at_gp,
        weights_gp=mesh.element.gauss_weights,
        C=material.C,
    )


# --------------------------------------------------------------------------- #
# device-side pieces (under shard_map; arrays are one device's block)
# --------------------------------------------------------------------------- #
def _neighbor_blocks(D: int, xb):
    """(nbl, B) local x blocks -> (x_{I-1}, x_{I+1}) including the single
    boundary block from each neighbour (edge devices receive zeros)."""
    from_left = jax.lax.ppermute(
        xb[-1], AXIS, perm=[(i, i + 1) for i in range(D - 1)]
    )
    from_right = jax.lax.ppermute(
        xb[0], AXIS, perm=[(i + 1, i) for i in range(D - 1)]
    )
    x_lo = jnp.concatenate([from_left[None], xb[:-1]], axis=0)
    x_hi = jnp.concatenate([xb[1:], from_right[None]], axis=0)
    return x_lo, x_hi


def _btd_spmv(D: int, V, x_local):
    """y = A x on the local row blocks.  V: (nbl, 3, B, B) [lower, diag,
    upper]; three batched matmuls + two one-block ppermutes."""
    nbl, _, B, _ = V.shape
    xb = x_local.reshape(nbl, B)
    x_lo, x_hi = _neighbor_blocks(D, xb)
    y = (
        jnp.einsum("bij,bj->bi", V[:, 1], xb)
        + jnp.einsum("bij,bj->bi", V[:, 0], x_lo)
        + jnp.einsum("bij,bj->bi", V[:, 2], x_hi)
    )
    return y.reshape(-1)


def _btd_dirichlet_linear(D: int, V, rhs_local, fixed_local, sval_local):
    """Symmetric zero-one elimination on the local block rows."""
    nbl, _, B, _ = V.shape
    fb = fixed_local.reshape(nbl, B)
    sb = sval_local.reshape(nbl, B)
    f_lo, f_hi = _neighbor_blocks(D, fb.astype(V.dtype))
    s_lo, s_hi = _neighbor_blocks(D, sb)
    col_fixed = jnp.stack([f_lo, fb.astype(V.dtype), f_hi], axis=1)  # (nbl,3,B)
    col_sval = jnp.stack([s_lo, sb, s_hi], axis=1)
    # move prescribed-column loads to the rhs
    corr = jnp.einsum("bkij,bkj->bi", V, col_fixed * col_sval)
    rhs_local = rhs_local - corr.reshape(-1)
    rhs_local = jnp.where(fixed_local, sval_local, rhs_local)
    # zero fixed columns and rows
    V = V * (1.0 - col_fixed)[:, :, None, :]
    V = V * (1.0 - fb.astype(V.dtype))[:, None, :, None]
    # unit diagonal on fixed rows
    didx = jnp.arange(B)
    diag = V[:, 1, didx, didx]
    V = V.at[:, 1, didx, didx].set(jnp.where(fb, 1.0, diag))
    return V, rhs_local


def _btd_pcg(
    D: int,
    V,
    b_local,
    eps: float,
    max_iters: int,
    minv_blocks=None,
    kind: str = "block",
):
    """PCG on the block-tridiagonal operator, one while_loop, psum
    reductions -- the compiled program is gather/scatter-free.

    Preconditioners (``minv_blocks`` = the cached setup operand):

    * ``kind='twolevel'`` (the solver default): the tridiag local solve
      PLUS a global rigid-body-mode coarse correction (Z Ac^-1 Z^T r, one
      psum + two small matmuls per iteration) -- see
      :func:`_btd_twolevel_factor`.  Measured on the 54.8k-dof dryrun
      cantilever at 8 shards: 721 scalar-Jacobi iterations -> 41.
    * ``kind='tridiag'``: exact solve of the DEVICE-LOCAL
      block-tridiagonal operator only (non-overlapping block Schwarz) via
      the precomputed block-Thomas factorization
      ``minv_blocks = stack([Sinv, LS, SU])`` -- see
      :func:`_btd_thomas_factor`.  Apply = one batched einsum + a
      forward and a backward ``lax.scan`` of B-sized matvecs (~= one extra
      SpMV of flops).  721 -> 335 on the same fixture.
    * ``kind='block'``: block-Jacobi z = D_I^-1 r_I from the materialized
      diagonal blocks, ``minv_blocks`` (1, nbl, B, B).  Measured WORSE than
      scalar Jacobi on RCM-banded 3D elasticity (578 vs 399 iterations on
      the same harness: the level-set blocks are cross-section planes, and
      inverting in-plane coupling does nothing for the dominant bending
      modes while distorting the spectrum) -- kept for comparison.
    * ``minv_blocks=None``: scalar Jacobi."""
    nbl, _, B, _ = V.shape

    if minv_blocks is not None and kind == "tridiag":
        Sinv, LS, SU = minv_blocks[0], minv_blocks[1], minv_blocks[2]

        def apply_m(r):
            return _thomas_apply(Sinv, LS, SU, r, nbl, B)

    elif minv_blocks is not None and kind == "twolevel":
        stack_, Acinv, Zm = minv_blocks
        Sinv, LS, SU = stack_[0], stack_[1], stack_[2]
        width = Acinv.shape[0]
        nc = Zm.shape[-1] * nbl  # coarse dofs per device

        def apply_m(r):
            # additive two-level Schwarz: exact local solve + replicated
            # rigid-body-mode coarse correction (sum of two SPD operators)
            z1 = _thomas_apply(Sinv, LS, SU, r, nbl, B)
            rb = r.reshape(nbl, B)
            rc = jnp.einsum("bxc,bx->bc", Zm, rb).reshape(-1)
            off = nc * jax.lax.axis_index(AXIS)
            buf = jax.lax.dynamic_update_slice(
                jnp.zeros(width, dtype=r.dtype), rc, (off,)
            )
            rcg = jax.lax.psum(buf, AXIS)  # Sum all-reduce, no all_gather
            yc = Acinv @ rcg
            yl = jax.lax.dynamic_slice(yc, (off,), (nc,))
            z2 = jnp.einsum(
                "bxc,bc->bx", Zm, yl.reshape(nbl, Zm.shape[-1])
            ).reshape(-1)
            return z1 + z2

    elif minv_blocks is not None:

        def apply_m(r):
            return jnp.einsum(
                "bij,bj->bi", minv_blocks, r.reshape(nbl, B)
            ).reshape(-1)

    else:
        # identity-masked reduction, NOT V[:, 1, i, i] advanced indexing --
        # the latter lowers to an HLO gather, which this program must not
        # contain
        diag = jnp.sum(V[:, 1] * jnp.eye(B, dtype=V.dtype), axis=2).reshape(-1)
        minv = jnp.where(diag != 0.0, 1.0 / diag, 0.0)

        def apply_m(r):
            return minv * r

    def pdot(u, v):
        return jax.lax.psum(jnp.dot(u, v), AXIS)

    r0 = b_local
    d0 = apply_m(r0)
    x0 = jnp.zeros_like(b_local)
    rmax0 = jax.lax.pmax(jnp.max(jnp.abs(r0)), AXIS)

    def cond(state):
        _, _, _, _, k, rmax = state
        return (k < max_iters) & (rmax >= eps * rmax0) & (rmax0 > 0.0)

    def body(state):
        x, r, d, rmr, k, _ = state
        Ad = _btd_spmv(D, V, d)
        alpha = rmr / pdot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        z = apply_m(r)
        rmr_new = pdot(r, z)
        d = z + (rmr_new / rmr) * d
        rmax = jax.lax.pmax(jnp.max(jnp.abs(r)), AXIS)
        return x, r, d, rmr_new, k + 1, rmax

    rmr0 = pdot(r0, d0)
    x, r, _, _, k, rmax = jax.lax.while_loop(
        cond, body, (x0, r0, d0, rmr0, jnp.int32(0), rmax0)
    )
    return x, k, rmax


def _btd_block_inv(V):
    """(nbl, 3, B, B) local blocks -> D_I^-1 (nbl, B, B): the block-Jacobi
    preconditioner setup.  LU-based inverse (not Cholesky) so near-limit
    indefinite tangents don't NaN.  Padding rows past n_dof are all-zero in
    the Newton path (their residual is identically zero, so scalar Jacobi
    ignored them silently); a unit diagonal is inserted there to keep the
    block invertible -- the zero row/column makes the patched block exactly
    [[A, 0], [0, I]], whose inverse leaves the live dofs untouched."""
    Dg = V[0][:, 1]
    B = Dg.shape[-1]
    eye = jnp.eye(B, dtype=Dg.dtype)
    diag = jnp.sum(Dg * eye, axis=2)  # (nbl, B), no gather
    Dg = Dg + jnp.where(diag == 0.0, 1.0, 0.0)[:, :, None] * eye[None]
    return jnp.linalg.inv(Dg)[None]


def _thomas_apply(Sinv, LS, SU, r, nbl, B):
    """Apply the block-Thomas factorization: forward sweep (LS matvecs),
    batched Sinv einsum, backward sweep (SU matvecs)."""
    rb = r.reshape(nbl, B)

    def fwd(y_prev, op):
        LSi, ri = op
        y = ri - LSi @ y_prev
        return y, y

    _, ys = jax.lax.scan(fwd, jnp.zeros(B, dtype=r.dtype), (LS, rb))
    sy = jnp.einsum("bij,bj->bi", Sinv, ys)

    def bwd(z_next, op):
        SUi, syi = op
        z = syi - SUi @ z_next
        return z, z

    _, zs = jax.lax.scan(
        bwd, jnp.zeros(B, dtype=r.dtype), (SU, sy), reverse=True
    )
    return zs.reshape(-1)


def _thomas_operands(Vl):
    """(nbl, 3, B, B) local blocks -> stacked (3, nbl, B, B) Thomas apply
    operands [Sinv, LS, SU] (see :func:`_btd_thomas_factor`)."""
    nbl, _, B, _ = Vl.shape
    eye = jnp.eye(B, dtype=Vl.dtype)
    Dg = Vl[:, 1]
    diag = jnp.sum(Dg * eye, axis=2)
    Dg = Dg + jnp.where(diag == 0.0, 1.0, 0.0)[:, :, None] * eye[None]
    L = Vl[:, 0] * jnp.where(jnp.arange(nbl) == 0, 0.0, 1.0)[:, None, None]
    U = Vl[:, 2] * (
        jnp.where(jnp.arange(nbl) == nbl - 1, 0.0, 1.0)[:, None, None]
    )
    Uprev = jnp.concatenate([jnp.zeros_like(U[:1]), U[:-1]], axis=0)

    def step(sinv_prev, op):
        Li, Di, Upi = op
        S = Di - Li @ sinv_prev @ Upi
        sinv = jnp.linalg.inv(S)
        return sinv, sinv

    _, Sinv = jax.lax.scan(
        step, jnp.zeros((B, B), dtype=Vl.dtype), (L, Dg, Uprev)
    )
    Sinv_prev = jnp.concatenate([jnp.zeros_like(Sinv[:1]), Sinv[:-1]], axis=0)
    LS = jnp.einsum("bij,bjk->bik", L, Sinv_prev)
    SU = jnp.einsum("bij,bjk->bik", Sinv, U)
    return jnp.stack([Sinv, LS, SU])


def _btd_twolevel_factor(D, V, Z, fixedm):
    """Two-level Schwarz setup: the device-local block-Thomas factors PLUS
    a GLOBAL coarse operator on per-block rigid-body modes.

    The coarse space kills the long-range (bending/torsion) modes that no
    one-level Schwarz preconditioner can touch: each block contributes its
    nc rigid-body modes (6 in 3D, 3 in 2D, rows masked at fixed/padded
    dofs), the coarse matrix Ac = Z^T A Z is block-tridiagonal INCLUDING
    the inter-device couplings (one Zm halo ppermute), assembled replicated
    via a padded dynamic_update_slice + psum, Tikhonov-regularized (blocks
    whose live nodes are collinear/empty make rotation modes dependent),
    and inverted once per increment (width = nc*nbl*D is a few hundred).
    Measured on the 8,967-dof cantilever harness at 8 shards: 399 (scalar
    Jacobi) -> 228 (one-level Thomas) -> 33 iterations."""
    Vl = V[0]
    Zl = Z[0]
    fm = fixedm[0]
    nbl, _, B, _ = Vl.shape
    nc = Zl.shape[-1]
    stack = _thomas_operands(Vl)

    live = 1.0 - fm.reshape(nbl, B).astype(Vl.dtype)
    Zm = Zl * live[:, :, None]
    # neighbor Zm blocks: the coarse operator keeps inter-device coupling
    zm_left = jax.lax.ppermute(
        Zm[-1], AXIS, perm=[(i, i + 1) for i in range(D - 1)]
    )
    zm_right = jax.lax.ppermute(
        Zm[0], AXIS, perm=[(i + 1, i) for i in range(D - 1)]
    )
    Z_lo = jnp.concatenate([zm_left[None], Zm[:-1]], axis=0)
    Z_hi = jnp.concatenate([Zm[1:], zm_right[None]], axis=0)
    Cd = jnp.einsum("bxc,bxy,byd->bcd", Zm, Vl[:, 1], Zm)
    Cs = jnp.einsum("bxc,bxy,byd->bcd", Zm, Vl[:, 0], Z_lo)
    Cu = jnp.einsum("bxc,bxy,byd->bcd", Zm, Vl[:, 2], Z_hi)
    # local band (nc*nbl, nc*nbl + 2nc): block i rows at nc*i, cols
    # [sub|diag|super] at nc*i in the 2nc-padded global column space
    tile = jnp.concatenate([Cs, Cd, Cu], axis=2)  # (nbl, nc, 3nc)
    band = jnp.zeros((nc * nbl, nc * nbl + 2 * nc), dtype=Vl.dtype)
    for i in range(nbl):
        band = jax.lax.dynamic_update_slice(band, tile[i], (nc * i, nc * i))
    width = nc * nbl * D
    didx = jax.lax.axis_index(AXIS)
    zero = jnp.zeros((), dtype=didx.dtype)
    rows = jax.lax.dynamic_update_slice(
        jnp.zeros((nc * nbl, width + 2 * nc), dtype=Vl.dtype),
        band,
        (zero, nc * nbl * didx),
    )
    contrib = jax.lax.dynamic_update_slice(
        jnp.zeros((width, width + 2 * nc), dtype=Vl.dtype),
        rows,
        (nc * nbl * didx, zero),
    )
    Ac = jax.lax.psum(contrib, AXIS)[:, nc:-nc]
    eye = jnp.eye(width, dtype=Vl.dtype)
    dg = jnp.sum(Ac * eye, axis=1)
    Ac = Ac + jnp.diag(jnp.where(dg == 0.0, 1.0, 0.0))
    Ac = Ac + (1.0e-8 * jnp.sum(dg) / width) * eye
    Acinv = jnp.linalg.inv(Ac)
    return stack[None], Acinv, Zm[None]


def build_coarse_basis(ops, nodes, dm: int) -> np.ndarray:
    """Host prep: per-block rigid-body modes in banded dof order ->
    (D, nbl, B, nc) with nc = 6 (3D: tx ty tz rx ry rz) or 3 (2D: tx ty
    rz).  Rotations are centered at each block's node centroid for
    conditioning.  Rows of padded positions stay zero; fixed-dof rows are
    masked later on device (the mask is a per-solve input)."""
    D, nbl, B = ops.n_devices, ops.nbl, ops.B
    nc = 6 if dm == 3 else 3
    Z = np.zeros((D * nbl * B, nc))
    p = np.arange(ops.n_dof)
    od = ops.perm  # banded position i <-> original dof ops.perm[i]
    node = od // dm
    comp = od % dm
    xyz = nodes[node].astype(np.float64)  # (n_dof, dm)
    blk = p // B
    # per-block centroid over live positions
    cent = np.zeros((D * nbl, dm))
    cnt = np.bincount(blk, minlength=D * nbl).astype(np.float64)
    for d in range(dm):
        cent[:, d] = np.bincount(blk, weights=xyz[:, d], minlength=D * nbl)
    cent /= np.maximum(cnt, 1.0)[:, None]
    rel = xyz - cent[blk]
    Z[p, comp] = 1.0  # translations
    if dm == 3:
        x, y, z = rel[:, 0], rel[:, 1], rel[:, 2]
        # r_x = (0, -z, y), r_y = (z, 0, -x), r_z = (-y, x, 0)
        rot = np.stack(
            [
                np.stack([np.zeros_like(x), -z, y], axis=1),
                np.stack([z, np.zeros_like(x), -x], axis=1),
                np.stack([-y, x, np.zeros_like(x)], axis=1),
            ],
            axis=1,
        )  # (n_dof, 3 rot modes, 3 comps)
        for rr in range(3):
            Z[p, 3 + rr] = rot[np.arange(len(p)), rr, comp]
    else:
        x, y = rel[:, 0], rel[:, 1]
        rz = np.stack([-y, x], axis=1)  # r_z = (-y, x)
        Z[p, 2] = rz[np.arange(len(p)), comp]
    return Z.reshape(D, nbl, B, nc)


def _btd_thomas_factor(V):
    """Block-Thomas factorization of the DEVICE-LOCAL block-tridiagonal
    operator (inter-device couplings dropped -> non-overlapping block
    Schwarz; the result is SPD whenever the tangent is).

    Schur recursion ``S_1 = D_1, S_i = D_i - L_i S_{i-1}^-1 U_{i-1}`` (a
    sequential lax.scan of B x B inverses, once per increment), then the
    per-iteration apply operands: ``Sinv`` (z-scaling), ``LS_i = L_i
    Sinv_{i-1}`` (forward sweep), ``SU_i = Sinv_i U_i`` (backward sweep) --
    stacked (3, nbl, B, B) so one cached device array feeds the CG program.
    Padded all-zero rows get a unit diagonal exactly like
    :func:`_btd_block_inv`.  L of the first local block / U of the last
    couple to NEIGHBOR devices (applied via ppermute in the SpMV) and are
    excluded from the local solve."""
    return _thomas_operands(V[0])[None]


def _btd_dirichlet_newton(D: int, V, fixed_local):
    """Newton Dirichlet treatment on the local block rows: zero fixed rows
    and columns, unit diagonal (the residual is zeroed by the caller)."""
    nbl, _, B, _ = V.shape
    fb = fixed_local.reshape(nbl, B)
    f_lo, f_hi = _neighbor_blocks(D, fb.astype(V.dtype))
    col_fixed = jnp.stack([f_lo, fb.astype(V.dtype), f_hi], axis=1)
    V = V * (1.0 - col_fixed)[:, :, None, :]
    V = V * (1.0 - fb.astype(V.dtype))[:, None, :, None]
    didx = jnp.arange(B)
    diag = V[:, 1, didx, didx]
    V = V.at[:, 1, didx, didx].set(jnp.where(fb, 1.0, diag))
    return V


def _btd_newton_eval(D, nbl, B, n_dof, material, geometric_stiffness,
                     tangent,
                     elements, ele_weight, targets, ftargets, iperm,
                     nodes, dN, w, C, dof, rhs, fixed, sval,
                     stab_diag=None, stab_ref=None, stab_scale=None):
    """One full Newton residual/Jacobian evaluation on this device's element
    shard -- the general-mesh twin of parallel.structured._shard_newton_eval
    (which mirrors FEMSystem._newton_eval_impl / the reference's
    stiffnessMtrx.py:609-644 + 756-758 + 310-341).

    The working dof lives in the permuted block-row space; assembly needs
    the original ordering, so the program all_gathers the local blocks and
    unpermutes once per evaluation (a single n_dof gather OUTSIDE the CG --
    the CG program itself stays gather-free).
    """
    elements = elements[0]
    ele_weight = ele_weight[0]
    targets = targets[0]
    ftargets = ftargets[0]
    dof_local = dof[0]
    rhs_local = rhs[0]
    fixed_local = fixed[0]
    sval_local = sval[0]

    # pin prescribed dofs (ref: dirichletBC_dof, stiffnessMtrx.py:344-366)
    dof_local = jnp.where(fixed_local, sval_local, dof_local)
    full_perm = jax.lax.all_gather(dof_local, AXIS, tiled=True)
    dof_orig = full_perm[iperm]  # (n_dof,) -- original dof ordering
    dm = nodes.shape[1]
    u = dof_orig.reshape(-1, dm)
    coords = nodes + u

    dsdX0, _ = assembly.gradients_and_volume(nodes, elements, dN, w)
    F = assembly.deformation_gradient_u(u[elements], dsdX0)
    sigma = assembly.gp_stress(F, material, large=True)
    dsdx, vol = assembly.gradients_and_volume(coords, elements, dN, w)
    vol = vol * ele_weight[:, None]

    # internal force into local (+1 halo) row blocks, one block halo-add
    f_elem = jnp.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)
    fbuf = jax.ops.segment_sum(
        f_elem.reshape(-1), ftargets, num_segments=(nbl + 1) * B
    )
    from_left_f = jax.lax.ppermute(
        fbuf[nbl * B :], AXIS, perm=[(i, i + 1) for i in range(D - 1)]
    )
    f_int = fbuf[: nbl * B].at[:B].add(from_left_f)
    if stab_diag is not None:
        # stabilization / Newmark hook in the permuted block-row space:
        # force scale*M*(dof - ref) on the local rows (padded rows carry
        # diag 0, so they stay inert); the tangent diagonal add happens
        # after V is built below.  Gather-free (eye-masked).
        stab_d = stab_scale[0] * stab_diag[0]
        f_int = f_int + stab_d * (dof_local - stab_ref[0])
    residual = f_int - rhs_local
    residual = jnp.where(fixed_local, 0.0, residual)

    # tangent in block-tridiagonal layout: secant (+ geometric), or the
    # exact consistent tangent (assembly.consistent_tangent -- edof scanned
    # JVPs of the per-element internal force, vmapped over this device's
    # element shard; boundary-duplicated elements scale by ele_weight, legal
    # because Ke is linear in vol)
    if tangent == "consistent":
        Ke = assembly.consistent_tangent(
            dof_orig, elements, nodes, dN, w, material
        ) * ele_weight[:, None, None]
    else:
        Ke = assembly.element_stiffness(dsdx, vol, C)
        if geometric_stiffness:
            Ke = Ke + assembly.geometric_stiffness(dsdx, sigma, vol)
    buf = jax.ops.segment_sum(
        Ke.reshape(-1), targets, num_segments=(nbl + 1) * 3 * B * B
    ).reshape(nbl + 1, 3, B, B)
    from_left_V = jax.lax.ppermute(
        buf[nbl], AXIS, perm=[(i, i + 1) for i in range(D - 1)]
    )
    V = buf[:nbl].at[0].add(from_left_V)
    if stab_diag is not None:
        V = V.at[:, 1].add(
            jnp.eye(B, dtype=V.dtype)[None]
            * stab_d.reshape(nbl, B)[:, :, None]
        )
    V = _btd_dirichlet_newton(D, V, fixed_local)

    res = jnp.sqrt(
        jax.lax.psum(jnp.sum(residual * residual), AXIS) / n_dof
    )
    return dof_local[None], V[None], residual[None], res


def _btd_assemble(D, nbl, B, n_dof,
                  elements, ele_weight, targets,
                  nodes, dN, w, C, rhs, fixed, sval, dof_full):
    """Per-device assembly + Dirichlet: local elements -> (nbl, 3, B, B)
    block-tridiagonal values (one block-row halo-add), then the symmetric
    zero-one elimination.  The coords pick and the segment-sum scatter live
    here, OUTSIDE the CG program."""
    elements = elements[0]
    ele_weight = ele_weight[0]
    targets = targets[0]
    rhs = rhs[0]
    fixed = fixed[0]
    sval = sval[0]

    coords = nodes + dof_full.reshape(nodes.shape)
    dsdx, vol = assembly.gradients_and_volume(coords, elements, dN, w)
    vol = vol * ele_weight[:, None]
    Ke = assembly.element_stiffness(dsdx, vol, C)
    buf = jax.ops.segment_sum(
        Ke.reshape(-1), targets, num_segments=(nbl + 1) * 3 * B * B
    ).reshape(nbl + 1, 3, B, B)
    # halo: my (nbl)-th row block belongs to the right neighbour's block 0
    from_left = jax.lax.ppermute(
        buf[nbl], AXIS, perm=[(i, i + 1) for i in range(D - 1)]
    )
    V = buf[:nbl].at[0].add(from_left)
    V, b = _btd_dirichlet_linear(D, V, rhs, fixed, sval)
    return V[None], b[None]


def _btd_solve(D, eps, max_iters, V, b, minv=None, kind="block"):
    V = V[0]
    b = b[0]
    if minv is None:
        mv = None
    elif kind == "twolevel":
        stack_, Acinv, Zm = minv
        mv = (stack_[0], Acinv, Zm[0])
    else:
        mv = minv[0]
    x, k, rmax = _btd_pcg(
        D, V, b, eps, max_iters, minv_blocks=mv, kind=kind,
    )
    return x[None], k, rmax


class BandedShardedSolver:
    """K(dof) x = rhs on an arbitrary mesh, RCM-banded and block-row-sharded.

    Two jitted shard_map programs: (1) element-sharded assembly with a
    one-block halo-add + Dirichlet elimination, (2) the CG whose SpMV is
    three batched block matmuls -- the compiled CG contains no gather and no
    scatter (the general-mesh twin of the structured slab path).
    """

    def __init__(
        self,
        fe_mesh: FEMesh,
        material: Material,
        devices: Optional[list] = None,
        cg_eps: float = 1.0e-3,
        cg_iters: int = 0,
        block: Optional[int] = None,
        geometric_stiffness: bool = True,
        pattern=None,
        preconditioner: str = "twolevel",
        tangent: str = "secant",
    ):
        devices = devices if devices is not None else jax.devices()
        D = len(devices)
        self.device_mesh = Mesh(np.asarray(devices), (AXIS,))
        ops = build_banded_operands(
            fe_mesh, material, D, block=block, pattern=pattern
        )
        self.ops = ops
        self._material = material
        self._geometric_stiffness = geometric_stiffness
        if tangent not in ("secant", "consistent"):
            raise ValueError(
                f"banded tangent must be 'secant' or 'consistent', got "
                f"{tangent!r}"
            )
        self._tangent = tangent
        if cg_iters <= 0:
            cg_iters = ops.n_dof
        self._cg_cfg = (cg_eps, cg_iters)
        self._newton_step = None
        self._newton_step_stab = None
        # preconditioner setup (once per INCREMENT -- Newton's tangent
        # drifts slowly; CG still converges on the exact operator --
        # invalidated by new_increment()):
        #   "twolevel" (default): exact device-local block-tridiagonal
        #             solve + global rigid-body-mode coarse correction
        #             (_btd_twolevel_factor; 399 -> 33 iterations on the
        #             8-shard harness vs scalar Jacobi)
        #   "tridiag": the one-level local solve only (399 -> 228)
        #   "block":  block-Jacobi D_I^-1 (measured worse than scalar
        #             Jacobi on RCM-banded elasticity, kept for comparison)
        #   "jacobi": scalar 1/diag, no setup
        if preconditioner not in ("twolevel", "tridiag", "block", "jacobi"):
            raise ValueError(
                f"banded preconditioner must be 'twolevel', 'tridiag', "
                f"'block' or 'jacobi', got {preconditioner!r}"
            )
        self._precond_kind = preconditioner
        self._minv_cache = None
        self._last_fixed_s = None

        shard = NamedSharding(self.device_mesh, P(AXIS))
        repl = NamedSharding(self.device_mesh, P())
        self._shard = shard
        self._repl = repl
        put = lambda x, s: jax.device_put(jnp.asarray(x), s)  # noqa: E731
        self._elements = put(ops.elements, shard)
        self._ele_weight = put(ops.ele_weight, shard)
        self._targets = put(ops.scatter_targets, shard)
        self._ftargets = put(ops.force_targets, shard)
        self._iperm = put(ops.iperm, repl)
        self._nodes = put(ops.nodes, repl)
        self._dN = put(ops.dshape_gp, repl)
        self._w = put(ops.weights_gp, repl)
        self._C = put(ops.C, repl)

        from jax import shard_map

        self._assemble = jax.jit(
            shard_map(
                partial(_btd_assemble, D, ops.nbl, ops.B, ops.n_dof),
                mesh=self.device_mesh,
                in_specs=(
                    P(AXIS), P(AXIS), P(AXIS),  # elements, weight, targets
                    P(), P(), P(), P(),  # nodes, dN, w, C
                    P(AXIS), P(AXIS), P(AXIS),  # rhs, fixed, sval
                    P(),  # dof (full, replicated: assembly reads any node)
                ),
                out_specs=(P(AXIS), P(AXIS)),
                check_vma=False,
            )
        )
        self._cg = jax.jit(
            shard_map(
                partial(_btd_solve, D, *self._cg_cfg),
                mesh=self.device_mesh,
                in_specs=(P(AXIS), P(AXIS)),
                out_specs=(P(AXIS), P(), P()),
                check_vma=False,
            )
        )
        if self._precond_kind == "twolevel":
            minv_spec = (P(AXIS), P(), P(AXIS))
            self._Zgeo = put(
                build_coarse_basis(ops, fe_mesh.nodes, fe_mesh.dm), shard
            )
            self._factor = jax.jit(
                shard_map(
                    partial(_btd_twolevel_factor, D),
                    mesh=self.device_mesh,
                    in_specs=(P(AXIS), P(AXIS), P(AXIS)),
                    out_specs=minv_spec,
                    check_vma=False,
                )
            )
        else:
            minv_spec = P(AXIS)
            self._factor = jax.jit(
                shard_map(
                    _btd_thomas_factor
                    if self._precond_kind == "tridiag"
                    else _btd_block_inv,
                    mesh=self.device_mesh,
                    in_specs=(P(AXIS),),
                    out_specs=minv_spec,
                    check_vma=False,
                )
            )
        self._cg_precond = jax.jit(
            shard_map(
                partial(
                    _btd_solve, D, *self._cg_cfg, kind=self._precond_kind
                ),
                mesh=self.device_mesh,
                in_specs=(P(AXIS), P(AXIS), minv_spec),
                out_specs=(P(AXIS), P(), P()),
                check_vma=False,
            )
        )

    # ------------------------------------------------------------------ #
    def _stack(self, v, fill=0.0):
        """Original-dof host vector -> permuted, padded (D, nbl*B) blocks."""
        ops = self.ops
        n_pad = ops.n_devices * ops.nbl * ops.B
        out = np.full(n_pad, fill, dtype=np.asarray(v).dtype)
        out[: ops.n_dof] = np.asarray(v)[ops.perm]
        return jax.device_put(
            jnp.asarray(out.reshape(ops.n_devices, -1)), self._shard
        )

    def solve(self, rhs: np.ndarray, fixed: np.ndarray, sval: np.ndarray,
              dof=None):
        """Assemble K(dof), eliminate Dirichlet dofs, solve K x = rhs."""
        ops = self.ops
        # padded rows are marked fixed: identity rows pinned to zero
        rhs_s = self._stack(np.asarray(rhs, dtype=float))
        fixed_s = self._stack(np.asarray(fixed, dtype=bool), fill=True)
        sval_s = self._stack(np.asarray(sval, dtype=float))
        dof_full = jnp.zeros(ops.n_dof) if dof is None else jnp.asarray(dof)
        V, b = self._assemble(
            self._elements, self._ele_weight, self._targets,
            self._nodes, self._dN, self._w, self._C,
            rhs_s, fixed_s, sval_s, dof_full,
        )
        x_s, iters, rmax = self._run_cg(V, b, fixed_s=fixed_s, fresh=True)
        xp = np.asarray(x_s).reshape(-1)[: ops.n_dof]
        x = np.empty(ops.n_dof)
        x[ops.perm] = xp
        return x, int(iters)

    def _run_cg(self, V, b, fixed_s=None, fresh: bool = False):
        """CG dispatch with the per-increment cached preconditioner setup
        (two-level/Thomas factors or block-Jacobi D_I^-1); ``fresh=True``
        recomputes the setup from this V.  ``fixed_s`` (stacked Dirichlet
        mask) feeds the coarse-basis row masking of the two-level setup;
        it is remembered across calls (constant within an analysis)."""
        if self._precond_kind == "jacobi":
            return self._cg(V, b)
        if fixed_s is not None:
            self._last_fixed_s = fixed_s
        if fresh or self._minv_cache is None:
            if self._precond_kind == "twolevel":
                if self._last_fixed_s is None:
                    raise ValueError(
                        "twolevel preconditioner needs the Dirichlet mask; "
                        "pass fixed_s to cg()/solve()"
                    )
                self._minv_cache = self._factor(
                    V, self._Zgeo, self._last_fixed_s
                )
            else:
                self._minv_cache = self._factor(V)
        return self._cg_precond(V, b, self._minv_cache)

    def new_increment(self):
        """Invalidate the cached preconditioner setup (called by the host
        state machine at the start of every load increment)."""
        self._minv_cache = None

    # ------------------------------------------------------------------ #
    # Newton path (used by FEMSystem when SolverConfig.sharding="banded"):
    # the SAME host state machine as single-device / slab-sharded runs
    # drives these two sharded programs per iteration.  The working dof and
    # du live in the permuted (D, nbl*B) block space; the state machine's
    # dof arithmetic (boost/relax line search) is elementwise, so it works
    # on the blocks unchanged.
    # ------------------------------------------------------------------ #
    def stack(self, v) -> jax.Array:
        """Global (n_dof,) host vector -> permuted (D, nbl*B) device blocks."""
        return self._stack(np.asarray(v))

    def unstack(self, blocks) -> np.ndarray:
        """(D, nbl*B) blocks -> global (n_dof,) numpy, original ordering."""
        ops = self.ops
        xp = np.asarray(blocks).reshape(-1)[: ops.n_dof]
        x = np.empty(ops.n_dof, dtype=xp.dtype)
        x[ops.perm] = xp
        return x

    def newton_eval(self, dof_s, rhs_s, fixed_s, sval_s, stab_s=None):
        """(stacked dof, rhs, fixed, sval) -> (pinned dof, BC'd tangent
        blocks, BC'd residual blocks, rms residual) -- one sharded program.

        ``stab_s``: optional (stab_diag_s, stab_ref_s, scale) stabilization
        operands (config.stabilize_factor under sharding): stacked
        diagonal/reference blocks + a replicated (1,) scale."""
        from jax import shard_map

        ops = self.ops
        fn = partial(
            _btd_newton_eval, ops.n_devices, ops.nbl, ops.B, ops.n_dof,
            self._material, self._geometric_stiffness, self._tangent,
        )
        base_specs = (
            P(AXIS), P(AXIS), P(AXIS), P(AXIS),  # ele/wt/tgt/ftgt
            P(), P(), P(), P(), P(),  # iperm, nodes, dN, w, C
            P(AXIS), P(AXIS), P(AXIS), P(AXIS),
        )
        if stab_s is None:
            if self._newton_step is None:
                self._newton_step = jax.jit(
                    shard_map(
                        fn,
                        mesh=self.device_mesh,
                        in_specs=base_specs,
                        out_specs=(P(AXIS), P(AXIS), P(AXIS), P()),
                        check_vma=False,
                    )
                )
            return self._newton_step(
                self._elements, self._ele_weight, self._targets,
                self._ftargets, self._iperm, self._nodes, self._dN, self._w,
                self._C, dof_s, rhs_s, fixed_s, sval_s,
            )
        if self._newton_step_stab is None:
            self._newton_step_stab = jax.jit(
                shard_map(
                    fn,
                    mesh=self.device_mesh,
                    in_specs=base_specs + (P(AXIS), P(AXIS), P()),
                    out_specs=(P(AXIS), P(AXIS), P(AXIS), P()),
                    check_vma=False,
                )
            )
        diag_s, ref_s, scale = stab_s
        return self._newton_step_stab(
            self._elements, self._ele_weight, self._targets, self._ftargets,
            self._iperm, self._nodes, self._dN, self._w, self._C,
            dof_s, rhs_s, fixed_s, sval_s, diag_s, ref_s, scale,
        )

    def cg(self, values_s, b_s, fixed=None, fixed_s=None):
        """Sharded gather-free CG on BC'd block-tridiagonal values (the
        Newton linear solve).  ``fixed_s`` masks the two-level coarse
        basis (the operator itself is already eliminated)."""
        return self._run_cg(values_s, b_s, fixed_s=fixed_s)
