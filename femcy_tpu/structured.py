"""Dense scatter-free assembly for structured box_tets meshes.

Any indexed op over the ~E*edof^2 stiffness contributions is a 150M-entry
scatter at the 1M-element scale.  On a structured Kuhn-subdivided box
(meshgen.box_tets) none of that is necessary:
elements of one orientation form a dense cell grid, and every (orientation,
local-row-node, local-col-node, i, j) combination writes to ONE diagonal
offset of the DIA matrix with ONE static {0,1}^3 corner shift.  Assembly then
is 864 statically-padded dense adds of cell-grid arrays -- pure streaming
work, no scatter instruction at all.

This is the structured-grid fast path; unstructured meshes use the general
segment-sum scatter (assembly.scatter_stiffness / dia_scatter).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from femcy_tpu.mesh import FEMesh
from femcy_tpu.solvers.dia import DIAPattern


@dataclasses.dataclass(frozen=True)
class StructuredPlan:
    nx: int
    ny: int
    nz: int
    n_offsets: int
    #: (i, k) -> list of (orientation, 3a+i, 3b+j, (dx, dy, dz)) combos
    groups: Dict[Tuple[int, int], List[Tuple[int, int, int, Tuple[int, int, int]]]]


def build_structured_plan(mesh: FEMesh, dia: DIAPattern) -> StructuredPlan:
    """Map every element-stiffness entry class to its DIA slot, host-side."""
    info = mesh.structure
    assert info is not None and info["kind"] == "box_tets"
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    kuhn = info["kuhn"]
    delta = np.asarray(info["corner_delta"])  # (8, 3) cube corner offsets

    def node_stride():
        return np.array([(ny + 1) * (nz + 1), nz + 1, 1])

    stride = node_stride()
    offsets = np.asarray(dia.offsets)
    groups: Dict[Tuple[int, int], List] = {}
    for o, corners in enumerate(kuhn):
        d = delta[list(corners)]  # (4, 3) corner offset of each tet node
        for a in range(4):
            for b in range(4):
                node_off = int((d[b] - d[a]) @ stride)
                for i in range(3):
                    for j in range(3):
                        off = 3 * node_off + (j - i)
                        k = int(np.searchsorted(offsets, off))
                        assert offsets[k] == off, "offset missing from DIA"
                        key = (i, k)
                        groups.setdefault(key, []).append(
                            (o, 3 * a + i, 3 * b + j, tuple(int(x) for x in d[a]))
                        )
    return StructuredPlan(
        nx=nx, ny=ny, nz=nz, n_offsets=dia.n_offsets, groups=groups
    )


def structured_element_nodes(node_vals, mesh: FEMesh):
    """Per-element nodal values without the ``vals[elements]`` gather.

    node_vals : (n_nodes, dm) -> (E, n, dm) in box_tets element order.
    The 8 cell-corner grids are static slices of the node grid; each
    element's 4 nodes are static picks of its cell's corners, so the access
    streams with no index arrays.
    """
    info = mesh.structure
    assert info is not None and info["kind"] == "box_tets"
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    dm = node_vals.shape[-1]
    grid = node_vals.reshape(nx + 1, ny + 1, nz + 1, dm)
    corner = np.asarray(info["corner_delta"])  # (8, 3)
    corners = jnp.stack(
        [
            grid[dx : dx + nx, dy : dy + ny, dz : dz + nz]
            for dx, dy, dz in corner
        ],
        axis=3,
    )  # (nx, ny, nz, 8, dm)
    cells = corners.reshape(nx * ny * nz, 8, dm)
    per_orient = jnp.stack(
        [
            jnp.stack([cells[:, ci] for ci in c], axis=1)  # static picks
            for c in info["kuhn"]
        ],
        axis=1,
    )  # (nc, 6, 4, dm)
    return per_orient.reshape(-1, per_orient.shape[2], dm)


def structured_dia_scatter(Ke, plan: StructuredPlan):
    """Element stiffnesses (E, 12, 12) -> DIA values (n_dof, K), gather-free.

    E must be 6 * nx * ny * nz in box_tets cell-major order.  Prefer
    :func:`structured_assemble` at scale -- it computes Ke one orientation at
    a time, which keeps the live-buffer peak small.
    """
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    Ke_grid = Ke.reshape(nx * ny * nz, 6, 12, 12)
    # one explicit transpose per orientation (2x the Ke bytes) buys the
    # contiguous (p, q) cell-grid reads _accumulate depends on
    return _accumulate(
        lambda o: jnp.transpose(Ke_grid[:, o], (1, 2, 0)), plan, Ke.dtype
    )


#: Bsel[v, i, d] = 1 iff the Voigt-row-v B-matrix entry of dof (node a,
#: dim i) is dsdx[a, d] (the 3D B layout of assembly.b_matrix)
_BSEL = np.zeros((6, 3, 3))
for _v, _pairs in enumerate(
    [[(0, 0)], [(1, 1)], [(2, 2)], [(0, 1), (1, 0)], [(0, 2), (2, 0)],
     [(1, 2), (2, 1)]]
):
    for _i, _d in _pairs:
        _BSEL[_v, _i, _d] = 1.0


def isotropic_lame(C_host: np.ndarray, rtol: float = 1.0e-6):
    """(lam, mu) if the 6x6 Voigt tangent is isotropic, else None."""
    C = np.asarray(C_host, dtype=np.float64)
    if C.shape != (6, 6):
        return None
    lam = float(C[0, 1])
    mu = float(C[3, 3])
    iso = np.zeros((6, 6))
    iso[:3, :3] = lam
    iso[np.arange(3), np.arange(3)] = lam + 2.0 * mu
    iso[np.arange(3, 6), np.arange(3, 6)] = mu
    scale = np.abs(C).max()
    if scale == 0.0 or np.abs(C - iso).max() > rtol * scale:
        return None
    return lam, mu


def _coordinate_planes(coords, mesh: FEMesh, ap):
    """Corner-coordinate planes in the kernel's padded cell space.

    coords (n_nodes, 3) -> (xpl (8, 3, length), valid (length,) bool): the
    cheap XLA front of the kernel assembly path (~19 MB at 1M elements).
    """
    info = mesh.structure
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    dm = coords.shape[-1]
    grid = coords.reshape(nx + 1, ny + 1, nz + 1, dm)
    gridp = jnp.pad(grid, ((ap.x_front, ap.x_back), (0, 1), (0, 1), (0, 0)))
    X = ap.x_front + nx + ap.x_back
    corner = np.asarray(info["corner_delta"])  # (8, 3)
    # (8, 3, Lc): corner coordinate planes, cell-minor
    xpl = jnp.stack(
        [
            jnp.stack(
                [
                    gridp[dx : dx + X, dy : dy + ny + 1, dz : dz + nz + 1, D]
                    .reshape(-1)
                    for D in range(dm)
                ]
            )
            for dx, dy, dz in corner
        ]
    )
    shape = (X, ny + 1, nz + 1)
    ix = jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    iy = jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    iz = jax.lax.broadcasted_iota(jnp.int32, shape, 2)
    valid = (
        (ix >= ap.x_front) & (ix < ap.x_front + nx) & (iy < ny) & (iz < nz)
    ).reshape(-1)
    return xpl, valid


def _prep_planes(coords, mesh: FEMesh, C, plan: StructuredPlan, ap,
                 C_host=None):
    """Element stiffnesses straight from node coordinates, in PLANE-MAJOR
    (structure-of-arrays) layout: each quantity is a small stack of
    (cells,) vectors, so the (144, cells) stiffness planes the accumulate
    kernel reads are produced in their native layout with no relayout.

    Pad cells slice all-zero node coordinates; their gradients are masked
    to zero so their stiffness contribution is exactly zero.  Returns the 6
    per-orientation (144, length) stiffness planes in the kernel's padded
    cell space (kernels/structured_accumulate).
    """
    info = mesh.structure
    xpl, valid = _coordinate_planes(coords, mesh, ap)

    # static quadrature tables from the mesh (dN/w args may be traced)
    dN0 = np.asarray(mesh.element.dshape_at_gp)[0]  # (4, 3), one Gauss point
    w0 = float(np.asarray(mesh.element.gauss_weights)[0])
    # an isotropic tangent collapses the quadratic form to 3 terms (the
    # generic 9-term contraction below makes XLA materialise the
    # (4,3,4,3,cells) terms; PERF.md has both times)
    lame = isotropic_lame(C_host) if C_host is not None else None
    # quadratic-form coefficients T[i, d, j, f] = sum_vw Bsel C Bsel
    T = jnp.einsum("vid,vw,wjf->idjf", jnp.asarray(_BSEL, C.dtype), C,
                   jnp.asarray(_BSEL, C.dtype))

    planes = []
    for corners_o in info["kuhn"]:
        xo = xpl[np.asarray(corners_o)]  # (4, 3, Lc)
        # dx/dxi planes: dxdn[D, d] = sum_n x[n, D] * dN0[n, d]
        dxdn = [
            [
                sum(float(dN0[n, d]) * xo[n, D] for n in range(4))
                for d in range(3)
            ]
            for D in range(3)
        ]
        # closed-form cofactors / det / inverse, all (Lc,) lane vectors
        cof = [
            [
                dxdn[(D + 1) % 3][(d + 1) % 3] * dxdn[(D + 2) % 3][(d + 2) % 3]
                - dxdn[(D + 1) % 3][(d + 2) % 3]
                * dxdn[(D + 2) % 3][(d + 1) % 3]
                for d in range(3)
            ]
            for D in range(3)
        ]
        det = sum(dxdn[0][d] * cof[0][d] for d in range(3))
        vol = jnp.where(valid, det * w0, 0.0)
        inv_det = jnp.where(valid, 1.0 / jnp.where(valid, det, 1.0), 0.0)
        # inv[d][D] = cof[D][d] / det; dsdx[n][D] = sum_d dN0[n,d] inv[d][D]
        ds = [
            [
                sum(float(dN0[n, d]) * cof[D][d] for d in range(3)) * inv_det
                for D in range(3)
            ]
            for n in range(4)
        ]
        if lame is not None:
            # Ke[(a,i),(b,j)] = vol*(lam dNa_i dNb_j + mu dNa_j dNb_i
            #                        + delta_ij mu dNa.dNb): built in
            # per-(a,i) 12-row blocks.  Full-broadcast terms make XLA
            # materialise large intermediates; an explicit 144-row loop
            # fuses but compiles slowly; 12-row blocks keep the fusion
            # while the graph stays ~500 ops.
            lam, mu = lame
            D12 = jnp.stack([ds[b][j] for b in range(4) for j in range(3)])
            G = [
                jnp.stack(
                    [sum(ds[a][d] * ds[b][d] for d in range(3))
                     for b in range(4)]
                )
                for a in range(4)
            ]  # per a: (4, Lc)
            eye = np.eye(3)
            rows = []
            for a in range(4):
                Aj = jnp.stack([ds[a][j] for j in range(3)])  # (3, Lc)
                for i in range(3):
                    Bi = jnp.stack([ds[b][i] for b in range(4)])  # (4, Lc)
                    blk = (
                        lam * (ds[a][i] * D12).reshape(4, 3, -1)
                        + mu * (Bi[:, None, :] * Aj[None, :, :])
                        + (mu * jnp.asarray(eye[i], D12.dtype))[None, :, None]
                        * G[a][:, None, :]
                    )
                    rows.append((blk * vol).reshape(12, -1))
            planes.append(jnp.concatenate(rows, axis=0))
            continue
        dsdx = jnp.stack([jnp.stack(row) for row in ds])  # (4, 3, Lc)
        # Ke[a, i, b, j] = vol * sum_{d,f} T[i,d,j,f] dsdx[a,d] dsdx[b,f]
        Ke = None
        for d in range(3):
            for f in range(3):
                term = (
                    dsdx[:, None, None, None, d]  # (4,1,1,1,Lc): a-planes
                    * dsdx[None, None, :, None, f]  # (1,1,4,1,Lc): b-planes
                    * T[:, d, :, f][None, :, None, :, None]  # (1,3,1,3,1)
                )
                Ke = term if Ke is None else Ke + term
        planes.append((Ke * vol).reshape(144, -1))
    return planes


def kernel_assembly_eligible(mesh: FEMesh, dtype) -> bool:
    """Host-side check: will structured_assemble_coords take the Triton
    kernel path in auto mode?  (GPU backend, 4-byte dtype, one Gauss point
    i.e. C3D4.)  Callers use this to avoid routing coords through the XLA
    fallback when precomputed gradients are already at hand."""
    return (
        jax.default_backend() == "gpu"
        and jnp.dtype(dtype).itemsize == 4
        and mesh.element.dshape_at_gp.shape[0] == 1
    )


def structured_assemble_coords(coords, mesh: FEMesh, dN, w, C,
                               plan: StructuredPlan, accumulate=None,
                               C_host=None, interpret: bool = False):
    """Node coordinates -> DIA values via the fastest available path.

    accumulate: None (auto: the Triton accumulate kernel on a GPU with a
    4-byte dtype and a one-Gauss-point element -- with the isotropic
    3-term prep when ``C_host`` is an isotropic tangent -- XLA otherwise),
    "triton" (forced; raises for elements with more than one Gauss point,
    and off-GPU unless ``interpret=True`` runs the kernel in interpret mode
    for tests) or "xla".  Auto never picks interpret mode.

    C_host: optional HOST numpy copy of the material tangent; an isotropic
    one selects the 3-term prep (the values are baked in as static scalars,
    so it needs them at trace time; traced-only C takes the 9-term prep).

    The kernel path integrates with the element's OWN static quadrature
    tables (mesh.element.dshape_at_gp / gauss_weights); dN/w exist for the
    XLA path's signature symmetry and must be those same tables.
    """
    from femcy_tpu import assembly
    from femcy_tpu.kernels import structured_accumulate as sa

    mode = accumulate
    if mode is None:
        mode = "triton" if kernel_assembly_eligible(mesh, coords.dtype) else "xla"
    if mode == "triton":
        if mesh.element.dshape_at_gp.shape[0] != 1:
            raise ValueError(
                "accumulate='triton' needs a one-Gauss-point element (C3D4)"
            )
        ap = sa.build_accumulate_plan(plan, interpret=interpret)
        planes = _prep_planes(coords, mesh, C, plan, ap, C_host=C_host)
        return sa.accumulate(ap, planes)
    if mode != "xla":
        raise ValueError(f"unknown accumulate mode {accumulate!r}")
    x_e = structured_element_nodes(coords, mesh)
    dsdx, vol = assembly.gradients_and_volume_x(x_e, dN, w)
    return structured_assemble(dsdx, vol, C, plan)


def _accumulate(ke_of_orientation, plan: StructuredPlan, dtype):
    """Accumulate per-orientation element stiffnesses into the DIA layout.

    ``ke_of_orientation(o)`` must return the (12, 12, cells) TRANSPOSED
    element stiffnesses: the column build reads one (p, q) cell grid per
    contribution, and in this layout each read is a contiguous stream
    (element-major Ke made it a stride-144 pick -- one cache line per
    element).

    Per orientation: every touched (i, k) column is the sum of statically
    padded cell grids (pure streaming adds); the 3*K columns are stacked and
    added to the running matrix.  An optimization_barrier between
    orientations keeps XLA from scheduling all six sub-graphs' buffers live
    at once (which OOMs at the 1M-element scale), and avoiding
    dynamic-update-slices keeps it fast.
    """
    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    by_orient: Dict[int, Dict[Tuple[int, int], List]] = {o: {} for o in range(6)}
    for (i, k), combos in plan.groups.items():
        for o, p, q, shift in combos:
            by_orient[o].setdefault((i, k), []).append((p, q, shift))

    # Work in FLAT node space: padding each (p, q) cell grid once with one
    # zero layer per axis makes every corner-shifted 3D pad equal to a 1D
    # static slice at offset dx*sx + dy*sy + dz (the zero layers absorb the
    # axis wrap-around, exactly like the DIA SpMV's shifted slices).  Flat
    # vectors avoid odd-sized (57-wide) minor dimensions.
    sx, sy = (ny + 1) * (nz + 1), nz + 1
    Nn = (nx + 1) * sx
    pad_lo = sx + sy + 1  # the largest corner shift
    zero_col = None
    mat = jnp.zeros((3 * K, Nn), dtype=dtype)
    for o in range(6):
        Ko = ke_of_orientation(o).reshape(12, 12, nx, ny, nz)
        Kop = jnp.pad(
            Ko, ((0, 0), (0, 0), (0, 1), (0, 1), (0, 1))
        ).reshape(12, 12, Nn)
        Kop = jnp.pad(Kop, ((0, 0), (0, 0), (pad_lo, 0)))
        cols = []
        for i in range(3):
            for k in range(K):
                combos = by_orient[o].get((i, k))
                if not combos:
                    if zero_col is None:
                        zero_col = jnp.zeros((Nn,), dtype=dtype)
                    cols.append(zero_col)
                    continue
                acc = None
                for p, q, (dx, dy, dz) in combos:
                    off = dx * sx + dy * sy + dz
                    term = jax.lax.slice(
                        Kop[p, q], (pad_lo - off,), (pad_lo - off + Nn,)
                    )
                    acc = term if acc is None else acc + term
                cols.append(acc)
        contrib = jnp.stack(cols, axis=0)  # (3K, Nn), each row contiguous
        mat = jax.lax.optimization_barrier(mat + contrib)
    # (3K, Nn) -> (n_dof, K): rows are node*3 + i, columns the offsets
    return jnp.transpose(mat.reshape(3, K, Nn), (2, 0, 1)).reshape(-1, K)


def structured_assemble(dsdx, vol, C, plan: StructuredPlan):
    """Gradients/volumes -> DIA values, computing Ke one Kuhn orientation at
    a time so only one sixth of the element matrices is ever live (the XLA
    shifted-slice accumulate; structured_assemble_coords routes to the
    Triton kernel where supported).

    dsdx: (E, G, 4, 3), vol: (E, G) in box_tets cell-major order.
    """
    from femcy_tpu import assembly

    E = dsdx.shape[0]
    nc = E // 6
    dsdx_o = dsdx.reshape(nc, 6, *dsdx.shape[1:])
    vol_o = vol.reshape(nc, 6, vol.shape[1])

    def ke_of(o):
        # (12, 12, cells) straight out of the einsum: XLA emits the layout
        # directly, so the contiguous reads in _accumulate cost no transpose
        return assembly.element_stiffness(
            dsdx_o[:, o], vol_o[:, o], C, layout="ije"
        )

    return _accumulate(ke_of, plan, dsdx.dtype)


def structured_force_scatter(f_elem, plan: StructuredPlan, mesh: FEMesh):
    """Per-element nodal forces (E, 4, 3) -> global force (n_dof,), gather-free.

    Same corner-shift idea as the stiffness path: 6 orientations x 4 local
    nodes x 3 dims = 72 statically-padded dense adds.
    """
    info = mesh.structure
    nx, ny, nz = plan.nx, plan.ny, plan.nz
    kuhn = info["kuhn"]
    delta = np.asarray(info["corner_delta"])
    fg = f_elem.reshape(nx, ny, nz, 6, 4, 3)
    out = jnp.zeros((nx + 1, ny + 1, nz + 1, 3), dtype=f_elem.dtype)
    for o, corners in enumerate(kuhn):
        d = delta[list(corners)]
        for a in range(4):
            dx, dy, dz = (int(v) for v in d[a])
            out = out.at[dx : dx + nx, dy : dy + ny, dz : dz + nz, :].add(
                fg[:, :, :, o, a, :]
            )
    return out.reshape(-1)


def analytic_cell_tensor(
    mesh: FEMesh, C: np.ndarray, dia: DIAPattern
) -> np.ndarray:
    """The per-corner-shift constant row tensor c[sx, sy, sz, i, k] of a
    uniform box_tets grid with a constant material tangent -- the entire
    operator, compressed to (2, 2, 2, 3, K) numpy (~11 KB).

    The assembled operator is translation invariant: every cell contributes
    the same 6-tet stiffness, so a node's row is the sum over its <= 8
    adjacent cells of this tensor, masked by cell existence (the only thing
    that varies near the boundary).  ``analytic_structured_dia_values`` does
    that broadcast in numpy; ``analytic_dia_values_device`` does it on
    device (so multigrid setup uploads kilobytes, not the broadcast result).
    """
    info = mesh.structure
    assert info is not None and info["kind"] == "box_tets"
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    kuhn = info["kuhn"]
    delta = np.asarray(info["corner_delta"])
    spacing = np.array(
        [
            mesh.nodes[:, 0].max() / nx,
            mesh.nodes[:, 1].max() / ny,
            mesh.nodes[:, 2].max() / nz,
        ]
    )
    elem = mesh.element
    dN = np.asarray(elem.dshape_at_gp)  # (G, n, 3)
    w = np.asarray(elem.gauss_weights)
    C = np.asarray(C)

    # one cell's per-orientation element stiffness, plain numpy (same math as
    # assembly.element_stiffness; 6 tiny matrices)
    corner_x = delta * spacing  # (8, 3) physical corner coords
    Ke = np.zeros((6, 12, 12))
    for o, corners in enumerate(kuhn):
        x = corner_x[list(corners)]  # (4, 3)
        dxdn = np.einsum("nD,gnd->gDd", x, dN)  # (G, 3, 3)
        dsdx = np.einsum("gnd,gdD->gnD", dN, np.linalg.inv(dxdn))
        vol = np.linalg.det(dxdn) * w  # (G,)
        G, n = dsdx.shape[0], dsdx.shape[1]
        B = np.zeros((G, 6, 3 * n))
        Nx, Ny, Nz = dsdx[..., 0], dsdx[..., 1], dsdx[..., 2]
        B[:, 0, 0::3], B[:, 1, 1::3], B[:, 2, 2::3] = Nx, Ny, Nz
        B[:, 3, 0::3], B[:, 3, 1::3] = Ny, Nx
        B[:, 4, 0::3], B[:, 4, 2::3] = Nz, Nx
        B[:, 5, 1::3], B[:, 5, 2::3] = Nz, Ny
        Ke[o] = np.einsum("gai,ab,gbj,g->ij", B, C, B, vol)

    # per-corner-shift constant row tensor c[sx, sy, sz, i, k]
    offsets = np.asarray(dia.offsets)
    K = dia.n_offsets
    stride = np.array([(ny + 1) * (nz + 1), nz + 1, 1])
    c = np.zeros((2, 2, 2, 3, K))
    for o, corners in enumerate(kuhn):
        d = delta[list(corners)]
        for a in range(4):
            sx, sy, sz = (int(v) for v in d[a])
            for b in range(4):
                node_off = int((d[b] - d[a]) @ stride)
                for i in range(3):
                    for j in range(3):
                        k = int(np.searchsorted(offsets, 3 * node_off + (j - i)))
                        assert offsets[k] == 3 * node_off + (j - i)
                        c[sx, sy, sz, i, k] += Ke[o, 3 * a + i, 3 * b + j]
    return c


def analytic_structured_dia_values(
    mesh: FEMesh, C: np.ndarray, dia: DIAPattern
) -> np.ndarray:
    """DIA values of the assembled operator on a uniform box_tets grid with a
    constant material tangent, built in O(n_dof * K) numpy from ONE cell
    (see analytic_cell_tensor).  This replaces rediscretizing whole coarse
    grids through the CPU backend in the multigrid setup (eager per-op
    dispatch measured ~8 minutes at the 1M-element scale) with a closed-form
    broadcast."""
    info = mesh.structure
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    c = analytic_cell_tensor(mesh, C, dia)
    K = c.shape[-1]

    # broadcast through separable cell-existence masks: the cell at
    # (p - s) exists iff s <= p <= n-1+s along each axis
    V = np.zeros((nx + 1, ny + 1, nz + 1, 3, K))
    masks = {
        0: [(np.arange(n + 1) <= n - 1).astype(float) for n in (nx, ny, nz)],
        1: [(np.arange(n + 1) >= 1).astype(float) for n in (nx, ny, nz)],
    }
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                m = (
                    masks[sx][0][:, None, None]
                    * masks[sy][1][None, :, None]
                    * masks[sz][2][None, None, :]
                )
                V += m[..., None, None] * c[sx, sy, sz]
    return V.reshape(-1, K)


def analytic_dia_values_device(c, grid, offsets, diag_idx: int, fixed):
    """Device twin of analytic_structured_dia_values + homogeneous Dirichlet
    elimination, jit-traceable.

    c : (2, 2, 2, 3, K) cell tensor (analytic_cell_tensor), ~11 KB
    grid : static (nx, ny, nz)
    fixed : (n_dof,) bool

    Returns the BC-eliminated (n_dof, K) values.  Built for the multigrid
    setup: uploading only c and the masks and broadcasting on device makes
    setup upload-free.
    """
    nx, ny, nz = (int(d) for d in grid)
    c = jnp.asarray(c)
    K = c.shape[-1]
    masks = {
        0: [
            (jnp.arange(n + 1) <= n - 1).astype(c.dtype) for n in (nx, ny, nz)
        ],
        1: [(jnp.arange(n + 1) >= 1).astype(c.dtype) for n in (nx, ny, nz)],
    }
    V = jnp.zeros((nx + 1, ny + 1, nz + 1, 3, K), dtype=c.dtype)
    for sx in (0, 1):
        for sy in (0, 1):
            for sz in (0, 1):
                m = (
                    masks[sx][0][:, None, None]
                    * masks[sy][1][None, :, None]
                    * masks[sz][2][None, None, :]
                )
                V = V + m[..., None, None] * c[sx, sy, sz]
    values = V.reshape(-1, K)

    # homogeneous symmetric zero-one elimination (device twin of
    # dia_dirichlet_linear_numpy)
    n = values.shape[0]
    off_list = [int(o) for o in np.asarray(offsets)]
    pad_lo = max(0, -min(off_list))
    pad_hi = max(0, max(off_list))
    fixed_pad = jnp.pad(fixed, (pad_lo, pad_hi))
    col_fixed = jnp.stack(
        [
            jax.lax.slice(fixed_pad, (pad_lo + off,), (pad_lo + off + n,))
            for off in off_list
        ],
        axis=1,
    )
    values = jnp.where(col_fixed | fixed[:, None], 0.0, values)
    return values.at[:, diag_idx].set(
        jnp.where(fixed, 1.0, values[:, diag_idx])
    )


def dia_to_dense_device(values, offsets):
    """(n, K) DIA values -> (n, n) dense, on device.

    Production use: the small-model dense-CG path
    (SolverConfig.dense_operator_max_dof; FEMSystem._dense_cg_core)
    scatters the BC'd DIA operator to dense IN-PROGRAM so the fused-Newton
    CG matvec is a gather-free dense stream.  The multigrid setup builds
    coarse operators on the HOST; analytic_dia_values_device and
    multigrid.newton_schulz_inverse are device-side alternates."""
    n, K = values.shape
    rows = jnp.arange(n)[:, None]
    cols = rows + jnp.asarray(np.asarray(offsets))[None, :]
    valid = (cols >= 0) & (cols < n)
    contrib = jnp.where(valid, values, 0.0)
    # every valid (row, col) pair is unique; clipped invalid slots add 0
    return (
        jnp.zeros((n, n), dtype=values.dtype)
        .at[rows, jnp.clip(cols, 0, n - 1)]
        .add(contrib)
    )


def dia_dirichlet_linear_numpy(
    values: np.ndarray, offsets, diag_idx: int, fixed: np.ndarray
) -> np.ndarray:
    """Host twin of solvers.dia.dia_dirichlet_linear for homogeneous
    (sval = 0) elimination -- used by the multigrid setup so coarse levels
    never touch a device."""
    n = fixed.shape[0]
    pad_lo = max(0, -min(offsets))
    pad_hi = max(0, max(offsets))
    fixed_pad = np.pad(np.asarray(fixed, dtype=bool), (pad_lo, pad_hi))
    col_fixed = np.stack(
        [fixed_pad[pad_lo + off : pad_lo + off + n] for off in offsets], axis=1
    )
    out = np.where(col_fixed | fixed[:, None], 0.0, values)
    out[:, diag_idx] = np.where(fixed, 1.0, out[:, diag_idx])
    return out


def cell_gradients(mesh: FEMesh):
    """Per-orientation shape gradients/volumes of ONE uniform-grid cell,
    plain numpy: (dsdx (6, G, 4, 3), vol (6, G)).

    On a uniform box every cell of an orientation has identical kinematics,
    so device programs broadcast these instead of gathering node coordinates
    per element (keeps the sharded structured program gather-free)."""
    info = mesh.structure
    assert info is not None and info["kind"] == "box_tets"
    nx, ny, nz = info["nx"], info["ny"], info["nz"]
    spacing = np.array(
        [
            mesh.nodes[:, 0].max() / nx,
            mesh.nodes[:, 1].max() / ny,
            mesh.nodes[:, 2].max() / nz,
        ]
    )
    delta = np.asarray(info["corner_delta"]) * spacing
    dN = np.asarray(mesh.element.dshape_at_gp)  # (G, 4, 3)
    w = np.asarray(mesh.element.gauss_weights)
    dsdx = np.zeros((6, dN.shape[0], 4, 3))
    vol = np.zeros((6, dN.shape[0]))
    for o, corners in enumerate(info["kuhn"]):
        x = delta[list(corners)]  # (4, 3)
        dxdn = np.einsum("nD,gnd->gDd", x, dN)
        dsdx[o] = np.einsum("gnd,gdD->gnD", dN, np.linalg.inv(dxdn))
        vol[o] = np.linalg.det(dxdn) * w
    return dsdx, vol
