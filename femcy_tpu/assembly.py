"""Device-side assembly: vmapped element kinematics + one segment-sum scatter.

The reference's hot kernels (stiffnessMtrx.py:132-216, 532-556, 609-644) are
Taichi loops with atomic scatter-adds and a per-entry linear search.  Here the
same math is expressed as batched einsums over static quadrature tables -- the
B^T C B contraction is a batched matmul -- followed by
a single ``segment_sum`` over host-presorted indices (see topology.py).

All functions are pure and shape-static; the system jits them.
"""

from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from femcy_tpu.linalg import det_small, inv_small


def gradients_and_volume_x(x, dshape_gp, weights_gp):
    """gradients_and_volume on pre-gathered element coordinates
    x : (E, n, dm) -- callers with structured meshes build x by static
    slicing (structured.structured_element_nodes) instead of the
    ``coords[elements]`` gather."""
    dxdn = jnp.einsum("enD,gnd->egDd", x, dshape_gp)
    inv = inv_small(dxdn)  # (E, G, d, D)
    dsdx = jnp.einsum("gnd,egdD->egnD", dshape_gp, inv)
    vol = det_small(dxdn) * weights_gp[None, :]
    return dsdx, vol


def gradients_and_volume(coords, elements, dshape_gp, weights_gp):
    """Shape-function gradients and integration volumes per (element, GP).

    Parameters
    ----------
    coords : (N, dm) nodal coordinates of the configuration to differentiate in
        (current configuration for updated-Lagrangian assembly,
        ref: stiffnessMtrx.py:132-150; initial configuration for F,
        ref: stiffnessMtrx.py:532-556)
    elements : (E, n) connectivity
    dshape_gp : (G, n, dm) d(shape)/d(natural) at the Gauss points
    weights_gp : (G,) Gauss weights

    Returns
    -------
    dsdx : (E, G, n, dm) shape gradients w.r.t. the given configuration
    vol : (E, G) det(dx/dxi) * weight
    """
    return gradients_and_volume_x(coords[elements], dshape_gp, weights_gp)


def b_matrix(dsdx):
    """Voigt strain-displacement matrix from shape gradients.

    dsdx: (..., n, dm) -> B: (..., n_voigt, n*dm) with the reference's row
    order (2D: [e00, e11, gamma01], ref element strainMtrx e.g.
    element_linear_triangular.py:123-145; 3D: [e00, e11, e22, gamma01,
    gamma20, gamma12], ref element_linear_tetrahedral.py:137-177).
    """
    dm = dsdx.shape[-1]
    lead = dsdx.shape[:-2]

    def interleave(*cols):
        # per-node column vectors -> flat (..., n*dm) dof-ordered row
        return jnp.stack(cols, axis=-1).reshape(*lead, -1)

    Z = jnp.zeros_like(dsdx[..., 0])
    if dm == 2:
        Nx, Ny = dsdx[..., 0], dsdx[..., 1]
        rows = [
            interleave(Nx, Z),
            interleave(Z, Ny),
            interleave(Ny, Nx),
        ]
    else:
        Nx, Ny, Nz = dsdx[..., 0], dsdx[..., 1], dsdx[..., 2]
        rows = [
            interleave(Nx, Z, Z),
            interleave(Z, Ny, Z),
            interleave(Z, Z, Nz),
            interleave(Ny, Nx, Z),
            interleave(Nz, Z, Nx),
            interleave(Z, Nz, Ny),
        ]
    return jnp.stack(rows, axis=-2)


def element_stiffness(dsdx, vol, C, layout: str = "eij"):
    """Ke = sum_gp B^T C B * vol  -> (E, edof, edof).

    layout="ije" emits (edof, edof, E) instead: the structured assembly
    reads Ke one (row-dof, col-dof) cell-grid at a time, and in this layout
    each such read is contiguous (in element-major layout it is a
    stride-edof^2 pick that costs a full HBM cache line per element).

    (ref: stiffnessMtrx.py:161-186 without the scatter)
    """
    B = b_matrix(dsdx)  # (E, G, nv, edof)
    CB = jnp.einsum("ab,egbj->egaj", C, B)
    return jnp.einsum(f"egai,egaj,eg->{layout}", B, CB, vol)


def geometric_stiffness(dsdx, sigma, vol):
    """Initial-stress (geometric) stiffness: Kg[(a,i),(b,j)] = d_ij
    int grad(N_a) . sigma . grad(N_b) dv  -> (E, edof, edof).

    The reference approximates the Newton Jacobian by the secant material
    stiffness only (README.md:93; the true tangent is left commented out at
    neo_hookean.py:62-64), which stalls its Newton loop on the higher-load
    Cook cases.  Adding this term gives a consistent updated-Lagrangian
    tangent (enable with SolverConfig.geometric_stiffness).
    """
    E, G, n, dm = dsdx.shape
    kg = jnp.einsum("egaj,egjk,egbk,eg->eab", dsdx, sigma, dsdx, vol)
    return jnp.einsum("eab,ij->eaibj", kg, jnp.eye(dm, dtype=dsdx.dtype)).reshape(
        E, n * dm, n * dm
    )


def scatter_stiffness(Ke, scatter_targets, n_dof, width):
    """Element stiffnesses -> padded ELL values via one segment-sum.

    Targets are in Ke layout order (unsorted): the direct scatter avoids
    materialising a contribution-sized permutation.
    """
    flat = jax.ops.segment_sum(
        Ke.reshape(-1), scatter_targets, num_segments=n_dof * width
    )
    return flat.reshape(n_dof, width)


def expand_block_targets(block_targets, node_width, dm, width, npe):
    """NODE-block scatter map (E*npe*npe,) -> dof-level (E*edof*edof,) in
    Ke layout order, traced in-program.

    The host exports only the dm^2-smaller block map
    (ELLPattern.block_targets: 68 MB vs 607 MB at 1M C3D4 elements --
    measured ~9 s of page faults + a 600 MB H2D transfer saved); this
    broadcast recovers the dof slots: contribution (e, a, di, b, dj) goes
    to (n*dm+di)*width + pos*dm + dj where block_targets[e,a,b] =
    n*node_width + pos.
    """
    bt = block_targets.reshape(-1, npe * npe).astype(jnp.int32)
    n = bt // node_width
    pos = bt % node_width
    base = (n * dm) * width + pos * dm  # (E, npe*npe)
    # Static flat-index tables instead of a broadcast to (E,npe,dm,npe,dm):
    # the 5-D intermediate's tiny minor dims invite layout padding, and
    # it is 607 MB of s32 at 1M elements even unpadded.  Ke's flat order is
    # k = (a*dm+di)*edof + (b*dm+dj); for each k the base entry is
    # (a, b) and the in-block offset di*width + dj.
    edof = npe * dm
    k = np.arange(edof * edof)
    a = k // (dm * edof)
    di = (k // edof) % dm
    b = (k % edof) // dm
    dj = k % dm
    ab_of_k = jnp.asarray((a * npe + b).astype(np.int32))
    delta_of_k = jnp.asarray((di * width + dj).astype(np.int32))
    return (base[:, ab_of_k] + delta_of_k[None, :]).reshape(-1)


def scatter_stiffness_blocks(Ke, block_targets, n_dof, width, node_width, dm):
    """scatter_stiffness driven by the compact node-block map."""
    E, edof, _ = Ke.shape
    targets = expand_block_targets(
        block_targets, node_width, dm, width, edof // dm
    )
    flat = jax.ops.segment_sum(
        Ke.reshape(-1), targets, num_segments=n_dof * width
    )
    return flat.reshape(n_dof, width)


def deformation_gradient(dof, elements, dsdX0):
    """F = I + du/dX at each (element, GP), w.r.t. the initial configuration.

    dsdX0 : (E, G, n, dm) precomputed initial-configuration shape gradients
    (the reference recomputes them every call, stiffnessMtrx.py:532-556; they
    are constant, so we hoist them to setup).
    """
    dm = dsdX0.shape[-1]
    return deformation_gradient_u(dof.reshape(-1, dm)[elements], dsdX0)


def deformation_gradient_u(u_e, dsdX0):
    """deformation_gradient on pre-gathered element displacements
    u_e : (E, n, dm) (cf. gradients_and_volume_x)."""
    dm = dsdX0.shape[-1]
    dudX = jnp.einsum("enU,egnX->egUX", u_e, dsdX0)
    return dudX + jnp.eye(dm, dtype=u_e.dtype)


def internal_force(dsdx, sigma, vol, force_targets, n_dof):
    """Internal nodal force f_a,i = sum_gp dsdx[a,:] . sigma[:,i] * vol.

    (ref: stiffnessMtrx.py:609-644, restructured from a per-node gather with
    a linear index search into a per-element-dof segment-sum scatter)
    """
    f_elem = jnp.einsum("egaj,egji,eg->eai", dsdx, sigma, vol)
    return jax.ops.segment_sum(
        f_elem.reshape(-1), force_targets, num_segments=n_dof
    )


def _element_internal_force(u_e, x0_e, dN, w, material):
    """Internal force of ONE element, (n, dm) displacement -> (edof,) force.

    Same math as the global path (F from the initial configuration, Cauchy
    stress, gradients/volumes on the current configuration) but expressed per
    element so it can be differentiated.
    """
    dm = x0_e.shape[1]
    dxdn0 = jnp.einsum("nD,gnd->gDd", x0_e, dN)
    dsdX = jnp.einsum("gnd,gdD->gnD", dN, inv_small(dxdn0))
    F = jnp.eye(dm, dtype=u_e.dtype) + jnp.einsum("nU,gnX->gUX", u_e, dsdX)
    sigma = jax.vmap(material.cauchy_large)(F)
    x_e = x0_e + u_e
    dxdn = jnp.einsum("nD,gnd->gDd", x_e, dN)
    dsdx = jnp.einsum("gnd,gdD->gnD", dN, inv_small(dxdn))
    vol = det_small(dxdn) * w
    return jnp.einsum("gaj,gji,g->ai", dsdx, sigma, vol).reshape(-1)


def consistent_tangent(dof, elements, coords0, dN, w, material):
    """Exact per-element Newton tangent Ke = d f_int_e / d u_e by forward-mode
    autodiff, vmapped over elements -> (E, edof, edof).

    This is the JAX-native upgrade over the reference's secant Jacobian
    (README.md:93): material + geometric + configuration terms, exact, with
    no hand-derived tensor algebra.  Cost: edof JVPs of the element force.
    """
    dm = coords0.shape[1]
    u_e = dof.reshape(-1, dm)[elements]  # (E, n, dm)
    x0_e = coords0[elements]
    return consistent_tangent_elems(u_e, x0_e, dN, w, material)


def consistent_tangent_elems(u_e, x0_e, dN, w, material):
    """consistent_tangent on pre-gathered per-element arrays (E, n, dm).

    Split out so gather-free callers (the structured slab shards, which
    slice u_e/x0_e from the grid instead of indexing with an elements
    table) can reuse the same scanned-JVP Jacobian.
    """
    dm = x0_e.shape[2]
    edof = u_e.shape[1] * dm

    def fe(u_flat, x0):
        return _element_internal_force(u_flat.reshape(-1, dm), x0, dN, w, material)

    # One JVP per element dof via lax.scan instead of jax.jacfwd: identical
    # values, but the traced program contains ONE element-force body instead
    # of edof unrolled copies -- at C3D10's edof=30 the jacfwd graph
    # dominated the fused-Newton program's (server-side, minutes-scale)
    # XLA compile; the scanned form stays vmapped over elements, so the
    # device parallelism is unchanged.
    def jac(u_flat, x0):
        def body(_, j):
            seed = (jnp.arange(edof) == j).astype(u_flat.dtype)
            _, col = jax.jvp(lambda u: fe(u, x0), (u_flat,), (seed,))
            return None, col

        _, cols = jax.lax.scan(body, None, jnp.arange(edof))
        return cols.T  # cols[j] = d f / d u_j  ->  J[i, j]

    return jax.vmap(jac)(u_e.reshape(-1, edof), x0_e)


def gp_stress(F, material, large: bool):
    """Cauchy stress at every (element, GP) from the deformation gradient."""
    fn = material.cauchy_large if large else material.cauchy_small
    return jax.vmap(jax.vmap(fn))(F)


def gp_energy_density(F, material):
    return jax.vmap(jax.vmap(material.energy_density))(F)
