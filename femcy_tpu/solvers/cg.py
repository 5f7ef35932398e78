"""Jacobi-preconditioned conjugate gradient, fully on device.

The reference CG launches ~7 kernels per iteration and round-trips
alpha/beta/rmax through the host every loop (conjugateGradientSolver.py:103-127).
Here the whole iteration lives inside one ``jax.lax.while_loop`` under jit:
zero host synchronisation until the final result is fetched.  Same algorithm
and the same convergence rule for parity: ||r||_inf < eps * ||r0||_inf with
eps defaulting to 1e-3 (conjugateGradientSolver.py:15), at most n_dof
iterations (:109).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def ell_spmv(values, colidx, x):
    """y = A @ x on the padded ELL format.

    One row-gather + row-reduction; padding slots hold value 0 so their
    (arbitrary, col-0) gather contributes nothing.
    (ref: conjugateGradientSolver.py:53-58)
    """
    return jnp.sum(values * x[colidx], axis=1)


def ell_to_dense(values, colidx, n: int):
    """Padded ELL values -> dense (n, n) operator, one segment-sum.

    Padding slots hold value 0 with column 0, so they add nothing.  Used by
    the small-model dense CG (``dense_pcg_solve``): for models of a few
    thousand dofs the ELL SpMV's row gather can cost more per CG iteration
    than streaming the whole dense operator from device memory.
    """
    # 2D indexed add: a flattened row*n+col target would overflow int32
    # above n=46340, silently corrupting the operator under a user-raised
    # dense_operator_max_dof
    rows = jnp.arange(n, dtype=jnp.int32)[:, None]
    return (
        jnp.zeros((n, n), values.dtype).at[rows, colidx].add(values)
    )


def dense_pcg_solve(
    A,
    b,
    eps: float = 1.0e-3,
    max_iters: int = 0,
    block_dm: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Jacobi-PCG with a DENSE operator: Ad is one (n, n) @ (n,) matvec.

    The small-model path: a gather-free matvec streams the operator at
    memory speed, and unlike the host direct solve it keeps the whole
    Newton iteration resident on the device (no host transfers).  Same
    convergence rule as pcg_solve.  ``block_dm`` > 0 uses the dm x dm
    node-block Jacobi preconditioner (closed-form small inverses).
    """
    n = b.shape[0]
    if max_iters <= 0:
        max_iters = n
    # diagonal by static stride (advanced indexing would lower to a gather)
    diag = A.reshape(-1)[:: n + 1]

    if block_dm > 0:
        from femcy_tpu.linalg import inv_small

        nb = n // block_dm
        A4 = A.reshape(nb, block_dm, nb, block_dm)
        eye_nb = jnp.eye(nb, dtype=A.dtype)
        blocks = jnp.einsum("aibj,ab->aij", A4, eye_nb)
        # guard empty (fully eliminated) blocks like the scalar 1/diag guard
        safe = jnp.where(
            (jnp.einsum("aii->a", blocks) != 0.0)[:, None, None],
            blocks,
            jnp.eye(block_dm, dtype=A.dtype)[None],
        )
        minv_blocks = inv_small(safe)

        def apply_m(r):
            return jnp.einsum(
                "aij,aj->ai", minv_blocks, r.reshape(nb, block_dm)
            ).reshape(-1)

    else:
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
        Ad = A @ d
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


def pcg_solve(
    values,
    colidx,
    diag_slot,
    b,
    eps: float = 1.0e-3,
    max_iters: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Solve A x = b.  Returns (x, iterations, final ||r||_inf).

    ``diag_slot`` indexes each row's diagonal in the flattened values array;
    the Jacobi preconditioner is M^-1 = 1/diag (ref:
    conjugateGradientSolver.py:48-51).
    """
    n = b.shape[0]
    if max_iters <= 0:
        max_iters = n
    diag = values.reshape(-1)[diag_slot]
    minv = jnp.where(diag != 0.0, 1.0 / diag, 0.0)

    r0 = b
    d0 = minv * r0
    x0 = jnp.zeros_like(b)
    rmax0 = jnp.max(jnp.abs(r0))

    def cond(state):
        _, r, _, _, k = state
        rmax = jnp.max(jnp.abs(r))
        return (k < max_iters) & (rmax >= eps * rmax0) & (rmax0 > 0.0)

    def body(state):
        x, r, d, rmr, k = state
        Ad = ell_spmv(values, colidx, d)
        alpha = rmr / jnp.dot(d, Ad)
        x = x + alpha * d
        r = r - alpha * Ad
        rmr_new = jnp.dot(r, minv * r)
        d = minv * r + (rmr_new / rmr) * d
        return x, r, d, rmr_new, k + 1

    rmr0 = jnp.dot(r0, minv * r0)
    x, r, _, _, k = jax.lax.while_loop(
        cond, body, (x0, r0, d0, rmr0, jnp.int32(0))
    )
    return x, k, jnp.max(jnp.abs(r))
