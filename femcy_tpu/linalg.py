"""Tiny batched linear algebra (closed-form 2x2 / 3x3).

Closed-form replacements for ``jnp.linalg.inv/det`` on the small matrices
FEM kinematics produces: the LU path is overkill for 2x2/3x3, and the
adjugate forms fuse into the surrounding einsums.
"""

from __future__ import annotations

import jax.numpy as jnp


def det_small(a):
    """Batched closed-form determinant of (..., 2, 2) or (..., 3, 3).

    Avoids the LU decomposition path of ``jnp.linalg.det`` (needless for
    these tiny matrices) so it fuses with its neighbours.
    """
    if a.shape[-1] == 2:
        return a[..., 0, 0] * a[..., 1, 1] - a[..., 0, 1] * a[..., 1, 0]
    return (
        a[..., 0, 0] * (a[..., 1, 1] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 1])
        - a[..., 0, 1] * (a[..., 1, 0] * a[..., 2, 2] - a[..., 1, 2] * a[..., 2, 0])
        + a[..., 0, 2] * (a[..., 1, 0] * a[..., 2, 1] - a[..., 1, 1] * a[..., 2, 0])
    )


def inv_small(a):
    """Batched closed-form (adjugate) inverse of (..., 2, 2) or (..., 3, 3)."""
    det = det_small(a)[..., None, None]
    if a.shape[-1] == 2:
        adj = jnp.stack(
            [
                jnp.stack([a[..., 1, 1], -a[..., 0, 1]], axis=-1),
                jnp.stack([-a[..., 1, 0], a[..., 0, 0]], axis=-1),
            ],
            axis=-2,
        )
        return adj / det

    def cof(i1, i2, j1, j2):
        return a[..., i1, j1] * a[..., i2, j2] - a[..., i1, j2] * a[..., i2, j1]

    # adjugate: transpose of the cofactor matrix
    row0 = jnp.stack([cof(1, 2, 1, 2), -cof(0, 2, 1, 2), cof(0, 1, 1, 2)], axis=-1)
    row1 = jnp.stack([-cof(1, 2, 0, 2), cof(0, 2, 0, 2), -cof(0, 1, 0, 2)], axis=-1)
    row2 = jnp.stack([cof(1, 2, 0, 1), -cof(0, 2, 0, 1), cof(0, 1, 0, 1)], axis=-1)
    return jnp.stack([row0, row1, row2], axis=-2) / det


