"""Structured-assembly DIA accumulate on an NVIDIA GPU: Pallas through
Triton (``backend="triton"``).

On a Kuhn-subdivided box every (orientation, p, q) element-stiffness plane
adds into ONE output row (i, k) of the (3K, nodes) DIA matrix with ONE static
corner shift (structured.build_structured_plan).  The XLA shifted-slice
accumulate (structured._accumulate) materializes a stacked (3K, nodes)
contribution per orientation and re-reads the running matrix six times.
Here a grid of programs over output node-column blocks sums, for each of the
3K output rows, the statically shifted plane windows that feed it, and
writes each output row block exactly once: the planes are read once and the
values written once.

The six (144, length) planes come from structured._prep_planes in a padded
cell space (``x_front`` zero x-planes in front, ``x_back`` behind) in which
cell and node share one flat index, so the plane window of the node block
starting at s for a combo with flat shift d starts at s + front - d.

Measured on an NVIDIA H100 80GB HBM3 (700 W) at 1,053,696 elements, f32:
assembly (isotropic prep + this kernel) 1.86 ms against 4.55 ms for the
same prep into the XLA accumulate and 41.6 ms for XLA's generic path
(bytes bound 0.22 ms); 7.46 ms against 10.2 ms for assemble + multigrid
PCG end to end (PERF.md).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: node columns per program (a power of two, as Triton requires)
BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AccumulatePlan:
    n_rows: int  # 3 * K output rows
    nn: int  # flat node count (nx+1)(ny+1)(nz+1)
    nn_pad: int  # padded to a block multiple
    block: int
    sx: int  # x-plane stride (ny+1)(nz+1) of the node / cell grid
    x_front: int  # zero x-planes in front of the cells
    x_back: int  # zero x-planes behind (cover the last block's windows)
    length: int  # flat padded cell length each plane has
    #: rows[r] = ((orientation, 12p+q, flat corner shift), ...)
    rows: Tuple[Tuple[Tuple[int, int, int], ...], ...]
    interpret: bool = False


def build_accumulate_plan(plan, block: int = BLOCK,
                          interpret: bool = False) -> AccumulatePlan:
    """Kernel plan from a structured.StructuredPlan; raises off-GPU unless
    ``interpret``."""
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the Triton structured accumulate needs a GPU backend (or "
            f"interpret=True for tests); JAX's backend is "
            f"{jax.default_backend()!r}"
        )
    nx, ny, nz, K = plan.nx, plan.ny, plan.nz, plan.n_offsets
    sx, sy = (ny + 1) * (nz + 1), nz + 1
    nn = (nx + 1) * sx
    nn_pad = -(-nn // block) * block
    x_front = 2  # 2*sx >= sx + sy + 1, the largest corner shift
    front = x_front * sx
    x_back = -(-(front + nn_pad - (x_front + nx) * sx) // sx)
    rows = [[] for _ in range(3 * K)]
    for (i, k), entries in plan.groups.items():
        for o, p, q, (dx, dy, dz) in entries:
            rows[i * K + k].append((o, 12 * p + q, dx * sx + dy * sy + dz))
    return AccumulatePlan(
        n_rows=3 * K, nn=nn, nn_pad=nn_pad, block=block, sx=sx,
        x_front=x_front, x_back=x_back,
        length=(x_front + nx + x_back) * sx,
        rows=tuple(tuple(sorted(r)) for r in rows), interpret=interpret,
    )


def accumulate(ap: AccumulatePlan, planes):
    """6 per-orientation (144, length) planes -> DIA values (nn*3, K)."""
    B, front = ap.block, ap.x_front * ap.sx

    def kernel(*refs):
        keq, out_ref = refs[:6], refs[6]
        s = pl.program_id(0) * B
        for r, combos in enumerate(ap.rows):
            acc = jnp.zeros((B,), out_ref.dtype)
            for o, pq, shift in combos:
                acc += keq[o][pq, pl.ds(s + front - shift, B)]
            out_ref[r, pl.ds(s, B)] = acc

    out = pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((ap.n_rows, ap.nn_pad), planes[0].dtype),
        grid=(ap.nn_pad // B,),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=ap.interpret,
        name="structured_accumulate",
    )(*planes)
    K = ap.n_rows // 3
    mat = out[:, : ap.nn]  # (3K, nn)
    return jnp.transpose(mat.reshape(3, K, ap.nn), (2, 0, 1)).reshape(-1, K)
